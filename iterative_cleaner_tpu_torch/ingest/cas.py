"""Content addressing for cleaned results.

A copy of ``iterative_cleaner_tpu/ingest/cas.py``: :func:`cache_salt`,
:func:`cube_key`, :func:`file_digest` and :func:`cache_report`.  The salt
hashes the package version with every mask-affecting ``CleanConfig`` field
(thresholds, iteration cap, pulse region, bad-parts policy, the output
policy) and ``ICT_CACHE_SALT``; route-selection fields are not salted,
since masks are bit-identical across routes.  The CLI's ``job_submitted``
event carries the salt; the serving daemon's result cache
(``service/results_cache.py``) keys on :func:`cube_key`.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from iterative_cleaner_tpu_torch.obs import tracing

#: CleanConfig fields that can change the served mask (or the served
#: output archive's contents) -- the salt covers exactly these.  The
#: output-policy fields ride along because the cached record is reused
#: to WRITE an output archive: two configs that mask identically but
#: pscrunch differently must not share cache entries.
_SALT_FIELDS = (
    "chanthresh", "subintthresh", "max_iter", "pulse_region",
    "bad_chan", "bad_subint", "pscrunch", "output",
)


def cache_salt(cfg) -> str:
    """Hex salt naming (version, mask-relevant config, operator salt) --
    equal salts mean "a cached mask from there answers here"."""
    from iterative_cleaner_tpu_torch import __version__

    h = hashlib.sha256()
    h.update(__version__.encode())
    for name in _SALT_FIELDS:
        h.update(f"|{name}={getattr(cfg, name)!r}".encode())
    extra = os.environ.get("ICT_CACHE_SALT", "")
    if extra:
        h.update(b"|salt=" + extra.encode())
    return h.hexdigest()[:16]


def _frame(h, arr: np.ndarray) -> None:
    """Hash one array self-describingly: dtype + shape + C-order bytes,
    so (D, w0) pairs of different splits can never collide by
    concatenation."""
    arr = np.ascontiguousarray(arr)
    h.update(f"|{arr.dtype.str}{arr.shape}|".encode())
    h.update(arr.tobytes())


def cube_key(D: np.ndarray, w0: np.ndarray, cfg) -> str:
    """The content address of one cleaning problem: preprocessed cube
    bytes + weights + :func:`cache_salt`."""
    h = hashlib.sha256()
    h.update(cache_salt(cfg).encode())
    _frame(h, D)
    _frame(h, w0)
    return h.hexdigest()


def file_digest(path: str) -> str:
    """Plain SHA-256 of the file's raw bytes (streamed; '' on any read
    error -- content addressing is an optimization, never a failure
    mode)."""
    h = hashlib.sha256()
    try:
        with open(path, "rb") as fh:
            for chunk in iter(lambda: fh.read(1 << 20), b""):
                h.update(chunk)
    except OSError:
        return ""
    return h.hexdigest()


def cache_report() -> dict:
    """Cumulative result-cache counters out of the process-global
    registry."""
    snap = tracing.counters_snapshot()
    return {
        "hits": int(snap.get("service_result_cache_hits", 0)),
        "misses": int(snap.get("service_result_cache_misses", 0)),
        "bytes_saved": int(snap.get("service_result_cache_bytes_saved", 0)),
    }
