"""Convergence forensics: *why* a clean converged and *which* diagnostic
zapped what.

A port of ``iterative_cleaner_tpu/obs/forensics.py``.  The core loop
always records the cheap facts — per-iteration mask churn
(``IterationInfo.diff_weights``), newly-zapped / restored profile counts,
and the termination reason (fixed point / cycle / max_iter) on
:class:`..core.cleaner.CleanResult`.  This module adds the expensive one:
per-diagnostic zap attribution, a host-side replay of the numpy oracle's
score pipeline for one iteration that counts, per diagnostic (std / mean /
ptp / fft), how many of the profiles zapped that iteration the diagnostic
itself voted for (its own scaled value >= 1; the combined score is the
median of the four, so a zap carries at least two votes).

The replay runs on the host, whichever device the clean ran on: the
backends of the port hold their cube as a device tensor (``TorchCleaner``),
a host array (``ChunkedTorchCleaner``, the oracle), or not at all (the
fused loop, whose caller passes its host arrays), and
:func:`attribute_from_backend` brings a tensor to the host with
``.cpu().numpy()``.

Strictly read-only on the math, and deliberately expensive (a full numpy
stats pass per iteration — seconds at 256 x 1024 x 1024), so it is gated
behind ``ICT_FORENSICS=1`` rather than riding along with every telemetry
sink.
"""

from __future__ import annotations

import os

import numpy as np

#: Diagnostic order matches the oracle's ``comprehensive_stats`` list.
DIAGNOSTIC_NAMES = ("std", "mean", "ptp", "fft")


def attribution_enabled() -> bool:
    return os.environ.get("ICT_FORENSICS") == "1"


def timeline_enabled() -> bool:
    """Whether the serving daemon should pay for per-job iteration
    timelines on the batched route (a mask-history fetch per bucket): on
    with an active telemetry sink or ICT_FORENSICS=1.  The oracle route
    records its timeline unconditionally."""
    from iterative_cleaner_tpu_torch.obs import events

    return events.enabled() or attribution_enabled()


def _host(a) -> np.ndarray:
    """A numpy view of ``a``: a torch tensor (on any device) is copied to
    the host; anything else goes through ``np.asarray``."""
    if hasattr(a, "detach") and hasattr(a, "cpu"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def attribute_zaps(D: np.ndarray, w0: np.ndarray, w_prev: np.ndarray,
                   new_w: np.ndarray, cfg) -> dict[str, int]:
    """Per-diagnostic vote counts among the profiles zapped this iteration.

    ``w_prev`` is the template weighting the iteration ran with; ``new_w``
    its output mask.  Reuses the port's copy of the oracle's building
    blocks (backends/numpy_backend), so the attribution can never drift
    from the spec it explains."""
    from iterative_cleaner_tpu_torch.backends.numpy_backend import (
        build_template,
        fit_template,
        scaled_diagnostics,
    )

    D = np.asarray(D, np.float32)
    w0 = np.asarray(w0, np.float32)
    template = build_template(D, np.asarray(w_prev, np.float32))
    _amp, resid = fit_template(D, template, cfg.pulse_region)
    weighted = resid * w0[..., None]
    mask3d = np.repeat(np.expand_dims(~w0.astype(bool), 2),
                       D.shape[-1], axis=2)
    data_ma = np.ma.masked_array(weighted, mask=mask3d)
    zapped = (np.asarray(new_w) == 0) & (w0 != 0)
    out: dict[str, int] = {}
    for name, score in zip(DIAGNOSTIC_NAMES,
                           scaled_diagnostics(data_ma, cfg)):
        with np.errstate(invalid="ignore"):
            out[name] = int(np.sum(zapped & (np.asarray(score) >= 1)))
    return out


def attribute_from_backend(backend, w_prev, new_w) -> dict[str, int] | None:
    """Attribution via the host inputs the backend holds (the oracle's
    ``D``/``w0``; the torch backends' ``_D``/``_w0``, tensors on the card
    or host arrays); None when a backend keeps no cube — attribution is
    best-effort."""
    D = getattr(backend, "D", None)
    if D is None:
        D = getattr(backend, "_D", None)
    w0 = getattr(backend, "w0", None)
    if w0 is None:
        w0 = getattr(backend, "_w0", None)
    cfg = getattr(backend, "cfg", None)
    if D is None or w0 is None or cfg is None:
        return None
    try:
        return attribute_zaps(_host(D), _host(w0), _host(w_prev), _host(new_w), cfg)
    except Exception:  # noqa: BLE001 — forensics must never fail the clean
        return None


def termination_reason(converged: bool, history) -> str:
    """Post-hoc termination classification from a mask history: the loop
    stopped because the final mask reproduced the immediately previous one
    (``fixed_point``), an older one (``cycle``), or never reproduced any
    (``max_iter``)."""
    if not converged:
        return "max_iter"
    if len(history) >= 2 and np.array_equal(history[-1], history[-2]):
        return "fixed_point"
    return "cycle"


def iteration_record(info) -> dict:
    """One IterationInfo as the JSON-ready timeline entry the event log
    carries."""
    rec = {
        "index": info.index,
        "diff_weights": info.diff_weights,
        "n_new_zaps": info.n_new_zaps,
        "n_unzapped": info.n_unzapped,
        "rfi_frac": info.rfi_frac,
        "duration_s": round(info.duration_s, 6),
    }
    if info.zaps_by_diagnostic is not None:
        rec["zaps_by_diagnostic"] = dict(info.zaps_by_diagnostic)
    return rec
