"""Iteration-invariant preprocessing: pscrunch → dedisperse → baseline removal.

A copy of ``iterative_cleaner_tpu/ops/preprocess.py:43-148``:
weight-independent work that runs once on the host, producing the static
cube ``D:(nsub, nchan, nbin) float32`` the iteration loop reads.  As in the
JAX package, :func:`preprocess` prefers the native C++/OpenMP route
(:mod:`..native`, bit-identical) when its library builds, and takes the
numpy path otherwise; the route taken is counted in :mod:`..obs.tracing`
(``preprocess_native`` / ``preprocess_numpy``).

Semantics (documented divergences from PSRCHIVE, shared by both packages):

- ``pscrunch``: Intensity → identity; Stokes → pol 0; Coherence → pol0+pol1.
- ``dedisperse``: per-channel integer-bin circular rotation with the
  dispersion constant 1/2.41e-4 MHz^2 s (all four diagnostics are
  circular-shift invariant, so integer rotation is mask-equivalent).
- ``remove_baseline``: the width-``0.15*nbin`` circular window minimising the
  weighted total profile's running mean; each profile loses its own mean over
  that window, accumulated in f64.
"""

from __future__ import annotations

import numpy as np

from iterative_cleaner_tpu_torch.io.base import (
    Archive,
    STATE_COHERENCE,
    STATE_INTENSITY,
    STATE_STOKES,
)
from iterative_cleaner_tpu_torch.obs import tracing

# PSRCHIVE's inverse dispersion constant: delay[s] = DM / 2.41e-4 * f^-2[MHz].
DM_CONST = 1.0 / 2.41e-4
BASELINE_FRAC = 0.15


def pscrunch(data: np.ndarray, state: str) -> np.ndarray:
    """(nsub, npol, nchan, nbin) → total intensity (nsub, nchan, nbin)."""
    if data.shape[1] == 1 or state == STATE_INTENSITY:
        return data[:, 0]
    if state == STATE_STOKES:
        return data[:, 0]
    if state == STATE_COHERENCE:
        return data[:, 0] + data[:, 1]
    raise ValueError(f"unknown polarization state {state!r}")


def dispersion_shifts(
    freqs: np.ndarray, dm: float, period: float, nbin: int, ref_freq: float
) -> np.ndarray:
    """Integer bin shift per channel that dedisperses the cube."""
    if dm == 0.0 or period <= 0:
        return np.zeros(len(freqs), dtype=np.int64)
    delay = DM_CONST * dm * (
        np.asarray(freqs, np.float64) ** -2 - float(ref_freq) ** -2)  # ict: f64-ok(oracle-parity f64 accumulation on the host)
    return np.round(delay / period * nbin).astype(np.int64) % nbin


def roll_cube(cube: np.ndarray, shifts: np.ndarray, inverse: bool = False) -> np.ndarray:
    """Circularly rotate each channel of (..., nchan, nbin) by its shift."""
    nbin = cube.shape[-1]
    sh = (-shifts if inverse else shifts) % nbin
    idx = (np.arange(nbin)[None, :] + sh[:, None]) % nbin  # (nchan, nbin)
    return np.take_along_axis(cube, idx[(None,) * (cube.ndim - 2)], axis=-1)


def baseline_window(total_profile: np.ndarray, frac: float = BASELINE_FRAC) -> tuple[int, int]:
    """(start, width) of the circular window minimising the running mean."""
    nbin = total_profile.shape[-1]
    width = max(1, int(round(frac * nbin)))
    ext = np.concatenate([total_profile, total_profile[:width]])
    csum = np.concatenate([[0.0], np.cumsum(ext)])
    means = (csum[width : width + nbin] - csum[:nbin]) / width
    return int(np.argmin(means)), width


def remove_baseline(cube: np.ndarray, weights: np.ndarray, frac: float = BASELINE_FRAC) -> np.ndarray:
    """Subtract each profile's off-pulse mean (window from the total profile).

    ``cube`` is (nsub, nchan, nbin) dedispersed; ``weights`` (nsub, nchan).
    The subtraction runs in f64 per subint, keeping the f64 temporaries at
    nchan*nbin.
    """
    nbin = cube.shape[-1]
    total = np.einsum(
        "sc,scb->b", weights.astype(np.float64), cube.astype(np.float64))  # ict: f64-ok(oracle-parity f64 accumulation on the host)
    start, width = baseline_window(total, frac)
    idx = (start + np.arange(width)) % nbin
    base = cube[..., idx].mean(axis=-1, keepdims=True, dtype=np.float64)  # ict: f64-ok(oracle-parity f64 accumulation on the host)
    out = np.empty_like(cube, dtype=np.float32)
    for s in range(cube.shape[0]):
        out[s] = (cube[s].astype(np.float64) - base[s]).astype(np.float32)  # ict: f64-ok(oracle-parity f64 accumulation on the host)
    return out


def preprocess(archive: Archive, prefer_native: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """Archive → (D, w0): the pscrunched, dedispersed, baseline-removed
    float32 cube (nsub, nchan, nbin) and the frozen original weights.

    Uses the C++/OpenMP host runtime when it builds (bit-identical output,
    ``tests/test_torch_native.py``); falls back to the numpy path.  Either
    route runs in the ``clean_preprocess`` phase."""
    with tracing.phase("clean_preprocess"):
        if prefer_native:
            from iterative_cleaner_tpu_torch import native

            out = native.preprocess_native(archive)
            if out is not None:
                tracing.count("preprocess_native")
                return out
        tracing.count("preprocess_numpy")
        cube = pscrunch(archive.data, archive.state).astype(np.float32)
        if not archive.dedispersed:
            shifts = dispersion_shifts(
                archive.freqs, archive.dm, archive.period, archive.nbin, archive.centre_frequency
            )
            cube = roll_cube(cube, shifts)
        w0 = archive.weights.astype(np.float32)
        cube = remove_baseline(cube, w0)
        return np.ascontiguousarray(cube, dtype=np.float32), w0


def redisperse_cube(archive: Archive, cube: np.ndarray) -> np.ndarray:
    """Inverse of the dedispersion roll, for the residual archive, which the
    reference stores in the original dispersed frame."""
    if archive.dedispersed:
        return cube
    shifts = dispersion_shifts(
        archive.freqs, archive.dm, archive.period, archive.nbin, archive.centre_frequency
    )
    return roll_cube(cube, shifts, inverse=True)
