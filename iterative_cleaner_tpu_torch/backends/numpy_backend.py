"""The numpy oracle backend — the executable specification.

A copy of ``iterative_cleaner_tpu/backends/numpy_backend.py:28-149`` (pure
numpy + numpy.ma), kept in the port so that its masks can be judged where
JAX is not installed.  It reproduces the reference's semantics on the
preprocessed cube, every numpy.ma landmine included:

- the template amplitude fit is the closed form ``amp = <t,p>/<t,t>``; a
  degenerate template (<t,t> == 0 or not finite) yields amp = 1, matching
  leastsq returning its initial guess;
- the robust scalers keep the reference's per-row/per-column ``numpy.ma``
  evaluation order, so masked division and mask-drop come from numpy.ma;
- the FFT diagnostic reads raw ``._data`` (mask-blind).
"""

from __future__ import annotations

import numpy as np

from iterative_cleaner_tpu_torch.config import CleanConfig, pulse_region_active


def fit_template(
    D: np.ndarray, template: np.ndarray, pulse_region: tuple[float, float, float]
) -> tuple[np.ndarray, np.ndarray]:
    """Closed-form per-profile template fit + subtraction (model − data)."""
    t = np.asarray(template, dtype=np.float32)
    tt = np.einsum("b,b->", t, t, dtype=np.float32)
    if tt == np.float32(0.0) or not np.isfinite(tt):
        amp = np.ones(D.shape[:2], dtype=np.float32)
    else:
        amp = np.einsum("scb,b->sc", D, t, dtype=np.float32) / tt
    resid = amp[..., None] * t - D
    if pulse_region_active(pulse_region):
        scale, start, end = pulse_region
        resid[..., int(start) : int(end)] *= np.float32(scale)
    return amp, resid


def build_template(D: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """Weighted scrunch over (subint, channel) → template profile."""
    return np.einsum("sc,scb->b", weights.astype(np.float32), D, dtype=np.float32)


def robust_scale(arr2d, axis: int):
    """(x − median) / MAD along ``axis``, per line with numpy.ma, so the
    MAD==0 and all-masked semantics are numpy.ma's own (MAD without the
    1.4826 consistency factor)."""
    out = np.empty_like(arr2d)
    for i in range(arr2d.shape[1 - axis]):
        sl = (slice(None), i) if axis == 0 else (i, slice(None))
        with np.errstate(invalid="ignore", divide="ignore"):
            vec = arr2d[sl]
            dev = vec - np.ma.median(vec)
            out[sl] = dev / np.ma.median(np.abs(dev))
    return out


def scaled_diagnostics(data_ma: np.ma.MaskedArray, cfg: CleanConfig) -> list:
    """The four per-diagnostic combined scores in (std, mean, ptp, fft)
    order: the threshold-scaled, mask-dropping max of the per-channel and
    per-subint robust scalings."""
    centred = data_ma - np.expand_dims(data_ma.mean(axis=2), axis=2)
    diagnostics = [
        np.ma.std(data_ma, axis=2),
        np.ma.mean(data_ma, axis=2),
        np.ma.ptp(data_ma, axis=2),
        np.max(np.abs(np.fft.rfft(centred, axis=2)), axis=2),
    ]
    scaled = []
    for diag in diagnostics:
        per_chan = np.abs(robust_scale(diag, axis=0)) / cfg.chanthresh
        per_subint = np.abs(robust_scale(diag, axis=1)) / cfg.subintthresh
        scaled.append(np.max((per_chan, per_subint), axis=0))
    return scaled


def comprehensive_stats(data_ma: np.ma.MaskedArray, cfg: CleanConfig) -> np.ndarray:
    """Four robust diagnostics → per-profile outlier score (plain array;
    fully-masked profiles come out NaN and are never flagged)."""
    return np.median(scaled_diagnostics(data_ma, cfg), axis=0)


class NumpyCleaner:
    """Oracle backend over the preprocessed cube (D, w0)."""

    def __init__(self, D: np.ndarray, w0: np.ndarray, cfg: CleanConfig) -> None:
        self.D = np.ascontiguousarray(D, dtype=np.float32)
        self.w0 = np.asarray(w0, dtype=np.float32)
        self.cfg = cfg
        nbin = D.shape[-1]
        self._mask3d = np.repeat(
            np.expand_dims(~self.w0.astype(bool), 2), nbin, axis=2
        )
        self._residual: np.ndarray | None = None

    def step(self, w_prev: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        template = build_template(self.D, np.asarray(w_prev, np.float32))
        _amp, resid = fit_template(self.D, template, self.cfg.pulse_region)
        self._residual = resid
        # Stats always see the ORIGINAL weighting: raw weights scale the
        # data and define the mask.
        weighted = resid * self.w0[..., None]
        data_ma = np.ma.masked_array(weighted, mask=self._mask3d)
        test_results = comprehensive_stats(data_ma, self.cfg)
        new_w = self.w0.copy()
        new_w[test_results >= 1] = 0.0  # NaN >= 1 is False: never flags
        return test_results, new_w

    def residual(self) -> np.ndarray | None:
        return self._residual
