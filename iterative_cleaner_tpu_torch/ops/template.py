"""Template build + closed-form amplitude fit.

Port of ``iterative_cleaner_tpu/ops/template.py:44-79``.  The reference fits
every profile with ``scipy.optimize.leastsq``; the model is linear in its one
parameter, so the least-squares solution is the closed form
``amp = <t, p> / <t, t>``.

Both products run in full f32: the fit feeds a >=-threshold decision.  On the
card that rests on TF32 being off for matmuls, which the torch backend checks
before it runs (``backends/torch_backend.check_fp32_matmul``).
"""

from __future__ import annotations

import functools

import torch

from iterative_cleaner_tpu_torch.config import (
    pulse_region_active,
    pulse_region_bin_scale,
)


def build_template(D: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted scrunch over (subint, channel): PSRCHIVE's fscrunch+tscrunch
    collapse up to overall scale, which cancels out of amp·t.  One
    matrix-vector product, (nsub*nchan,) @ (nsub*nchan, nbin)."""
    nbin = D.shape[-1]
    return torch.matmul(weights.reshape(-1).to(D.dtype), D.reshape(-1, nbin))


@functools.lru_cache(maxsize=32)
def _bin_scale_cached(nbin: int, pulse_region: tuple, device: torch.device,
                      dtype: torch.dtype) -> torch.Tensor:
    if not pulse_region_active(pulse_region):
        # The disabled sentinel (0, 0, 1) would scale bin 0 by 0 if sliced.
        return torch.ones(nbin, device=device, dtype=dtype)
    return torch.from_numpy(pulse_region_bin_scale(nbin, pulse_region)).to(
        device=device, dtype=dtype)


def bin_scale_for(nbin: int, pulse_region, device, dtype=torch.float32) -> torch.Tensor:
    """The per-bin pulse-region scale as a tensor (ones when inactive),
    made once per (nbin, region, device, dtype); callers must not write to
    it."""
    return _bin_scale_cached(int(nbin), tuple(float(v) for v in pulse_region),
                             torch.device(device), dtype)


def fit_amplitudes(D: torch.Tensor, template: torch.Tensor) -> torch.Tensor:
    """``amp = <t,p>/<t,t>`` per profile; 1 where ``<t,t>`` is 0 or not
    finite (leastsq on a flat objective returns its initial guess)."""
    tt = torch.dot(template, template)
    tp = torch.matmul(D, template)
    ok = (tt != 0) & torch.isfinite(tt)
    one = torch.ones((), dtype=tt.dtype, device=tt.device)
    return torch.where(ok, tp / torch.where(ok, tt, one), one)


def fit_and_subtract(
    D: torch.Tensor, template: torch.Tensor, pulse_region
) -> tuple[torch.Tensor, torch.Tensor]:
    """All-profile amplitude fit + residual (model − data, the reference's
    sign), with the pulse-region bins scaled by ``pulse_region``'s
    (scale, start, end)."""
    amp = fit_amplitudes(D, template)
    resid = amp[..., None] * template - D
    if pulse_region_active(pulse_region):
        resid = resid * bin_scale_for(D.shape[-1], pulse_region, D.device, resid.dtype)
    return amp, resid
