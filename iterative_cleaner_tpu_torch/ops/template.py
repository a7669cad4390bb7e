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


def build_templates(Db: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """One template per archive of a batch ``Db (a, nsub, nchan, nbin)``:
    ``(a, nbin)``, each from its own :func:`build_template` matrix-vector
    product, so each row is bit-identical to that archive's single-archive
    template (one batched product may sum in another order)."""
    out = torch.empty((Db.shape[0], Db.shape[-1]), dtype=Db.dtype, device=Db.device)
    for j in range(Db.shape[0]):
        out[j] = build_template(Db[j], wb[j])
    return out


def template_norms(template: torch.Tensor) -> torch.Tensor:
    """``<t,t>``: a scalar for one template, ``(a,)`` for one per archive,
    each from its own dot product (bit-identical to the single archive's)."""
    if template.dim() == 1:
        return torch.dot(template, template)
    return torch.stack([torch.dot(t, t) for t in template])


def broadcast_template(template: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """``template`` shaped to broadcast against ``D``: ``(nbin,)`` as it is,
    ``(a, nbin)`` against a batch ``(a, nsub, nchan, nbin)`` as
    ``(a, 1, 1, nbin)``."""
    if template.dim() == 1:
        return template
    return template.reshape(template.shape[0], *([1] * (D.dim() - 2)), template.shape[-1])


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
    finite (leastsq on a flat objective returns its initial guess).  A batch
    ``D (a, nsub, nchan, nbin)`` with ``template (a, nbin)`` takes each
    archive's ``<t,t>`` and ``<t,p>`` from its own products, as alone."""
    tt = template_norms(template)
    if template.dim() == 1:
        tp = torch.matmul(D, template)
    else:
        tp = torch.stack([torch.matmul(Dj, tj) for Dj, tj in zip(D, template)])
        tt = tt.reshape(tt.shape[0], *([1] * (tp.dim() - 1)))
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
    resid = amp[..., None] * broadcast_template(template, D) - D
    if pulse_region_active(pulse_region):
        resid = resid * bin_scale_for(D.shape[-1], pulse_region, D.device, resid.dtype)
    return amp, resid
