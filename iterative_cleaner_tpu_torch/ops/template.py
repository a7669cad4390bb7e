"""Template build + closed-form amplitude fit.

Port of ``iterative_cleaner_tpu/ops/template.py:44-79``.  The reference fits
every profile with ``scipy.optimize.leastsq``; the model is linear in its one
parameter, so the least-squares solution is the closed form
``amp = <t, p> / <t, t>``.

The template is summed in the numpy oracle's order (:func:`build_template`:
one float32 accumulator per bin, advanced profile by profile, as
``np.einsum`` does), which gives the oracle's template bit for bit.  On the
card that is the hand-written kernel ``csrc/ordered_template.cu``; on the
CPU its plain version :func:`build_template_plain`.  A matrix-vector
product sums in another order, and at 256 x 1024 x 1024 that moved the last
scores 5.1e-5 from the oracle's, beyond the 5e-5 envelope
(``obs/audit.AUDIT_DRIFT_BOUND``).

The fit's products run in full f32: the fit feeds a >=-threshold decision.
On the card that rests on TF32 being off for matmuls, which the torch
backend checks before it runs (``backends/torch_backend.check_fp32_matmul``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from iterative_cleaner_tpu_torch.config import (
    pulse_region_active,
    pulse_region_bin_scale,
)
from iterative_cleaner_tpu_torch.ops.cuda_build import load_library

#: Threads per block of the CUDA kernel; must match kThreads in the source.
ORDERED_TEMPLATE_THREADS = 32

#: Profiles the plain version multiplies at once before its ordered adds.
PLAIN_ROWS = 4096


def build_template_plain(D: torch.Tensor, weights: torch.Tensor,
                         init: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``init`` (or zeros) plus
    ``weights[i] * D[i]`` for every profile ``i`` in (subint, channel)
    row-major order, each product and each sum rounded to float32 on its
    own — numpy's ``einsum("sc,scb->b", w, D, dtype=float32)`` for
    ``nbin >= 2``."""
    nbin = D.shape[-1]
    rows = D.reshape(-1, nbin)
    w = weights.reshape(-1).to(D.dtype)
    acc = (torch.zeros(nbin, dtype=D.dtype, device=D.device) if init is None
           else init.reshape(nbin).clone())
    for lo in range(0, rows.shape[0], PLAIN_ROWS):
        for row in rows[lo:lo + PLAIN_ROWS] * w[lo:lo + PLAIN_ROWS, None]:
            acc = acc + row
    return acc


def _library():
    lib = load_library("ordered_template")
    if not getattr(lib, "_ict_bound", False):
        p = ctypes.c_void_p
        lib.ordered_template_launch.argtypes = [p] * 4 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, p]
        lib.ordered_template_launch.restype = ctypes.c_int
        lib.ordered_template_error_string.argtypes = [ctypes.c_int]
        lib.ordered_template_error_string.restype = ctypes.c_char_p
        lib.ordered_template_threads.restype = ctypes.c_int
        if lib.ordered_template_threads() != ORDERED_TEMPLATE_THREADS:
            raise RuntimeError("csrc/ordered_template.cu and ORDERED_TEMPLATE_THREADS disagree")
        lib._ict_bound = True
    return lib


def build_template(D: torch.Tensor, weights: torch.Tensor,
                   init: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted scrunch over (subint, channel): PSRCHIVE's fscrunch+tscrunch
    collapse up to overall scale, which cancels out of amp·t.  The template
    of ``D (..., nbin)`` under ``weights`` (one per profile) summed in the
    oracle's order, continuing ``init`` when given (the chunked route's
    blocks).  A batch — ``D (a, nsub, nchan, nbin)``, ``weights (a, nsub,
    nchan)``, ``init (a, nbin)`` — gives ``(a, nbin)`` in one launch, each
    archive as alone.  A CPU tensor runs :func:`build_template_plain`; a
    CUDA tensor launches the kernel ``csrc/ordered_template.cu`` or raises —
    there is no fallback."""
    batched = D.dim() == weights.dim() + 1 and D.dim() == 4
    if D.device.type == "cpu":
        if batched:
            return torch.stack([build_template_plain(
                Dj, wj, None if init is None else init[j])
                for j, (Dj, wj) in enumerate(zip(D, weights))])
        return build_template_plain(D, weights, init)
    if D.device.type != "cuda":
        raise ValueError(f"build_template runs on cuda or cpu, not {D.device}")
    narch = D.shape[0] if batched else 1
    nbin = D.shape[-1]
    nprof = D.numel() // max(1, narch * nbin)
    w = weights.to(D.dtype).contiguous()
    if D.dtype != torch.float32:
        raise TypeError(f"D must be float32, got {D.dtype}")
    if not D.is_contiguous():
        raise ValueError("D must be contiguous")
    if w.numel() != narch * nprof or w.device != D.device:
        raise ValueError(f"weights must hold one value per profile on {D.device}, "
                         f"got shape {tuple(weights.shape)} on {weights.device}")
    if init is not None and (init.dtype != torch.float32 or not init.is_contiguous()
                             or init.numel() != narch * nbin or init.device != D.device):
        raise ValueError("init must be a contiguous float32 template per archive on "
                         f"{D.device}")
    out = torch.empty((narch, nbin) if batched else (nbin,), dtype=D.dtype, device=D.device)
    if nbin == 0 or narch == 0:
        return out
    lib = _library()
    with torch.cuda.device(D.device):
        stream = torch.cuda.current_stream(D.device).cuda_stream
        with torch.profiler.record_function("ordered_template"):
            err = lib.ordered_template_launch(
                D.data_ptr(), w.data_ptr(), None if init is None else init.data_ptr(),
                out.data_ptr(), nprof, nbin, narch, stream)
    if err != 0:
        raise RuntimeError(
            f"ordered_template launch failed: "
            f"{lib.ordered_template_error_string(err).decode()} (cudaError {err})")
    build_template.launches += 1
    return out


#: Kernel launches since the last reset (plain-version calls never count).
build_template.launches = 0


def build_templates(Db: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """One template per archive of a batch ``Db (a, nsub, nchan, nbin)``:
    ``(a, nbin)``, each bit-identical to that archive's single-archive
    template — one launch over a contiguous batch, one per archive over
    another (the sweep's stride-0 pair axis)."""
    if Db.is_contiguous():
        return build_template(Db, wb)
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
