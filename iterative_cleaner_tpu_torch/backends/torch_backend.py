"""The PyTorch backend: the stepwise cleaning iteration on a device.

Port of ``iterative_cleaner_tpu/backends/jax_backend.py``:
``step_from_template`` / ``clean_step`` (:34-102), the incremental template
(:105-152) and the stepwise ``JaxCleaner`` (:373-440) as ``TorchCleaner``.
The cube goes to the device once; each ``step()`` runs template → fit /
subtract / moments (the CUDA kernel, or the plain route) → FFT diagnostic →
robust scalers → zap map on the device and returns host arrays, one sync per
step.  PyTorch runs eagerly, so there is no ``jit``; the ``lax.cond`` of the
incremental template becomes a Python ``if``.

Entry points run on the card unless the caller asks for the CPU: with no
CUDA device and no explicit ``device="cpu"``, :func:`resolve_device` raises.
"""

from __future__ import annotations

import numpy as np
import torch

from iterative_cleaner_tpu_torch.config import CleanConfig
from iterative_cleaner_tpu_torch.ops.fused_kernels import (
    fused_fit_moments,
    kernel_route_status,
    resolve_use_kernel,
)
from iterative_cleaner_tpu_torch.ops.stats import (
    comprehensive_stats,
    fft_diagnostic,
    scale_and_combine,
)
from iterative_cleaner_tpu_torch.ops.template import build_template, fit_and_subtract

# Per-iteration budget of profile flips the incremental template update
# handles sparsely; beyond it the template is rebuilt densely.
INCREMENTAL_TEMPLATE_BUDGET = 512


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a torch.device; a CUDA request with no CUDA device
    raises instead of running somewhere else."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card unless "
            "asked otherwise — pass device='cpu' (CLI: --device cpu) to run "
            "on the CPU")
    return dev


def check_fp32_matmul() -> None:
    """The template products must run in full f32 on the card, as the JAX
    package pins ``Precision.HIGHEST``.  Raise if the process-wide settings
    would put them in TF32; never flip them here (that would retype every
    other matmul in the process)."""
    problems = []
    if torch.backends.cuda.matmul.allow_tf32:
        problems.append("torch.backends.cuda.matmul.allow_tf32 is True")
    prec = torch.get_float32_matmul_precision()
    if prec != "highest":
        problems.append(f"torch.get_float32_matmul_precision() is {prec!r}")
    if getattr(torch.backends.cuda.matmul, "fp32_precision", None) == "tf32":
        problems.append("torch.backends.cuda.matmul.fp32_precision is 'tf32'")
    if problems:
        raise RuntimeError(
            "the cleaner's template products need full float32 matmuls, but "
            + "; ".join(problems)
            + ".  Restore the default (torch.set_float32_matmul_precision("
            "'highest'), allow_tf32 = False) before cleaning")


def step_from_template(D, w0, valid, template, chanthresh, subintthresh, *,
                       pulse_region, use_kernel=False):
    """Fit/subtract/stats/zap given a built template.  Returns
    (test, new_w, resid); resid is None on the kernel route, which never
    materialises it."""
    if use_kernel:
        # valid passed in: the kernel emits filled, scaler-ready maps.
        centred, d_mean, d_std, d_ptp = fused_fit_moments(
            D, template, w0, valid, pulse_region=pulse_region)
        test = scale_and_combine(
            d_std, d_mean, d_ptp, fft_diagnostic(centred), valid,
            chanthresh, subintthresh)
        resid = None
    else:
        _amp, resid = fit_and_subtract(D, template, pulse_region)
        weighted = resid * w0[..., None]
        test = comprehensive_stats(weighted, valid, chanthresh, subintthresh)
    # Zap where test >= 1 on an original-weights clone; NaN >= 1 is False,
    # so NaN never flags.
    new_w = torch.where(test >= 1.0, torch.zeros((), dtype=w0.dtype, device=w0.device), w0)
    return test, new_w, resid


def clean_step(D, w0, valid, w_prev, chanthresh, subintthresh, *,
               pulse_region, use_kernel=False):
    """One iteration with a dense template from ``w_prev``; the stats always
    run against the frozen original weights ``w0``."""
    template = build_template(D, w_prev)
    return step_from_template(
        D, w0, valid, template, chanthresh, subintthresh,
        pulse_region=pulse_region, use_kernel=use_kernel)


def incremental_template(D, T_prev, w_prev, new_w):
    """Next iteration's template without re-reading the cube:
    ``T_prev + sum_changed (new_w - w_prev) * profile`` over at most
    INCREMENTAL_TEMPLATE_BUDGET flipped profiles, gathered with
    ``torch.nonzero`` padded to the budget (padded slots repeat profile 0
    with a zero weight, as the JAX package's static-size gather does).
    Rebuilt densely when more profiles flipped than the budget, or when the
    sparse candidate is not finite (an inf/NaN profile entering or leaving
    the support makes inf-inf = NaN where the dense build is finite)."""
    nbin = D.shape[-1]
    budget = min(INCREMENTAL_TEMPLATE_BUDGET, w_prev.numel())
    delta = (new_w - w_prev).reshape(-1)
    idx = torch.nonzero(delta != 0).reshape(-1)
    nchanged = idx.numel()
    if nchanged > budget:
        return build_template(D, new_w)
    idx_p = torch.zeros(budget, dtype=idx.dtype, device=idx.device)
    idx_p[:nchanged] = idx
    dvals = torch.zeros(budget, dtype=delta.dtype, device=delta.device)
    dvals[:nchanged] = delta[idx]
    T_sparse = T_prev + torch.matmul(dvals, D.reshape(-1, nbin)[idx_p])
    if not bool(torch.isfinite(T_sparse).all()):
        return build_template(D, new_w)
    return T_sparse


def to_device(a, device) -> torch.Tensor:
    """A float32 host array as a tensor on ``device``.  On the CPU the
    tensor shares the array's memory (the backend never writes to it); a
    read-only array is copied first, as torch cannot wrap one."""
    a = np.ascontiguousarray(a, np.float32)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


class TorchCleaner:
    """Stepwise backend: same protocol as NumpyCleaner, device-resident.

    With ``cfg.incremental_template`` (the default) the template is carried
    across ``step()`` calls and advanced from the flipped profiles; the
    first step builds it densely.  ``clean_cube`` forces the dense route
    whenever a residual is requested."""

    def __init__(self, D: np.ndarray, w0: np.ndarray, cfg: CleanConfig,
                 device="cuda") -> None:
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            check_fp32_matmul()
        self.cfg = cfg
        nbin = D.shape[-1]
        self._use_kernel = resolve_use_kernel(cfg, nbin, self.device)
        if self._use_kernel and self.device.type == "cuda":
            ok, why = kernel_route_status(nbin, self.device)
            if not ok:
                raise ValueError(f"kernel=True but the CUDA kernel cannot take "
                                 f"this cube: {why}")
        self._D = to_device(D, self.device)
        self._w0 = to_device(w0, self.device)
        self._valid = self._w0 != 0
        self._residual = None
        self._tmpl = None     # carried template (device) …
        self._tmpl_w = None   # … and the weights it was built for

    def step(self, w_prev: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        w_prev = to_device(w_prev, self.device)
        kw = dict(pulse_region=tuple(self.cfg.pulse_region), use_kernel=self._use_kernel)
        thresholds = (float(self.cfg.chanthresh), float(self.cfg.subintthresh))
        if not self.cfg.incremental_template:
            test, new_w, resid = clean_step(
                self._D, self._w0, self._valid, w_prev, *thresholds, **kw)
        else:
            if self._tmpl is None:
                template = build_template(self._D, w_prev)
            else:
                template = incremental_template(self._D, self._tmpl, self._tmpl_w, w_prev)
            self._tmpl, self._tmpl_w = template, w_prev
            test, new_w, resid = step_from_template(
                self._D, self._w0, self._valid, template, *thresholds, **kw)
        self._residual = resid  # stays on the device unless fetched
        return test.cpu().numpy(), new_w.cpu().numpy()

    def residual(self) -> np.ndarray | None:
        return None if self._residual is None else self._residual.cpu().numpy()
