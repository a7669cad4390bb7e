"""The fit/moments kernel and its routing.

``fused_fit_moments`` replaces the TPU kernel
``iterative_cleaner_tpu/ops/pallas_kernels.py::fused_fit_moments``
(``pl.pallas_call`` at :201).  Per (subint, channel) profile it fits the
template amplitude, forms the weighted, pulse-region-scaled residual, centres
it and computes the mean / std / ptp diagnostics — with ``valid`` given, the
numpy.ma fills too — reading the cube once and writing the centred cube
once.  A 4-D cube ``(a, nsub, nchan, nbin)`` with one template per archive
is the directory batch: one launch over all ``a`` archives, the leading
grid axis the JAX package gets from ``jax.vmap`` of the pallas_call.  On a
CUDA tensor it launches the hand-written Hopper kernel in
``csrc/fused_fit_moments.cu`` (the note there says what bounds it and how
the design meets that); on a CPU tensor it runs
:func:`fused_fit_moments_plain`, the same function in plain PyTorch, which
is also what the kernel is held against on the card.

``kernel_route_status`` / ``resolve_use_kernel`` replace
``pallas_route_status`` / ``resolve_use_pallas`` (pallas_kernels.py:246-317).
"""

from __future__ import annotations

import ctypes

import torch

from iterative_cleaner_tpu_torch.ops.cuda_build import load_library
from iterative_cleaner_tpu_torch.ops.stats import fill_moments, moments
from iterative_cleaner_tpu_torch.ops.template import (
    bin_scale_for,
    broadcast_template,
    fit_amplitudes,
    template_norms,
)

#: Profiles (warps) per block of the CUDA kernel; must match kWarps in the
#: source (checked when the library loads).
KERNEL_WARPS = 4
#: Shared memory one block may use on Hopper (227 KB, dynamic).
SMEM_PER_BLOCK = 232_448


def kernel_smem_bytes(nbin: int) -> int:
    """The template, the bin scale and one staged profile per warp."""
    return (2 + KERNEL_WARPS) * nbin * 4


def kernel_route_status(nbin: int, device) -> tuple[bool, str]:
    """Whether the CUDA kernel can take this shape on ``device``, with the
    reason either way."""
    device = torch.device(device)
    if device.type != "cuda":
        return False, (f"device {device.type!r} has no CUDA kernel; the plain "
                       "PyTorch version runs there")
    need = kernel_smem_bytes(nbin)
    if need > SMEM_PER_BLOCK:
        return False, (
            f"nbin={nbin}: a block stages the template, the bin scale and "
            f"{KERNEL_WARPS} profiles in shared memory, {need} bytes against "
            f"the {SMEM_PER_BLOCK} a Hopper block can use")
    return True, (f"cuda: {KERNEL_WARPS} profiles per block, one warp each, "
                  f"{need} bytes of shared memory per block")


def resolve_use_kernel(cfg, nbin: int, device, want_residual: bool = False) -> bool:
    """The route a clean dispatches with.  ``cfg.kernel`` is tri-state:

    - None (default) — auto: the kernel when the device is CUDA, the shape
      is viable and no residual is requested (the kernel never materialises
      it); off the card auto resolves off;
    - True — forced on.  On a CPU device that runs the plain version, as
      interpret mode does for Pallas; on the card a non-viable shape raises
      in the step;
    - False — the plain route.
    """
    if want_residual:
        return False
    if cfg.kernel is None:
        return kernel_route_status(nbin, device)[0]
    return bool(cfg.kernel)


#: Archives one launch can take: the grid's y extent.
MAX_ARCHIVES = 65535


def fused_fit_moments_plain(D, template, w0, valid=None, *,
                            pulse_region=(0.0, 0.0, 1.0)):
    """The kernel's function in plain PyTorch: returns (centred, mean, std,
    ptp), the maps filled where ``valid`` is False when it is given.  A
    batch ``D (a, nsub, nchan, nbin)`` takes ``template (a, nbin)`` and maps
    ``(a, nsub, nchan)``; each archive is computed as it would be alone."""
    amp = fit_amplitudes(D, template)
    bin_scale = bin_scale_for(D.shape[-1], pulse_region, D.device, D.dtype)
    wr = (amp[..., None] * broadcast_template(template, D) - D) * bin_scale * w0[..., None]
    centred, mean, std, ptp = moments(wr)
    if valid is not None:
        mean, std, ptp = fill_moments(mean, std, ptp, valid)
    return centred, mean, std, ptp


def _check_inputs(D, template, w0, valid):
    """Device, type, shape and contiguity of a 3-D call, or of a 4-D batch
    with one template per archive; returns ``(nsub, nchan, nbin)``."""
    if D.dim() not in (3, 4):
        raise ValueError(f"D must be (nsub, nchan, nbin) or (a, nsub, nchan, nbin), "
                         f"got shape {tuple(D.shape)}")
    lead = tuple(D.shape[:-3])
    nsub, nchan, nbin = D.shape[-3:]
    want = [("D", D, (*lead, nsub, nchan, nbin), torch.float32),
            ("template", template, (*lead, nbin), torch.float32),
            ("w0", w0, (*lead, nsub, nchan), torch.float32)]
    if valid is not None:
        want.append(("valid", valid, (*lead, nsub, nchan), torch.bool))
    for name, t, shape, dtype in want:
        if t.device != D.device:
            raise ValueError(f"{name} is on {t.device}, D on {D.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if lead and lead[0] > MAX_ARCHIVES:
        raise ValueError(f"{lead[0]} archives in one launch; the grid takes at most "
                         f"{MAX_ARCHIVES}")
    return nsub, nchan, nbin


def _library():
    lib = load_library("fused_fit_moments")
    if not getattr(lib, "_ict_bound", False):
        p = ctypes.c_void_p
        lib.fused_fit_moments_launch.argtypes = [p] * 10 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, p]
        lib.fused_fit_moments_launch.restype = ctypes.c_int
        lib.fused_fit_moments_error_string.argtypes = [ctypes.c_int]
        lib.fused_fit_moments_error_string.restype = ctypes.c_char_p
        lib.fused_fit_moments_warps.restype = ctypes.c_int
        if lib.fused_fit_moments_warps() != KERNEL_WARPS:
            raise RuntimeError("csrc/fused_fit_moments.cu and KERNEL_WARPS disagree")
        lib._ict_bound = True
    return lib


def fused_fit_moments(D, template, w0, valid=None, *, pulse_region=(0.0, 0.0, 1.0)):
    """Fit + subtract + weight + centre + moment diagnostics in one pass.

    D: (nsub, nchan, nbin) f32; template: (nbin,) f32; w0: (nsub, nchan) f32;
    valid: (nsub, nchan) bool or None.  Or the batch: D (a, nsub, nchan,
    nbin), template (a, nbin), w0 and valid (a, nsub, nchan) — one launch.
    Returns (centred, mean, std, ptp).  A CPU tensor runs the plain version;
    a CUDA tensor launches the kernel or raises — there is no fallback.
    """
    if D.device.type == "cpu":
        return fused_fit_moments_plain(D, template, w0, valid, pulse_region=pulse_region)
    if D.device.type != "cuda":
        raise ValueError(f"fused_fit_moments runs on cuda or cpu, not {D.device}")
    nsub, nchan, nbin = _check_inputs(D, template, w0, valid)
    narch = D.shape[0] if D.dim() == 4 else 1
    ok, why = kernel_route_status(nbin, D.device)
    if not ok:
        raise ValueError(why)
    centred = torch.empty_like(D)
    mean, std, ptp = (torch.empty(w0.shape, dtype=D.dtype, device=D.device)
                      for _ in range(3))
    nprof = nsub * nchan
    if nprof == 0 or narch == 0:
        return centred, mean, std, ptp
    # <t,t> (one per archive) and the bin scale are computed here, once, and
    # read by every block; <t,t> stays on the device (no host sync).
    tt = template_norms(template).reshape(narch)
    bin_scale = bin_scale_for(nbin, pulse_region, D.device, D.dtype)
    lib = _library()
    with torch.cuda.device(D.device):
        stream = torch.cuda.current_stream(D.device).cuda_stream
        # The ctypes launch is no torch op: this span names it on the host
        # side of a torch.profiler capture (the device side shows the CUDA
        # kernel fused_fit_moments_kernel).
        with torch.profiler.record_function("fused_fit_moments"):
            err = lib.fused_fit_moments_launch(
                D.data_ptr(), template.data_ptr(), bin_scale.data_ptr(), w0.data_ptr(),
                None if valid is None else valid.data_ptr(), tt.data_ptr(),
                centred.data_ptr(), mean.data_ptr(), std.data_ptr(), ptp.data_ptr(),
                nprof, nbin, narch, stream)
    if err != 0:
        raise RuntimeError(
            f"fused_fit_moments launch failed: "
            f"{lib.fused_fit_moments_error_string(err).decode()} (cudaError {err})")
    fused_fit_moments.launches += 1
    return centred, mean, std, ptp


#: Kernel launches since the last reset (plain-version calls never count).
fused_fit_moments.launches = 0
