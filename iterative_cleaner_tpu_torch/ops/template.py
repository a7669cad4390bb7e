"""Template build + closed-form amplitude fit.

Port of ``iterative_cleaner_tpu/ops/template.py:44-79``.  The reference fits
every profile with ``scipy.optimize.leastsq``; the model is linear in its one
parameter, so the least-squares solution is the closed form
``amp = <t, p> / <t, t>``.

The template is summed in the numpy oracle's order (:func:`build_template`:
one float32 accumulator per bin, advanced profile by profile, as
``np.einsum`` does), which gives the oracle's template bit for bit.  On the
card that is the hand-written kernel ``csrc/ordered_template.cu``; on the
CPU its plain version :func:`build_template_plain`.  Under ``--x64`` the
cube is float64 and so is the template: the same sum in one float64
accumulator per bin, the kernel's float64 instantiation on the card.  A matrix-vector
product sums in another order, and at 256 x 1024 x 1024 that moved the last
scores 5.1e-5 from the oracle's, beyond the 5e-5 envelope
(``obs/audit.AUDIT_DRIFT_BOUND``).

The fit's products run in full f32: the fit feeds a >=-threshold decision.
On the card that rests on TF32 being off for matmuls, which the torch
backend checks before it runs (``backends/torch_backend.check_fp32_matmul``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import threading

import torch

from iterative_cleaner_tpu_torch.config import (
    pulse_region_active,
    pulse_region_bin_scale,
)
from iterative_cleaner_tpu_torch.ops.cuda_build import load_library

#: Launch constants of ``csrc/ordered_template.cu``, mirrored here and held
#: against the library's ``ordered_template_constants`` when it is loaded.
TEMPLATE_THREADS = 128          # the chain warp and 3 producer warps
TEMPLATE_BINS_PER_BLOCK = 16    # one chain per lane of the chain warp
TEMPLATE_ROWS_PER_STAGE = 256
#: The float64 build's ring: half the rows, so a stage holds the same bytes.
TEMPLATE_ROWS_PER_STAGE_F64 = 128
TEMPLATE_STAGES = 6


def _smem_bytes(rows: int, itemsize: int) -> int:
    """Dynamic shared memory per block: a full and an empty mbarrier (8
    bytes each) per stage, then the stages, each its rows x bins tile and
    its rows' weights in the element type."""
    return TEMPLATE_STAGES * (16 + itemsize * rows * (TEMPLATE_BINS_PER_BLOCK + 1))


TEMPLATE_SMEM_BYTES = _smem_bytes(TEMPLATE_ROWS_PER_STAGE, 4)
#: Rows per stage by element type; both builds take TEMPLATE_SMEM_BYTES.
ROWS_PER_STAGE = {torch.float32: TEMPLATE_ROWS_PER_STAGE,
                  torch.float64: TEMPLATE_ROWS_PER_STAGE_F64}  # ict: f64-ok(explicit --x64 opt-in)
assert _smem_bytes(TEMPLATE_ROWS_PER_STAGE_F64, 8) == TEMPLATE_SMEM_BYTES

#: The kernel's load paths (its ``path`` argument): 16-byte copies where
#: the row pitch and the base allow them, a copy per element (4 or 8
#: bytes) anywhere else.
PATHS = ("aligned", "unaligned")

#: Profiles the plain version multiplies at once before its ordered adds.
PLAIN_ROWS = 4096


def build_template_plain(D: torch.Tensor, weights: torch.Tensor,
                         init: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``init`` (or zeros) plus
    ``weights[i] * D[i]`` for every profile ``i`` in (subint, channel)
    row-major order, each product and each sum rounded to float32 on its
    own — numpy's ``einsum("sc,scb->b", w, D, dtype=float32)`` for
    ``nbin >= 2``.  A float64 ``D`` sums the same way in float64."""
    nbin = D.shape[-1]
    rows = D.reshape(-1, nbin)
    w = weights.reshape(-1).to(D.dtype)
    acc = (torch.zeros(nbin, dtype=D.dtype, device=D.device) if init is None
           else init.reshape(nbin).clone())
    for lo in range(0, rows.shape[0], PLAIN_ROWS):
        for row in rows[lo:lo + PLAIN_ROWS] * w[lo:lo + PLAIN_ROWS, None]:
            acc = acc + row
    return acc


@dataclasses.dataclass(frozen=True)
class TemplateLaunch:
    """One launch of the kernel: its load path, its constants, its grid
    (``blocks`` = bin groups x archives; 0 launches nothing) and the
    archive strides of ``D`` and ``w`` in elements."""

    path: str
    bins_per_block: int
    stages: int
    rows_per_stage: int
    smem_bytes: int
    threads: int
    blocks: int
    nprof: int
    nbin: int
    narch: int
    d_arch_stride: int
    w_arch_stride: int


def launch_plan(nprof: int, nbin: int, narch: int, d_ptr: int, d_arch_stride: int,
                w_arch_stride: int, dtype: torch.dtype = torch.float32) -> TemplateLaunch:
    """The launch over ``narch`` archives of ``nprof`` profiles x ``nbin``
    bins of ``dtype``, archive ``a``'s rows at ``d_ptr + itemsize * a *
    d_arch_stride``: the aligned path when every row starts on 16 bytes (the
    base, the pitch and the archive stride), else the unaligned one.  An
    empty cube launches nothing (``blocks`` 0)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    aligned = (d_ptr % 16 == 0 and (nbin * itemsize) % 16 == 0
               and (d_arch_stride * itemsize) % 16 == 0)
    groups = -(-nbin // TEMPLATE_BINS_PER_BLOCK)
    return TemplateLaunch(
        path=PATHS[0] if aligned else PATHS[1],
        bins_per_block=TEMPLATE_BINS_PER_BLOCK, stages=TEMPLATE_STAGES,
        rows_per_stage=ROWS_PER_STAGE[dtype], smem_bytes=TEMPLATE_SMEM_BYTES,
        threads=TEMPLATE_THREADS, blocks=groups * narch if nprof > 0 else 0,
        nprof=nprof, nbin=nbin, narch=narch, d_arch_stride=d_arch_stride,
        w_arch_stride=w_arch_stride)


def plan_for(D: torch.Tensor, weights: torch.Tensor, init: torch.Tensor | None = None
             ) -> tuple[TemplateLaunch, torch.Tensor]:
    """Check the kernel's operands and plan its launch: ``D (..., nbin)``
    with one weight per profile, or a batch ``D (a, nsub, nchan, nbin)``
    with ``weights (a, nsub, nchan)`` and ``init (a, nbin)``, each archive's
    profiles contiguous and the archive axis of any stride (0 for a cube
    broadcast with ``expand``), float32 or float64 (``init`` of ``D``'s
    type).  Returns the plan and the weights as the kernel reads them:
    (archives, profiles) of ``D``'s type with contiguous profiles and the
    plan's archive stride (0 kept where they were broadcast)."""
    batched = D.dim() == weights.dim() + 1 and D.dim() == 4
    if D.dtype not in ROWS_PER_STAGE:
        raise TypeError(f"D must be float32 or float64, got {D.dtype}")
    narch = D.shape[0] if batched else 1
    nbin = D.shape[-1]
    nprof = math.prod(D.shape[1:-1] if batched else D.shape[:-1])
    if not (D[0] if batched and narch else D).is_contiguous():
        raise ValueError("D must be contiguous within each archive")
    if weights.numel() != narch * nprof or weights.device != D.device:
        raise ValueError(f"weights must hold one value per profile on {D.device}, "
                         f"got shape {tuple(weights.shape)} on {weights.device}")
    if init is not None and (init.dtype != D.dtype or not init.is_contiguous()
                             or init.numel() != narch * nbin or init.device != D.device):
        raise ValueError(f"init must be a contiguous {str(D.dtype).removeprefix('torch.')} "
                         f"template per archive on {D.device}")
    w = weights.to(D.dtype).reshape(narch, nprof)
    if nprof > 1 and w.stride(1) != 1:
        w = w.contiguous()
    d_stride = D.stride(0) if batched else nprof * nbin
    plan = launch_plan(nprof, nbin, narch, D.data_ptr(), d_stride,
                       w.stride(0) if batched else nprof, D.dtype)
    return plan, w


#: The library's entry points by element type: the launch and the chain probe.
ENTRIES = {torch.float32: ("ordered_template_launch", "ordered_template_chain_probe",
                           ctypes.c_float),
           torch.float64: ("ordered_template_launch_f64", "ordered_template_chain_probe_f64",  # ict: f64-ok(explicit --x64 opt-in)
                           ctypes.c_double)}


def _bind(lib) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for launch, probe, scalar in ENTRIES.values():
        getattr(lib, launch).argtypes = [p] * 4 + [i64, i32, i32, i64, i64, i32, p]
        getattr(lib, launch).restype = i32
        getattr(lib, probe).argtypes = [p, p, i64, scalar, p]
        getattr(lib, probe).restype = i32
    lib.ordered_template_error_string.argtypes = [i32]
    lib.ordered_template_error_string.restype = ctypes.c_char_p
    lib.ordered_template_constants.argtypes = [p]
    lib.ordered_template_constants.restype = None
    got = (ctypes.c_int * 7)()
    lib.ordered_template_constants(got)
    want = (TEMPLATE_THREADS, TEMPLATE_BINS_PER_BLOCK, TEMPLATE_ROWS_PER_STAGE,
            TEMPLATE_STAGES, TEMPLATE_SMEM_BYTES, TEMPLATE_ROWS_PER_STAGE_F64,
            TEMPLATE_SMEM_BYTES)
    if tuple(got) != want:
        raise RuntimeError(
            "csrc/ordered_template.cu and ops/template.py disagree on the launch "
            "constants (threads, bins, rows, stages, shared bytes, float64 rows and "
            f"shared bytes): {tuple(got)} against {want}")


def _library():
    return load_library("ordered_template", bind=_bind)


def _raise_for(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: {lib.ordered_template_error_string(err).decode()} "
                           f"(cudaError {err})")


def build_template(D: torch.Tensor, weights: torch.Tensor,
                   init: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted scrunch over (subint, channel): PSRCHIVE's fscrunch+tscrunch
    collapse up to overall scale, which cancels out of amp·t.  The template
    of ``D (..., nbin)`` under ``weights`` (one per profile) summed in the
    oracle's order, continuing ``init`` when given (the chunked route's
    blocks).  A batch — ``D (a, nsub, nchan, nbin)``, ``weights (a, nsub,
    nchan)``, ``init (a, nbin)`` — gives ``(a, nbin)`` in one launch, each
    archive as alone, whatever the stride of its archive axis (0 for the
    sweep's pairs over one cube).  A float64 cube gives a float64 template
    (the ``--x64`` routes).  A CPU tensor runs :func:`build_template_plain`;
    a CUDA tensor launches the kernel ``csrc/ordered_template.cu`` (its
    instantiation for ``D``'s type, as :func:`plan_for` plans it) or raises
    — there is no fallback.  Float32 launches count in ``launches``,
    float64 ones in ``launches_f64``."""
    batched = D.dim() == weights.dim() + 1 and D.dim() == 4
    if D.device.type == "cpu":
        if batched:
            return torch.stack([build_template_plain(
                Dj, wj, None if init is None else init[j])
                for j, (Dj, wj) in enumerate(zip(D, weights))])
        return build_template_plain(D, weights, init)
    if D.device.type != "cuda":
        raise ValueError(f"build_template runs on cuda or cpu, not {D.device}")
    plan, w = plan_for(D, weights, init)
    out = torch.empty((plan.narch, plan.nbin) if batched else (plan.nbin,), dtype=D.dtype,
                      device=D.device)
    if plan.blocks == 0:   # no bins, no archives, or no profiles: init or zeros
        return out.copy_(init.reshape(out.shape)) if init is not None else out.zero_()
    lib = _library()
    with torch.cuda.device(D.device):  # ict: backend-init-ok(the operands are on the card: CUDA is live)
        stream = torch.cuda.current_stream(D.device).cuda_stream  # ict: backend-init-ok(the operands are on the card: CUDA is live)
        with torch.profiler.record_function("ordered_template"):
            err = getattr(lib, ENTRIES[D.dtype][0])(
                D.data_ptr(), w.data_ptr(), None if init is None else init.data_ptr(),
                out.data_ptr(), plan.nprof, plan.nbin, plan.narch, plan.d_arch_stride,
                plan.w_arch_stride, PATHS.index(plan.path), stream)
    _raise_for(lib, err, "ordered_template launch")
    with _LAUNCHES_LOCK:   # launches may come from several host threads
        if D.dtype == torch.float64:  # ict: f64-ok(explicit --x64 opt-in)
            build_template.launches_f64 += 1
        else:
            build_template.launches += 1
    return out


#: Kernel launches since the last reset, float32 and float64 (plain-version
#: calls never count).
build_template.launches = 0
build_template.launches_f64 = 0
_LAUNCHES_LOCK = threading.Lock()


def build_templates(Db: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """One template per archive of a batch ``Db (a, nsub, nchan, nbin)``:
    ``(a, nbin)``, each bit-identical to that archive's single-archive
    template, in one launch — a contiguous batch or the sweep's stride-0
    pair axis alike."""
    if Db.dim() != 4 or wb.dim() != 3:
        raise ValueError(f"a batch is (a, nsub, nchan, nbin) with (a, nsub, nchan) weights, "
                         f"got {tuple(Db.shape)} and {tuple(wb.shape)}")
    return build_template(Db, wb)


def chain_probe(n_adds: int, device="cuda", dtype=torch.float32) -> tuple[float, int]:
    """Measurement only (``chip_smoke.py`` phase 3): one warp of the
    library running chains of ``n_adds`` dependent adds of ``dtype``.
    Returns (milliseconds by CUDA events, the SM cycles the chain took)."""
    lib = _library()
    out = torch.empty(32, dtype=dtype, device=device)
    cycles = torch.zeros(1, dtype=torch.int64, device=device)
    with torch.cuda.device(out.device):  # ict: backend-init-ok(its output is on the card: CUDA is live)
        stream = torch.cuda.current_stream(out.device)  # ict: backend-init-ok(its output is on the card: CUDA is live)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record(stream)
        err = getattr(lib, ENTRIES[dtype][1])(out.data_ptr(), cycles.data_ptr(), n_adds,
                                              1e-3, stream.cuda_stream)
        b.record(stream)
    _raise_for(lib, err, "ordered_template_chain_probe launch")
    b.synchronize()
    return a.elapsed_time(b), int(cycles.item())


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
