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
is also what the kernel is held against on the card.  :func:`launch_plan`
(:func:`plan_for` on a tensor) chooses the launch — the load path from the
base and the pitch, the ring's stages and rows from ``nbin``, the
persistent grid from the card's SMs — as ``ops/template.launch_plan`` does
for the template kernel.

``kernel_route_status`` / ``resolve_use_kernel`` replace
``pallas_route_status`` / ``resolve_use_pallas`` (pallas_kernels.py:246-317).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import threading

import torch

from iterative_cleaner_tpu_torch.ops.cuda_build import load_library
from iterative_cleaner_tpu_torch.ops.stats import fill_moments, moments
from iterative_cleaner_tpu_torch.ops.template import (
    bin_scale_for,
    broadcast_template,
    fit_amplitudes,
)

#: Launch constants of ``csrc/fused_fit_moments.cu``, mirrored here and held
#: against the library's ``fused_fit_moments_constants`` when it is loaded.
KERNEL_CONSUMER_WARPS = 4       # warps that fit profiles; one producer warp besides
KERNEL_THREADS = 32 * (KERNEL_CONSUMER_WARPS + 1)
KERNEL_MAX_STAGES = 8
#: A full and an empty mbarrier (8 bytes each) and the tile's index (8
#: bytes) per possible stage.
KERNEL_HEADER_BYTES = 3 * KERNEL_MAX_STAGES * 8
#: Profiles a stage may hold.
KERNEL_MAX_ROWS = 128
#: The aligned path's copies: 0 = one TMA bulk copy per tile.
KERNEL_COPY = 0
#: Shared memory one block may use on Hopper (227 KB, dynamic), and one SM
#: holds for its blocks (228 KB, of which each block's 1 KB is reserved).
SMEM_PER_BLOCK = 232_448
SMEM_PER_SM = 233_472
SMEM_RESERVED_PER_BLOCK = 1024
#: SMs of an H100 SXM: the plan's default where no card is asked.
H100_SMS = 132

#: The plan's ring: up to this many bytes of rows a block keeps in shared
#: memory, each stage one row per consumer warp (fewer where a row is wide,
#: down to one), at least two stages; blocks per SM as shared memory allows,
#: at most BLOCKS_PER_SM (the kernel's register budget, kBlocksPerSM).
RING_BYTES = 64 * 1024
MIN_STAGES = 2
BLOCKS_PER_SM = 3

#: The kernel's load paths (its ``path`` argument): bulk copies and 16-byte
#: stores where the base and the row pitch allow them, 4-byte copies and
#: stores anywhere else.
PATHS = ("aligned", "unaligned")


def kernel_smem_bytes(nbin: int, stages: int, rows: int) -> int:
    """A block's dynamic shared memory: the header, the template and the
    bin scale, and ``stages`` stages of ``rows`` profiles (each row padded
    to 16 bytes) and their weights (padded to 16 bytes)."""
    pitch = -(-nbin // 4) * 4
    return KERNEL_HEADER_BYTES + 4 * (2 * pitch + stages * (rows * pitch + -(-rows // 4) * 4))


def ring_shape(nbin: int) -> tuple[int, int] | None:
    """(stages, rows per stage) of the ring for ``nbin`` bins, or None where
    even two stages of one row do not fit a block."""
    row_bytes = 16 * max(1, -(-nbin // 4))
    rows = KERNEL_CONSUMER_WARPS
    while rows > 1 and MIN_STAGES * rows * row_bytes > RING_BYTES:
        rows //= 2
    stages = min(KERNEL_MAX_STAGES, max(MIN_STAGES, RING_BYTES // (rows * row_bytes)))
    while stages > MIN_STAGES and kernel_smem_bytes(nbin, stages, rows) > SMEM_PER_BLOCK:
        stages -= 1
    return (stages, rows) if kernel_smem_bytes(nbin, stages, rows) <= SMEM_PER_BLOCK else None


@dataclasses.dataclass(frozen=True)
class FitLaunch:
    """One launch of the kernel: its load path, its ring (``stages`` of
    ``rows_per_stage`` profiles), shared memory and threads per block, and
    its grid (``blocks``, which take the ``tiles`` from a counter as they
    go; 0 launches nothing)."""

    path: str
    stages: int
    rows_per_stage: int
    smem_bytes: int
    threads: int
    blocks: int
    tiles: int
    nprof: int
    nbin: int
    narch: int


def launch_plan(nprof: int, nbin: int, narch: int, d_ptr: int, sms: int = H100_SMS, *,
                stages: int | None = None, rows: int | None = None,
                blocks_per_sm: int | None = None, blocks: int | None = None,
                path: str | None = None) -> FitLaunch:
    """The launch over ``narch`` archives of ``nprof`` profiles x ``nbin``
    bins from ``d_ptr`` on a card of ``sms`` SMs: the aligned path where
    every row starts on 16 bytes (the base and the pitch; an archive's
    offset, ``nprof * nbin`` floats, then does too), else the unaligned one;
    the ring by :func:`ring_shape`; as many blocks as the SMs hold at once
    (persistent), never more than the tiles, taking their tiles from a
    counter as they go.  The keywords override a choice: the ring's shape,
    blocks per SM and the load path, which ``tools_torch/fit_moments_probe.py``
    measures, and the grid itself, for the probe's stand-in for the first
    design (a block per tile); ``chip_smoke.py`` holds the 4-byte path and
    that stand-in to the plan's bits.  An empty cube launches nothing
    (``blocks`` 0).  Raises ValueError where the ring does not fit a
    block."""
    return _plan(nprof, nbin, narch, d_ptr % 16 == 0 and nbin % 4 == 0, sms, stages, rows,
                 blocks_per_sm, blocks, path)


@functools.lru_cache(maxsize=256)
def _plan(nprof, nbin, narch, aligned, sms, stages, rows, blocks_per_sm, blocks,
          path) -> FitLaunch:
    """:func:`launch_plan`, kept per shape: a call of the wrapper costs the
    host a lookup, not the plan's arithmetic."""
    if stages is None or rows is None:
        shape = ring_shape(nbin)
        if shape is None:
            raise ValueError(kernel_route_status(nbin, "cuda")[1])
        stages = shape[0] if stages is None else stages
        rows = shape[1] if rows is None else rows
    if not (1 <= stages <= KERNEL_MAX_STAGES and 1 <= rows <= KERNEL_MAX_ROWS):
        raise ValueError(f"stages {stages} (1..{KERNEL_MAX_STAGES}), rows {rows} "
                         f"(1..{KERNEL_MAX_ROWS})")
    smem = kernel_smem_bytes(nbin, stages, rows)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"nbin={nbin}: {stages} stages of {rows} profiles take {smem} bytes "
                         f"of shared memory, a block can use {SMEM_PER_BLOCK}")
    per_sm = max(1, min(blocks_per_sm or BLOCKS_PER_SM,
                        SMEM_PER_SM // (smem + SMEM_RESERVED_PER_BLOCK)))
    tiles = narch * -(-nprof // rows) if nbin > 0 else 0
    return FitLaunch(
        path=path or PATHS[0 if aligned else 1], stages=stages,
        rows_per_stage=rows, smem_bytes=smem, threads=KERNEL_THREADS,
        blocks=min(tiles, blocks if blocks is not None else sms * per_sm), tiles=tiles,
        nprof=nprof, nbin=nbin, narch=narch)


@functools.lru_cache(maxsize=8)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def plan_for(D: torch.Tensor, **overrides) -> FitLaunch:
    """:func:`launch_plan` for the cube ``D`` (3-D, or 4-D with a leading
    archive axis) on the card it lies on."""
    nbin = D.shape[-1]
    narch = D.shape[0] if D.dim() == 4 else 1
    nprof = D.numel() // max(1, nbin * narch)
    sms = _sm_count(D.device) if D.device.type == "cuda" else H100_SMS
    return launch_plan(nprof, nbin, narch, D.data_ptr(), sms, **overrides)


def kernel_route_status(nbin: int, device) -> tuple[bool, str]:
    """Whether the CUDA kernel can take this shape on ``device``, with the
    reason either way; the reason names the launch plan."""
    device = torch.device(device)
    if device.type != "cuda":
        return False, (f"device {device.type!r} has no CUDA kernel; the plain "
                       "PyTorch version runs there")
    shape = ring_shape(nbin)
    if shape is None:
        return False, (
            f"nbin={nbin}: a block stages the template, the bin scale and a ring of at "
            f"least {MIN_STAGES} profiles in shared memory, "
            f"{kernel_smem_bytes(nbin, MIN_STAGES, 1)} bytes against the {SMEM_PER_BLOCK} "
            "a Hopper block can use")
    stages, rows = shape
    copies = ("bulk copies and 16-byte stores where the base is 16-byte aligned"
              if nbin % 4 == 0 else f"4-byte copies and stores (nbin % 4 = {nbin % 4})")
    return True, (f"cuda: persistent blocks of {KERNEL_CONSUMER_WARPS} consumer warps and a "
                  f"producer warp, a ring of {stages} stages x {rows} profiles, "
                  f"{kernel_smem_bytes(nbin, stages, rows)} bytes of shared memory per "
                  f"block; {copies}")


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


#: Archives one launch takes: the limit of the first design's grid (its y
#: extent), kept so that a batch too large for one launch fails as it did.
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


def bind(lib) -> tuple[int, ...]:
    """Declare the C interface of a build of ``csrc/fused_fit_moments.cu``
    on the loaded ``lib``; returns the build's constants (threads, consumer
    warps, most stages, header bytes, the aligned path's copies, most
    shared bytes per block)."""
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fused_fit_moments_launch.argtypes = [p] * 9 + [i64, i32, i32, i32, i32, i32, i64, p, p]
    lib.fused_fit_moments_launch.restype = i32
    lib.fused_fit_moments_error_string.argtypes = [i32]
    lib.fused_fit_moments_error_string.restype = ctypes.c_char_p
    lib.fused_fit_moments_constants.argtypes = [p]
    lib.fused_fit_moments_constants.restype = None
    got = (ctypes.c_int * 6)()
    lib.fused_fit_moments_constants(got)
    return tuple(got)


def _bind_checked(lib) -> None:
    got = bind(lib)
    want = (KERNEL_THREADS, KERNEL_CONSUMER_WARPS, KERNEL_MAX_STAGES, KERNEL_HEADER_BYTES,
            KERNEL_COPY, SMEM_PER_BLOCK)
    if got != want:
        raise RuntimeError(
            "csrc/fused_fit_moments.cu and ops/fused_kernels.py disagree on the launch "
            "constants (threads, consumer warps, stages, header bytes, copies, shared "
            f"bytes): {got} against {want}")


def _library():
    return load_library("fused_fit_moments", bind=_bind_checked)


#: The tile counters of each (device, stream): two int64, 0 between
#: launches (the kernel's last block resets them), so a launch needs no
#: allocation and no memset of its own.  Launches on one stream run one
#: after another, so one pair serves every host thread that launches there
#: (the serving daemon's dispatch worker and its session passes); the lock
#: makes the first two launches of a stream share one pair.
_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}  # ict: guarded-by(_COUNTERS_LOCK)
_COUNTERS_LOCK = threading.Lock()


def _tile_counters(device: torch.device, stream: int) -> torch.Tensor:
    with _COUNTERS_LOCK:
        counters = _COUNTERS.get((device.index, stream))
        if counters is None:
            # Zeroed on ``stream`` (the caller's current stream), before the
            # launch that first reads it.
            counters = _COUNTERS[(device.index, stream)] = torch.zeros(
                2, dtype=torch.int64, device=device)
        return counters


def launch(plan: FitLaunch, D, template, w0, valid=None, *, pulse_region=(0.0, 0.0, 1.0),
           lib=None):
    """Launch the kernel on checked CUDA operands as ``plan`` says — the
    wrapper's plan, or one with a choice overridden — from the package's
    build or, for the probe's build of the other copy path, the bound build
    ``lib``; returns (centred, mean, std, ptp) and counts the launch.  A
    failed launch raises."""
    narch = D.shape[0] if D.dim() == 4 else 1
    if (plan.narch, plan.nprof, plan.nbin) != (narch, D.numel() // max(1, D.shape[-1] * narch),
                                               D.shape[-1]):
        raise ValueError(f"the plan {plan} is not for a cube of shape {tuple(D.shape)}")
    centred = torch.empty_like(D)
    mean, std, ptp = (torch.empty_like(w0) for _ in range(3))     # w0 is D's dtype
    if plan.blocks == 0:
        return centred, mean, std, ptp
    # The bin scale is made once per shape and region; <t,t> is the kernel's.
    bin_scale = bin_scale_for(plan.nbin, pulse_region, D.device, D.dtype)
    lib = lib or _library()
    with torch.cuda.device(D.device):
        # The current stream's cudaStream_t, without a torch.cuda.Stream
        # object for it (the host's time a call is the slab's bottleneck).
        stream = torch._C._cuda_getCurrentRawStream(D.device.index)
        counters = _tile_counters(D.device, stream)
        # The ctypes launch is no torch op: this span names it on the host
        # side of a torch.profiler capture (the device side shows the CUDA
        # kernel fused_fit_moments_kernel).  Opened only while a profiler
        # runs: outside one it records nothing and costs the call host time.
        span = (torch.profiler.record_function("fused_fit_moments")
                if torch.autograd.profiler._is_profiler_enabled else contextlib.nullcontext())
        with span:
            err = lib.fused_fit_moments_launch(
                D.data_ptr(), template.data_ptr(), bin_scale.data_ptr(), w0.data_ptr(),
                None if valid is None else valid.data_ptr(),
                centred.data_ptr(), mean.data_ptr(), std.data_ptr(), ptp.data_ptr(),
                plan.nprof, plan.nbin, plan.narch, PATHS.index(plan.path), plan.stages,
                plan.rows_per_stage, plan.blocks, counters.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"fused_fit_moments launch failed: "
            f"{lib.fused_fit_moments_error_string(err).decode()} (cudaError {err})")
    with _COUNTERS_LOCK:   # launches may come from several host threads
        fused_fit_moments.launches += 1
    return centred, mean, std, ptp


def fused_fit_moments(D, template, w0, valid=None, *, pulse_region=(0.0, 0.0, 1.0)):
    """Fit + subtract + weight + centre + moment diagnostics in one pass.

    D: (nsub, nchan, nbin) f32; template: (nbin,) f32; w0: (nsub, nchan) f32;
    valid: (nsub, nchan) bool or None.  Or the batch: D (a, nsub, nchan,
    nbin), template (a, nbin), w0 and valid (a, nsub, nchan) — one launch.
    Returns (centred, mean, std, ptp).  A CPU tensor runs the plain version;
    a CUDA tensor launches the kernel (as :func:`plan_for` plans it) or
    raises — there is no fallback.
    """
    if D.device.type == "cpu":
        return fused_fit_moments_plain(D, template, w0, valid, pulse_region=pulse_region)
    if D.device.type != "cuda":
        raise ValueError(f"fused_fit_moments runs on cuda or cpu, not {D.device}")
    _check_inputs(D, template, w0, valid)
    return launch(plan_for(D), D, template, w0, valid, pulse_region=pulse_region)


#: Kernel launches since the last reset (plain-version calls never count).
fused_fit_moments.launches = 0
