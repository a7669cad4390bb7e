"""The PyTorch backend: the cleaning iteration on a device.

Port of ``iterative_cleaner_tpu/backends/jax_backend.py``:
``step_from_template`` / ``clean_step`` (:34-102), the incremental template
(:105-152), the precompile warm-up (``precompile_for`` /
``start_precompile``, :164-281), the fused loop (``fused_clean`` /
``run_fused``, :284-355 and :443-481) and the stepwise ``JaxCleaner``
(:373-440) as ``TorchCleaner``.  The cube goes to the device once; each
iteration runs template → fit / subtract / moments (the CUDA kernel, or the
plain route) → FFT diagnostic → robust scalers → zap map on the device.
PyTorch runs eagerly, so there is no ``jit``: the ``lax.cond`` of the
incremental template becomes a Python ``if`` on one host read, and the
fused ``lax.while_loop`` a Python loop over device tensors.  The compute
type is float32, or float64 under ``cfg.x64`` (:func:`compute_dtype`, the
counterpart of ``_x64_dtype`` at ``:358-370``; torch has float64 without a
process-wide switch): the cube, the weights, the template and every map.

Entry points run on the card unless the caller asks for the CPU: with no
CUDA device and no explicit ``device="cpu"``, :func:`resolve_device` raises.
"""

from __future__ import annotations

import math
import os
import threading

import numpy as np
import torch

from iterative_cleaner_tpu_torch.config import CleanConfig
from iterative_cleaner_tpu_torch.ingest import staging
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
from iterative_cleaner_tpu_torch.obs import tracing
from iterative_cleaner_tpu_torch.obs.tracing import compile_scope, shape_bucket_label
from iterative_cleaner_tpu_torch.ops.template import build_template, fit_and_subtract

# Per-iteration budget of profile flips the incremental template update
# handles sparsely; beyond it the template is rebuilt densely.
INCREMENTAL_TEMPLATE_BUDGET = 512


def compute_dtype(cfg: CleanConfig) -> torch.dtype:
    """The type a clean computes in: float64 under ``cfg.x64``, else
    float32."""
    return torch.float64 if cfg.x64 else torch.float32  # ict: f64-ok(explicit --x64 opt-in)


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
    materialises it.  Batched tensors — D (a, nsub, nchan, nbin), one
    template per archive (a, nbin), maps (a, nsub, nchan) — are the
    directory batch's step (``parallel/sharded.py``): one kernel launch
    over all archives, every other op archive by archive."""
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


def sparse_template_candidate(D, T_prev, w_prev, new_w):
    """``T_prev + sum_changed (new_w - w_prev) * profile`` over the first
    INCREMENTAL_TEMPLATE_BUDGET flipped profiles (padded slots repeat
    profile 0 with a zero weight, as the JAX package's static-size gather
    does), and whether it may stand for the dense rebuild: not when more
    profiles flipped than the budget, nor when it is not finite (an inf/NaN
    profile entering or leaving the support makes inf-inf = NaN where the
    dense build is finite).  Both stay on the device: no host sync."""
    nbin = D.shape[-1]
    budget = min(INCREMENTAL_TEMPLATE_BUDGET, w_prev.numel())
    delta = (new_w - w_prev).reshape(-1)
    changed = delta != 0
    # Static size: the count never has to be read on the host.
    idx = torch.nonzero_static(changed, size=budget, fill_value=0).reshape(-1)
    nchanged = changed.sum()
    live = torch.arange(budget, device=D.device) < nchanged
    dvals = torch.where(live, delta[idx], torch.zeros((), dtype=delta.dtype, device=D.device))
    T_sparse = T_prev + torch.matmul(dvals, D.reshape(-1, nbin).index_select(0, idx))
    return T_sparse, (nchanged <= budget) & torch.isfinite(T_sparse).all()


#: Templates advanced by the sparse update instead of a dense rebuild, on
#: every route, since the last reset (the fuzz tools read it).
sparse_template_candidate.taken = 0
_SPARSE_LOCK = threading.Lock()


def note_sparse_step() -> None:
    """Count one template advanced by the sparse update: the one place
    every route (in-memory and chunked) counts it, under a lock because
    the service runs cleans on several host threads."""
    with _SPARSE_LOCK:
        sparse_template_candidate.taken += 1


def incremental_template(D, T_prev, w_prev, new_w):
    """Next iteration's template without re-reading the cube: the sparse
    candidate where it may stand, else the dense rebuild.  One host read."""
    T_sparse, ok = sparse_template_candidate(D, T_prev, w_prev, new_w)
    if bool(ok):
        note_sparse_step()
        return T_sparse
    return build_template(D, new_w)


#: The numpy type of each compute type, and of the preprocess's shifts.
_NUMPY_TYPES = {torch.float32: np.float32, torch.float64: np.float64,  # ict: f64-ok(explicit --x64 opt-in)
                torch.int32: np.int32}


def takes_staged_route(a, device: torch.device, dtype) -> bool:
    """Whether :func:`to_device` copies ``a`` to ``device`` through the
    pinned pieces: a numpy array of ``dtype`` already (no cast) and of at
    least ``ingest/staging.STAGED_MIN_BYTES``, to a CUDA device."""
    return (device.type == "cuda" and isinstance(a, np.ndarray)
            and a.dtype == _NUMPY_TYPES[dtype] and a.nbytes >= staging.STAGED_MIN_BYTES)


def to_device(a, device, dtype=torch.float32) -> torch.Tensor:
    """A host array as a ``dtype`` tensor (float32 or float64; int32 for
    the preprocess's shifts) on ``device``.  On the CPU the tensor shares
    the array's memory where it has that type already (the backend never
    writes to it); a read-only array is copied first, as torch cannot wrap
    one.  A tensor passes through: as it is where it has ``device`` and
    ``dtype`` already (the cube the device preprocess made).  Where
    :func:`takes_staged_route`, the array, strided or not, is copied through
    the process's pinned pieces by several host threads
    (``ingest/staging.StagingPool.fill``, counter ``clean_upload_staged``);
    any other array to a CUDA device takes one pageable copy."""
    if isinstance(a, torch.Tensor):
        if a.dtype == dtype and a.device == torch.device(device):
            return a
        return a.to(device=device, dtype=dtype)
    dev = torch.device(device)
    if takes_staged_route(a, dev, dtype):
        dst = torch.empty(a.shape, dtype=dtype, device=dev)
        staging.pool_for(dev).fill(dst, a)
        tracing.count("clean_upload_staged")
        return dst
    a = np.ascontiguousarray(a, _NUMPY_TYPES[dtype])
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


def upload(device, dtype, *arrays) -> list[torch.Tensor]:
    """:func:`to_device` of each array, in the ``clean_upload`` phase,
    counting the bytes copied from host arrays (``clean_upload_bytes``,
    after the conversion to ``dtype``); a tensor is no upload."""
    with tracing.phase("clean_upload"):
        out = [to_device(a, device, dtype) for a in arrays]
        tracing.count("clean_upload_bytes", float(sum(
            t.nbytes for a, t in zip(arrays, out) if not isinstance(a, torch.Tensor))))
    return out


def kernel_for(cfg: CleanConfig, nbin: int, device: torch.device,
               want_residual: bool = False) -> bool:
    """The fit/moments route a clean dispatches with on ``device``; a
    forced kernel the card cannot take raises rather than running the plain
    route."""
    use_kernel = resolve_use_kernel(cfg, nbin, device, want_residual)
    if use_kernel and device.type == "cuda":
        ok, why = kernel_route_status(nbin, device)
        if not ok:
            raise ValueError(f"kernel=True but the CUDA kernel cannot take "
                             f"this cube: {why}")
    return use_kernel


def device_for(device) -> torch.device:
    """:func:`resolve_device`, plus the float32 matmul check on the card."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        check_fp32_matmul()
    return dev


class TorchCleaner:
    """Stepwise backend: same protocol as NumpyCleaner, device-resident.

    With ``cfg.incremental_template`` (the default) the template is carried
    across ``step()`` calls and advanced from the flipped profiles; the
    first step builds it densely.  ``clean_cube`` forces the dense route
    whenever a residual is requested."""

    def __init__(self, D: np.ndarray, w0: np.ndarray, cfg: CleanConfig,
                 device="cuda") -> None:
        self.device = device_for(device)
        self.cfg = cfg
        self._dtype = compute_dtype(cfg)
        self._use_kernel = kernel_for(cfg, D.shape[-1], self.device)
        self._D, self._w0 = upload(self.device, self._dtype, D, w0)
        self._valid = self._w0 != 0
        self._residual = None
        self._tmpl = None     # carried template (device) …
        self._tmpl_w = None   # … and the weights it was built for

    def step(self, w_prev: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        w_prev = to_device(w_prev, self.device, self._dtype)
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


def fused_clean(D, w0, valid, chanthresh, subintthresh, *, max_iter, pulse_region,
                want_residual=False, use_kernel=False, incremental=False):
    """The whole convergence loop on the device.

    PyTorch has no ``lax.while_loop``, so this is a Python loop over device
    tensors under one rule: nothing of (nsub, nchan) size or larger goes to
    the host inside the loop, and each iteration reads the host exactly
    once — the stop flag together with the sparse-or-dense template
    decision.  ``history`` is a (max_iter+1, nsub, nchan) ring on the device
    with the pre-loop weights in row 0; the cycle test is
    ``any(row_live & all(new_w == history))`` over the populated rows.

    With ``incremental`` iteration 1 uses the dense template from ``w0`` and
    later iterations the sparse update (dense when it may not stand).
    ``want_residual`` keeps the last iteration's residual, which the kernel
    never materialises.  Returns ``(test, w_final, loops, done, x, resid,
    history)``: device tensors, except ``loops``/``done``/``x`` (host values,
    already read) and ``resid`` (None without ``want_residual``).
    """
    if want_residual and use_kernel:
        raise ValueError("the kernel route does not materialise the residual "
                         "cube; use_kernel requires want_residual=False")
    nsub, nchan = w0.shape
    history = torch.zeros((max_iter + 1, nsub, nchan), dtype=w0.dtype, device=w0.device)
    history[0] = w0
    rows = torch.arange(max_iter + 1, device=w0.device)
    kw = dict(pulse_region=pulse_region, use_kernel=use_kernel)
    # Iteration 1's template is the dense build from the pre-loop weights on
    # both routes; only iterations >= 2 take the sparse update.
    template = build_template(D, w0) if incremental else None
    w_prev, x, hit = w0, 0, False
    while x < max_iter:
        x += 1
        if not incremental:
            template = build_template(D, w_prev)
        test, new_w, resid = step_from_template(
            D, w0, valid, template, chanthresh, subintthresh, **kw)
        # Rows 0..x-1 are populated.
        hit_t = ((rows < x) & (new_w[None] == history).flatten(1).all(dim=1)).any()
        history[x] = new_w
        if incremental and x < max_iter:
            cand, sparse_ok = sparse_template_candidate(D, template, w_prev, new_w)
            hit, sparse = torch.stack((hit_t, sparse_ok)).tolist()  # the host read
            if not hit:
                if sparse:
                    note_sparse_step()
                template = cand if sparse else build_template(D, new_w)
        else:
            hit = bool(hit_t)  # the host read
        w_prev = new_w
        if hit:
            break
    loops = x if hit else max_iter
    return test, w_prev, loops, bool(hit), x, (resid if want_residual else None), history


def run_fused(D, w0, cfg: CleanConfig, want_residual: bool = False, device="cuda"):
    """The fused clean; returns ``(test, weights, loops, converged, iters,
    history[, residual])`` as host values.  ``history`` is the populated
    prefix ``history[:iters+1]`` of the device ring (pre-loop weights
    first), fetched once, together with the scores, at the end."""
    dev = device_for(device)
    dtype = compute_dtype(cfg)
    D_t, w0_t = upload(dev, dtype, D, w0)
    use_kernel = kernel_for(cfg, D_t.shape[-1], dev, want_residual)
    with tracing.phase("clean_loop"):
        test, _w, loops, done, x, resid, history = fused_clean(
            D_t, w0_t, w0_t != 0, float(cfg.chanthresh), float(cfg.subintthresh),
            max_iter=int(cfg.max_iter), pulse_region=tuple(cfg.pulse_region),
            want_residual=want_residual, use_kernel=use_kernel,
            # A residual must come from a dense template (bit-exact output;
            # the sparse update's envelope is documented for scores only).
            incremental=cfg.incremental_template and not want_residual)
        fetched = torch.cat((test[None], history[: x + 1])).cpu().numpy()
    hist = fetched[1:]
    out = (fetched[0], hist[-1].copy(), loops, done, x, hist)
    if want_residual:
        out = out + (resid.cpu().numpy(),)
    return out


def precompile_for(shape, cfg: CleanConfig, want_residual: bool = False,
                   device="cuda") -> None:
    """Run the route ``clean_cube`` will take for a cube of ``shape`` once,
    on a zero cube on ``device``: that loads (or builds) the kernel library
    and sets up the cuFFT plan, the cuBLAS handle and the allocator's blocks
    for these shapes while the host is busy elsewhere.  On a zero cube the
    loop stops after one iteration (zero template → zero residual → NaN
    scalers → no flags → the weights repeat).  Mirrors clean_cube's route
    choices (kernel and incremental template off for a residual)."""
    dev = torch.device(device)
    nsub, nchan, nbin = (int(v) for v in shape)
    dtype = compute_dtype(cfg)
    D = torch.zeros((nsub, nchan, nbin), dtype=dtype, device=dev)
    w = torch.zeros((nsub, nchan), dtype=dtype, device=dev)
    v = w != 0
    pr = tuple(cfg.pulse_region)
    use_kernel = kernel_for(cfg, nbin, dev, want_residual)
    incremental = cfg.incremental_template and not want_residual
    if cfg.fused:
        fused_clean(D, w, v, 5.0, 5.0, max_iter=int(cfg.max_iter), pulse_region=pr,
                    want_residual=want_residual, use_kernel=use_kernel,
                    incremental=incremental)
    elif incremental:
        t = build_template(D, w)
        step_from_template(D, w, v, t, 5.0, 5.0, pulse_region=pr, use_kernel=use_kernel)
        incremental_template(D, t, w, w)
    else:
        clean_step(D, w, v, w, 5.0, 5.0, pulse_region=pr, use_kernel=use_kernel)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)  # ict: backend-init-ok(after the warm-up's device work: CUDA is live)


def start_precompile(shape, cfg: CleanConfig, want_residual: bool = False,
                     device="cuda") -> threading.Thread | None:
    """Start :func:`precompile_for` on a daemon thread, to overlap the
    host's preprocessing; returns the thread to join before the first
    device call, or None when there is nothing to warm: not the torch
    backend, not a CUDA device that exists, ``ICT_NO_PRECOMPILE=1``, or an
    explicit ``chunk_block``.  Inside the thread it also skips the chunked
    route and a cube whose doubled working set would not fit (the dummy
    cube would crowd out the real one); before that it makes the process's
    pinned pieces for the cube's upload (``ingest/staging.pool_for``) where
    the cube takes the staged route.  A failure is kept on the thread's
    ``error`` and not raised: the real call repeats the work and raises
    there.  The thread's ``launches`` is the kernel launches its dummy run
    made (the counter's movement while it ran; the caller makes none until
    it joins), ``template_launches`` the same for the template kernel (its
    float64 launches under ``cfg.x64``), ``sparse_steps`` the templates it
    advanced by the sparse update (the stepwise dummy step takes one).  A
    kernel library built here is accounted to the cube's shape bucket.  The
    warm-up never changes the device or the route."""
    if (cfg.backend != "torch" or os.environ.get("ICT_NO_PRECOMPILE") == "1"
            or cfg.chunk_block):
        return None
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None

    def _run() -> None:
        from iterative_cleaner_tpu_torch.parallel.autoshard import (
            HBM_USABLE_FRACTION,
            chunk_block_subints,
            clean_working_set_bytes,
            device_memory_bytes,
        )

        try:
            with tracing.phase("clean_warmup"):
                if cfg.auto_shard and chunk_block_subints(shape, cfg, dev, want_residual):
                    return  # the chunked route: nothing cube-sized to warm
                if math.prod(shape) * compute_dtype(cfg).itemsize >= staging.STAGED_MIN_BYTES:
                    staging.pool_for(dev)   # the pinned pieces the cube's upload takes
                hbm = device_memory_bytes(dev)
                use_kernel = resolve_use_kernel(cfg, int(shape[-1]), dev, want_residual)
                if hbm is not None and (2 * clean_working_set_bytes(shape, cfg, use_kernel)
                                        > hbm * HBM_USABLE_FRACTION):
                    return
                template_count = "launches_f64" if cfg.x64 else "launches"
                before = (fused_fit_moments.launches, getattr(build_template, template_count),
                          sparse_template_candidate.taken)
                with compile_scope(shape_bucket_label(shape)):
                    precompile_for(shape, cfg, want_residual, dev)
                th.launches = fused_fit_moments.launches - before[0]
                th.template_launches = getattr(build_template, template_count) - before[1]
                th.sparse_steps = sparse_template_candidate.taken - before[2]
        except Exception as exc:  # noqa: BLE001 — warm-up only; the real call raises
            th.error = exc

    th = threading.Thread(target=_run, daemon=True, name="ict-precompile")
    th.error = None
    th.launches = th.template_launches = th.sparse_steps = 0
    th.start()
    return th
