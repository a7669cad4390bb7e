"""Backend-agnostic iterative cleaning loop.

Copies of ``IterationInfo``, ``CleanResult``, ``LoopState`` and
``find_bad_parts`` (``iterative_cleaner_tpu/core/cleaner.py:31-196``,
``:458-477``) and a port of ``clean_cube`` (``:199-455``) with its routing:
in memory (stepwise or fused) or, for a cube beyond one device's memory,
sharded over this process's devices or the chunked streaming backend.  The
reference's iteration dynamics:

- weights feed back only through the template: each step's stats use the
  frozen original weights, while ``w_prev`` shapes the template;
- convergence is full-history cycle detection with the pre-loop weights in
  the history, so oscillating masks also terminate;
- ``loops`` records the stopping iteration.

The observability hooks are the JAX package's: ``iteration`` events with
the forensics record of each loop (per-diagnostic zap attribution under
``ICT_FORENSICS=1``, on every route: the stepwise backend's cube comes to
the host from the card, the fused loop's from the caller's host arrays),
a ``clean_route`` event and ``obs.memory.observe_route`` per route, and the
route's kernel build accounted to the cube's shape bucket.  The JAX
package's compile-cache bookkeeping has no counterpart: PyTorch does not
compile per shape.
"""

from __future__ import annotations

import contextlib
import sys
import warnings
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from iterative_cleaner_tpu_torch.backends.base import make_backend
from iterative_cleaner_tpu_torch.config import CleanConfig
from iterative_cleaner_tpu_torch.obs import events, forensics, tracing
from iterative_cleaner_tpu_torch.obs import memory as obs_memory
from iterative_cleaner_tpu_torch.obs.tracing import (
    StepTimer,
    compile_scope,
    shape_bucket_label,
)


#: Cubes above this size skip the advisory >1e17 magnitude scan.
PARITY_SCAN_MAX_BYTES = 4e9


@dataclass
class IterationInfo:
    index: int                 # 1-based loop counter (reference's `x`)
    diff_weights: int          # entries changed vs the previous weights
    rfi_frac: float            # zapped fraction after this iteration
    duration_s: float = 0.0    # host wall-clock of this iteration's step
    n_new_zaps: int = 0        # profiles newly zapped this iteration
    n_unzapped: int = 0        # profiles restored this iteration
    # Per-diagnostic vote counts among this iteration's zaps (std/mean/ptp/
    # fft) — filled only under ICT_FORENSICS=1 (obs/forensics.py: a host
    # replay of the oracle score pipeline; expensive, so asked-for).
    zaps_by_diagnostic: dict | None = None


@dataclass
class CleanResult:
    weights: np.ndarray        # final (nsub, nchan) weights (before bad-parts sweep)
    test_results: np.ndarray   # last iteration's outlier scores
    loops: int                 # stopping iteration (reference's `loops`)
    converged: bool            # True if the mask reached a fixed point / cycle
    iterations: list[IterationInfo] = field(default_factory=list)
    history: list[np.ndarray] = field(default_factory=list)
    residual: np.ndarray | None = None   # unweighted amp*t − D, dedispersed frame
    timed: bool = False                  # iterations carry host wall-clock laps
    termination: str = ""                # "fixed_point" | "cycle" | "max_iter"

    @property
    def rfi_frac(self) -> float:
        if self.iterations:
            return self.iterations[-1].rfi_frac
        return float((self.weights == 0).mean())

    def quality_summary(self) -> dict:
        """RFI data-quality facts of this clean's mask (obs/quality.py):
        zap fraction, per-channel/per-subint occupancy histograms,
        fully-zapped counts, termination reason.  Pre-sweep weights."""
        from iterative_cleaner_tpu_torch.obs import quality

        return quality.quality_summary(self.weights,
                                       termination=self.termination)


ProgressFn = Callable[[IterationInfo], None]


@dataclass
class LoopState:
    """Resumable state of the convergence loop: the weight history (cycle
    detection), per-loop records and the stopping bookkeeping.  ``start(w)``
    seeds the pre-loop weights into the history, as the reference seeds
    ``test_weights`` with them."""

    w_prev: np.ndarray
    history: list[np.ndarray]
    infos: list[IterationInfo] = field(default_factory=list)
    test_results: np.ndarray | None = None
    loops: int = 0
    converged: bool = False
    termination: str = ""

    @classmethod
    def start(cls, w_init: np.ndarray) -> "LoopState":
        w = np.asarray(w_init, dtype=np.float32)
        return cls(w_prev=w, history=[w.copy()])

    def advance(self, backend, progress: ProgressFn | None = None,
                timer: StepTimer | None = None) -> bool:
        """Run one iteration; True when the loop should stop (the new mask
        reproduced a mask in the history)."""
        x = len(self.infos) + 1
        test_results, new_w = backend.step(self.w_prev)
        self.test_results = np.asarray(test_results)
        new_w = np.asarray(new_w)

        info = _iteration_info(x, self.history[-1], new_w,
                               duration_s=timer.lap() if timer else 0.0)
        if forensics.attribution_enabled():
            # Read-only host replay of the oracle score pipeline — which
            # diagnostic voted for each of this iteration's zaps — with the
            # template weights (self.w_prev) the step ran with.
            info.zaps_by_diagnostic = forensics.attribute_from_backend(
                backend, self.w_prev, new_w)
        self.infos.append(info)
        if progress is not None:
            progress(info)
        if events.active():
            events.emit("iteration", **forensics.iteration_record(info))

        # Full-history cycle detection, pre-loop weights included.
        stop = any(np.array_equal(new_w, old) for old in self.history)
        self.history.append(new_w)
        self.w_prev = new_w
        if stop:
            self.loops = x
            self.converged = True
            self.termination = forensics.termination_reason(True, self.history)
        return stop

    def run(self, backend, max_iter: int,
            progress: ProgressFn | None = None, timed: bool = True) -> None:
        """Advance until convergence or ``max_iter`` total iterations."""
        timer = StepTimer() if timed else None
        while len(self.infos) < max_iter:
            if self.advance(backend, progress=progress, timer=timer):
                break
        if not self.converged:
            self.loops = max_iter
            self.termination = forensics.termination_reason(False, self.history)

    def result(self, residual: np.ndarray | None = None,
               timed: bool = False) -> CleanResult:
        return CleanResult(
            weights=self.history[-1].copy(),
            test_results=self.test_results,
            loops=self.loops,
            converged=self.converged,
            iterations=self.infos,
            history=self.history,
            residual=residual,
            timed=timed,
            termination=self.termination,
        )


def _iteration_info(
    index: int, prev_w: np.ndarray, new_w: np.ndarray, duration_s: float = 0.0
) -> IterationInfo:
    """The per-loop record the reference prints (diff vs previous weights,
    zapped fraction), plus the churn split."""
    return IterationInfo(
        index=index,
        diff_weights=int(np.sum(new_w != prev_w)),
        rfi_frac=float((new_w.size - np.count_nonzero(new_w)) / new_w.size),
        duration_s=duration_s,
        n_new_zaps=int(np.sum((new_w == 0) & (prev_w != 0))),
        n_unzapped=int(np.sum((new_w != 0) & (prev_w == 0))),
    )


def _parity_warnings(D, w0: np.ndarray, peak=None) -> None:
    """The two documented limits of mask parity with the numpy oracle.
    ``D`` is a host array, scanned here, or a tensor already on the device
    (the device preprocess's cube), whose magnitude comes from ``peak``
    (its :class:`..ops.preprocess.DevicePeak`; one fetch, which waits for
    the preprocess) or, without one, from ``ops.preprocess.cube_peak``."""
    if D.shape[-1] < 3:
        warnings.warn(
            "mask parity vs the numpy oracle is not guaranteed below 3 "
            "phase bins: numpy.ma computes a mixed f32/f64 diagnostic "
            "pipeline and a centred 2-bin profile is structurally tied, so "
            "the device pipeline's MAD/tie classifications can flip at any "
            "uniform precision — f32 default and --x64 alike",
            stacklevel=3)
    host = isinstance(D, np.ndarray)
    if (D.size if host else D.numel()) == 0 or D.nbytes > PARITY_SCAN_MAX_BYTES:
        return
    # Beyond ~sqrt(f32max) the oracle's mixed pipeline bifurcates (its f32
    # fit overflows <t,t> while its f64-promoted ma.std stays finite).  Only
    # finite magnitudes warn: ±inf/NaN poison both pipelines alike.  The
    # host scan is two passes over the cube, hence the size cap.
    with tracing.phase("clean_parity_scan"):
        if host:
            lo, hi = float(np.nanmin(D)), float(np.nanmax(D))
        else:
            if peak is None:
                from iterative_cleaner_tpu_torch.ops.preprocess import cube_peak

                peak = cube_peak(D)
            lo, hi = peak.read()
        magnitude = max(-lo, hi) * max(
            1.0, abs(float(np.nanmax(w0))), abs(float(np.nanmin(w0))))
    if np.isfinite(magnitude) and magnitude > 1e17:
        warnings.warn(
            f"data magnitude ~{magnitude:.1e} approaches the f32 dynamic "
            "range (squared residuals overflow beyond ~1.8e19, and the "
            "oracle's mixed f32/f64 pipeline bifurcates there); mask "
            "parity is not guaranteed at any device precision — inspect the "
            "input for corruption",
            stacklevel=3)


def clean_cube(
    D: np.ndarray,
    w0: np.ndarray,
    cfg: CleanConfig,
    progress: ProgressFn | None = None,
    want_residual: bool = False,
    device="cuda",
    peak=None,
) -> CleanResult:
    """Run the iterative cleaner on a preprocessed cube.

    D: (nsub, nchan, nbin) float32 — pscrunched, baseline-removed,
    dedispersed: a host array, or for the torch backend's in-memory routes
    a tensor already on ``device`` (the device preprocess's cube, with its
    ``peak``: ``ops/preprocess.preprocess`` with a device), which those
    routes use as it is.  w0: (nsub, nchan) float32 original weights.  With
    ``cfg.x64`` the torch routes compute in float64.  ``device``
    is where the torch backend runs (default the card; raises when there is
    none); the numpy oracle ignores it.

    Routing (torch backend): an explicit ``cfg.chunk_block`` streams the
    cube through the chunked backend in blocks of that many subints;
    otherwise, with ``cfg.auto_shard``, a cube whose estimated working set
    exceeds one device's memory is cleaned over this process's devices
    when it has more than one (``parallel/autoshard.maybe_clean_sharded``:
    its subints over ``sp``; no per-loop ``iterations`` or ``history``),
    and where that declines (one card, ``want_residual``, ``x64``) streams
    with the block size ``parallel/autoshard.chunk_block_subints`` gives.
    The decision is made here, before the run, and announced on stderr; an
    out-of-memory error on the in-memory route is never retried elsewhere.
    With ``cfg.fused`` the
    in-memory loop runs on the device and the per-loop ``iterations`` (and
    ``progress`` calls) are derived afterwards from its mask history, with
    ``duration_s`` 0.
    """
    chunk_block, chunk_why = None, ""
    if cfg.backend == "torch":
        _parity_warnings(D, w0, peak)
        if cfg.chunk_block:
            # The operator's override: stream whatever the estimate says.
            chunk_block, chunk_why = int(cfg.chunk_block), "--chunk_block override"
        elif cfg.auto_shard:
            from iterative_cleaner_tpu_torch.backends.torch_backend import resolve_device
            from iterative_cleaner_tpu_torch.parallel import autoshard
            from iterative_cleaner_tpu_torch.parallel.autoshard import chunk_block_subints

            with compile_scope(shape_bucket_label(D.shape)):
                sharded = autoshard.maybe_clean_sharded(D, w0, cfg, want_residual,
                                                        resolve_device(device))
            if sharded is not None:
                if events.active():
                    events.emit("clean_route", route="sharded", shape=list(D.shape))
                obs_memory.observe_route("sharded")
                return sharded
            chunk_block = chunk_block_subints(D.shape, cfg, resolve_device(device),
                                              want_residual)
            chunk_why = f"cube {tuple(D.shape)} exceeds device memory"
    if chunk_block is not None:
        notes = []
        if cfg.fused:
            notes.append("fused loop runs stepwise on this path")
        if cfg.x64:
            # The JAX package warns here that its per-block sums reorder the
            # f64 template; the port continues one sum in the oracle's order.
            notes.append("x64: the template continues block by block in the "
                         "in-memory order, so the f64 sum is the in-memory "
                         "path's bit for bit")
        note = f" ({'; '.join(notes)})" if notes else ""
        print(f"chunked clean: {chunk_why}; streaming {chunk_block}-subint "
              f"blocks through the device{note}", file=sys.stderr)
    if want_residual:
        # The kernel never materialises the residual.  A residual must come
        # from a dense template (bit-exact output; the sparse update's
        # envelope is documented for scores only); the chunked route keeps
        # the incremental template, as its residual() rebuilds densely.
        cfg = cfg.replace(kernel=False)
        if chunk_block is None:
            cfg = cfg.replace(incremental_template=False)

    bucket = shape_bucket_label(D.shape)
    if cfg.fused and chunk_block is None:
        from iterative_cleaner_tpu_torch.backends.torch_backend import run_fused

        if events.active():
            events.emit("clean_route", route="fused", shape=list(D.shape))
        with compile_scope(bucket):
            out = run_fused(D, w0, cfg, want_residual=want_residual, device=device)
        obs_memory.observe_route("fused")
        test, w_final, loops, done, _x, history = out[:6]
        history = list(history)
        # The per-loop records come from the fetched mask history, after
        # the loop: the device loop itself makes no extra host sync.
        infos = []
        for i in range(1, len(history)):
            info = _iteration_info(i, history[i - 1], history[i])
            if forensics.attribution_enabled():
                info.zaps_by_diagnostic = forensics.attribute_zaps(
                    D, w0, history[i - 1], history[i], cfg)
            infos.append(info)
            if progress is not None:
                progress(info)
            if events.active():
                events.emit("iteration", **forensics.iteration_record(info))
        return CleanResult(
            weights=w_final, test_results=test, loops=loops, converged=done,
            iterations=infos, history=history,
            residual=out[6] if want_residual else None,
            termination=forensics.termination_reason(done, history))

    if chunk_block is not None:
        from iterative_cleaner_tpu_torch.parallel.chunked import ChunkedTorchCleaner

        if events.active():
            events.emit("clean_route", route="chunked", shape=list(D.shape),
                        block=chunk_block, why=chunk_why)
        backend = ChunkedTorchCleaner(D, w0, cfg, block=chunk_block,
                                      keep_residual=want_residual, device=device)
    else:
        if events.active():
            events.emit("clean_route",
                        route="stepwise" if cfg.backend == "torch" else "numpy",
                        shape=list(D.shape))
        backend = make_backend(D, w0, cfg, device=device)
    state = LoopState.start(w0)
    # The device routes' loop; the numpy oracle (an audit's replay) is not.
    loop = tracing.phase("clean_loop") if cfg.backend == "torch" else contextlib.nullcontext()
    with compile_scope(bucket), loop:
        state.run(backend, cfg.max_iter, progress=progress)
    if cfg.backend == "torch":
        obs_memory.observe_route("chunked" if chunk_block is not None else "stepwise")
    residual = None
    if want_residual:
        r = backend.residual()
        residual = None if r is None else np.asarray(r)
    return state.result(residual=residual, timed=True)


def find_bad_parts(
    weights: np.ndarray, cfg: CleanConfig
) -> tuple[np.ndarray, int, int]:
    """Whole-subint / whole-channel sweep.  Both passes compute their zapped
    fraction from the same pre-sweep snapshot, with a strictly greater
    comparison.  Returns (new_weights, n_bad_subints, n_bad_channels)."""
    snapshot = np.asarray(weights)
    nsub, nchan = snapshot.shape
    out = snapshot.copy()

    bad_subints = (1.0 - np.count_nonzero(snapshot, axis=1) / float(nchan)) > cfg.bad_subint
    out[bad_subints, :] = 0.0
    bad_channels = (1.0 - np.count_nonzero(snapshot, axis=0) / float(nsub)) > cfg.bad_chan
    out[:, bad_channels] = 0.0
    return out, int(bad_subints.sum()), int(bad_channels.sum())
