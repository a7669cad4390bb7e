#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py      # needs one CUDA card; about 12 minutes on an H100

Phases, in order, each with its seconds; any failure raises and the script
exits non-zero:

1. environment — torch / CUDA versions and the card's name and power limit
   (``nvidia-smi``); no CUDA device is a failure;
2. build — every CUDA kernel of the main path from the checkout's sources
   (``csrc/fused_fit_moments.cu``, ``csrc/ordered_template.cu``), one nvcc
   per source, started together;
3. kernel vs plain — each kernel's wrapper against its plain PyTorch version
   on the card.  ``fused_fit_moments`` at the main path's shape
   (256 x 1024 x 1024, BASELINE.json config #2), at the chunked route's
   block (32 x 1024 x 1024), at a rank's block (128 x 1024 x 1024) and at
   ragged small shapes, with fills, a pulse
   region, a zero template and pre-zapped profiles, on the load path its
   launch plan takes (4-byte copies for an odd pitch and for a base one
   float into its buffer), up to the widest profile a block takes; the
   4-byte path forced on an aligned cube and one block of one stage per
   tile bit-identical to the plan's launch; a north-star chunk slab
   (as the chunked route cuts 1024 x 4096 x 1024 on a 32 GB card); the
   launch over a leading archive axis at ragged shapes and at
   8 x 256 x 1024 x 1024, each archive bit-identical to the 3-D launch on
   it alone; each timed as a call with its launch (``ms``, as every PR
   timed it) and as device time of launches back to back (``device_ms``),
   beside its byte bound.  ``ordered_template``
   bit for bit on both load paths (16-byte copies; 4-byte copies where the
   pitch or the base is not 16-byte aligned) at ragged shapes (zero weights,
   an inf and a NaN sample, fewer profiles than one stage, a partial bin
   group), a sum continued block by block (from an unaligned base too), a
   batch, the sweep's stride-0 pair axis in one launch, and the ranks' chain
   (LOFAR in two 128-subint blocks with a leading archive axis, the second
   continuing the first) against the one-card build; the chain probe
   (the card's time per dependent float32 add).  Each is timed against its
   plain version, the least time the card could take (bytes or operations
   over its published peak; for the template also the chain of dependent
   adds) and, for the template, cuBLAS's matrix-vector product; the
   template also on the online slab (32 x 1024 x 1024), over 8 LOFAR cubes
   and over the sweep's 9 pairs, each beside cuBLAS.  The template's float64
   instantiation (the ``--x64`` routes) the same way: bit for bit its plain
   version in float64 on both load paths at ragged shapes, a continued sum
   and a batch; the float64 chain probe; at LOFAR in float64 beside its byte
   bound (twice the float32 bytes), its chain floor and cuBLAS's float64
   matrix-vector product.  The device preprocess (``csrc/preprocess.cu``:
   dedispersion, the float64 total profile, the baseline window, the
   baseline removal and the peak) at LOFAR on the seed-42 raw archive, bit
   for bit with the native host pass and with its plain twin, timed a call
   and back to back, each kernel's device time, beside its byte bound and
   the float64 total's chain floor (the float64 chain probe's time per add);
4. main path — writes the seed-42 synthetic 256 x 1024 x 1024 archive,
   cleans it through ``iterative_cleaner_tpu_torch.cli.main`` with the
   defaults (torch backend, cuda, auto kernel, incremental template, the
   warm-up thread), checks the launches of both kernels (the warm-up's
   once each; ``fused_fit_moments`` once per loop, ``ordered_template`` once
   per dense template build), that the final mask is identical to the
   port's numpy oracle and to its kernel-off route on the same preprocessed
   cube, and that the last scores drift from the oracle's within the 5e-5
   envelope; the drift split by layer (kernel or plain route, the FFT
   diagnostic in pieces or as one transform, the template in the oracle's
   order or as one matrix-vector product, TF32's flags); times each device
   layer of one iteration, beside the times with a thread per template
   chain;
5. obs — on phase 4's archive written as ``.ictb`` (the NPZ writer's zlib
   is phase 4's to time), ``cli.main`` with ``--telemetry``,
   ``--trace``, ``--audit`` and ``--report`` under ``ICT_FORENSICS=1``: the
   event log (the run's spans, ``job_submitted``, ``clean_route``, one
   ``iteration`` per loop with its per-diagnostic zap attribution), the
   audit (mask identical, drift within the bound) and the quality summary
   in the report, the capture's device kernels (``fused_fit_moments`` loops
   + 1 times) and host spans, the device's busy share over the loop's
   window with its top operations and idle gaps; the fused route's host
   syncs with telemetry off and on; a bounded capture around ``run_fused``
   (listed; an overlapping start refused); the device-memory view; the
   watchdog silent on a live card; the metrics exposition through the
   strict parser; the CLI's wall-clock with and without telemetry and
   forensics;
6. fused loop — ``run_fused`` on the same cube: mask, loops, history
   identical to the CLI's and the oracle's, one kernel launch per
   iteration; ``fused_clean`` on the cube already on the card makes at most
   one host sync per iteration plus the final fetch
   (``torch.cuda.set_sync_debug_mode``); wall-clocks beside the stepwise
   loop's;
7. chunked route — ``clean_cube`` with ``chunk_block=32`` (8 blocks): the
   announcement, mask and loops identical to the oracle, launches = blocks x
   iterations, template passes, host→device GB/s and the uploader's
   overlap; pinned staging against registering the host cube with
   ``cudaHostRegister``;
8. CLI routes — ``cli.main`` with ``--fused`` and with ``--chunk_block 8``
   on a small archive (32 x 128 x 256): masks identical to the oracle;
9. peak model — ``max_memory_allocated`` of whole cleans, kernel and plain
   route, stepwise and fused, at 256 x 1024 x 1024 and 2048 x 1024 x 128
   (same bytes, 8x the profiles), fitted as cubes plus bytes per profile and
   held against ``parallel/autoshard``'s estimate; every fused and stepwise
   mask there identical to the oracle / to each other; where cuFFT's
   workspace lives;
10. warm-up — iteration 1 of a clean in a fresh process, without and with
   the warm-up thread first;
11. batch — (a) ``sharded_clean`` over 8 LOFAR cubes in host memory
   (phase 4's, and 7 made with other seeds and RFI loads; 3 of them
   written as ``.ictb`` archives and preprocessed from those, phase 14's
   jobs) in one dispatch:
   each archive's mask, loops and converged equal ``run_fused`` on it alone
   (dense template), archive 0's the oracle's, one launch per batch
   iteration, at most one host sync per iteration, the peak under the
   batched estimate, wall-clock beside the 8 single walls; the same bucket
   on a 9 GB ``ICT_HBM_BYTES`` budget in dispatches of 3, each under the
   budget; (b) ``cli.main`` with ``--sharded_batch``, ``--stream`` and
   ``--resume`` on four 8 x 1024 x 1024 archives, one 4 x 1024 x 1024 and
   a missing path (``nsub`` cut for the NPZ writer, the cut printed):
   rc 1, oracle-identical masks, clean.log lines, skips, launches per
   bucket;
12. sweep — ``models/sweep.sweep_thresholds`` on phase 4's cube, a 3 x 3
   grid (chanthresh, subintthresh in {4, 5, 6}) in one dispatch: every
   point's mask, loops and converged equal the solo clean with its
   thresholds, (5, 5) the oracle's, no ``fused_fit_moments`` launch (the
   plain route, as in the JAX package), one ``ordered_template`` launch per
   batched iteration (the pair axis in one launch), the peak under the
   sizing's estimate, the grid's wall beside the 9 solo walls; the same grid on a
   20 GB ``ICT_HBM_BYTES`` budget (dispatches of 2, 2, 2, 2, 1) and on 2 GB
   (beneath one pair: solo cleans through the chunked cleaner), the same
   points; ``cli.main --sweep`` on a 32 x 1024 x 1024 archive, its
   ``_sweep.npz`` equal to the library's points;
13. follow — ``online.OnlineSession`` on the card fed phase 4's raw archive
   in 8 blocks of 32 subints: each block's latency (its host share and the
   uploader's set-up) and kernel launches (slabs x iterations); the
   session's counters (8 blocks ingested, 8 ``online_block`` phases); the
   alerts identical to the kernel-off session's; a pass that dies rolls
   back; ``finalize`` identical to the oracle; then
   ``online.follow_archive`` on a 16 x 1024 x 1024 archive grown in 4
   atomic rewrites of 4 subints (4 alerts, the oracle's mask) and one
   ``python -m iterative_cleaner_tpu_torch --follow`` process on the
   complete file;
14. service — the serving replica (``service/``) on the card.  The native
   runtime (``native/ict_native.cc``, built with g++ on this host; its build
   log on failure): the seed-42 archive preprocessed natively, bit for bit
   phase 4's numpy preprocess, both host times printed.  A
   ``CleaningService`` (backend torch, bucket cap 4, port 0) takes phase
   4's archive and the batch phase's archives 101-103 as ``.ictb`` jobs
   over HTTP: every job done and served ``sharded`` in one coalesced
   dispatch of 4, masks, loops and converged identical to the batch
   phase's, no oracle fallback, no demotion, every preprocess native; an
   audited 4 x 16 x 64 job (``{"audit": true}``, flushed by ``POST
   /drain``) holds against the oracle on ``/healthz``.  Alongside, a
   session over HTTP on the raw archive's first 4 blocks of 32 subints
   (the block codec), one block posted while the job bucket dispatches:
   each alert the follow phase's, the finish the fused clean of the same
   subints, latency per block.  Then ``serve --smoke`` in process
   (``"smoke": "ok"``, backend torch).  Each kernel's launches by host
   thread: the dispatch worker (``service``), the session's request
   threads (``service_session``), the smoke's replica (``serve_smoke``),
   each above 0, their sum the wrapper's count;
15. fleet — the fleet tier (``fleet/``, ``campaign/``, ``proving/``) on the
   card.  A ``FleetRouter`` in front of two in-process replicas on
   ``cuda`` (``a`` parks its cubes: deadline 3600 s, bucket cap 8; ``b``
   drains: bucket cap 2, coalesce 2) takes phase 14's four LOFAR ``.ictb``
   jobs through ``POST /jobs``; once ``a`` holds its cubes parked and
   ``b`` has served its own, ``a`` stops and the router fails its jobs
   over: every job done exactly once, masks, loops and converged the
   batch phase's, no oracle fallback or demotion, ``/healthz`` backend
   torch, merged ``/fleet/metrics`` counters equal to the per-replica
   sums, both kernels launched on the replicas' dispatch threads, the
   peaks under the card's memory and the allocated bytes back within
   64 MiB once both replicas stop.  Against its router: ``explain`` (all
   seven planes), ``trends``, ``campaign`` of the same four archives (all
   from the fleet cache, no new completion, a QA roll-up and a cost row)
   and ``tools_torch/fleet_top.py --json``.  Beside it, started with the
   phase, ``serve-fleet --smoke``, ``serve-fleet --smoke --autoscale
   act`` and ``prove --smoke``, each the port's CLI in a process of its
   own on the card; the phase within 120 s;
16. CLI surface — ``tests/fake_psrchive.py`` loaded by path as the
   ``psrchive`` module (the host has no PSRCHIVE bindings; printed, and
   for this phase only): a 2-pol Coherence ``.ar`` of 32 x 128 x 256
   through ``cli.main`` with the defaults on cuda — the mask the oracle's,
   only the zapped cells rewritten (``set_weight``, no profile), both
   kernels launched; ``-z`` on it (the PNG under the reference name where
   matplotlib imports, else the JAX driver's failure naming matplotlib,
   printed); ``--x64`` through the CLI on the same archive as NPZ, stepwise
   and ``--chunk_block 8``; then ``--x64`` at LOFAR from phase 4's cube:
   stepwise, fused and ``chunk_block=32`` — masks, loops and converged the
   oracle's, the score drift against the oracle and the float32 route, the
   peak under the estimate in 8-byte elements, no ``fused_fit_moments``
   launch and one float64 template launch per dense build;
17. contracts — the port's static analysis suite on the card:
   ``tools_torch/ict_lint.py --source --races`` in a process of its own
   (rc 0 on this host's Python), then the route contracts
   (``analysis/contracts.py``) on cuda, every entry point of the stepwise,
   fused, chunked and batch routes, and the ranks route on a one-rank
   ``gloo`` group (its collectives staged through the host), holding the
   card once and twice (``rank_devices``: one ``sp=2`` slice), with the
   kernel route off and on, on the
   tiny cube and at 256 x 1024 x 1024 on phase 4's cube (the chunked route in
   32-subint blocks, a batch of 2 LOFAR cubes): each run's CUDA syncs
   (``torch.cuda.set_sync_debug_mode``) equal to the ledger's reads plus
   uploads for the iterations it ran, no 64-bit float, and
   ``sparse_template_candidate`` (``torch.nonzero_static``) at LOFAR width
   without a sync; both kernels launched; the phase within 30 s;
18. ranks — the multi-process tier, ranks in child processes sharing
   cuda:0 (``parallel/mesh.initialize_distributed``, each with a timeout),
   each memory-mapping the cubes the batch phase wrote as ``.npy`` and
   uploading only its device blocks: (a) two ``gloo`` ranks,
   ``sharded_clean_single`` of phase 4's cube over ``sp=2``, one device a
   rank — the oracle's mask, loops and converged, score drift within 5e-5,
   rank 0's syncs against the route contract
   (``ROUTE_HOST_READS['ranks']``); the same two processes, each holding
   cuda:0 twice (``initialize_distributed(devices=[...])``, logical
   devices), then run (b) ``ranks2x2_sp4``, the cube over 2 ranks x 2
   devices at ``sp=4`` (the JAX package's mesh over two processes), rank
   0's syncs against ``ROUTE_HOST_READS['rank_devices']``, and (c)
   ``ranks2x2_dp2_sp2``, the batch phase's seeds 42 and 101 at ``dp=2 x
   sp=2``, a whole slice on each rank; (d) four ``gloo`` ranks, ``dp=2 x
   sp=2``, seeds 42 and 101; (e) one ``nccl`` rank, (a) at ``sp=1`` through
   the device-tensor path, also held to the contract; two ``nccl`` ranks on
   one card refused (NCCL's error printed); (f) two ``gloo`` ranks, each
   holding cuda:0 twice, running ``cli.main`` over the service phase's
   three LOFAR ``.ictb`` archives — slices ``[p0, p2]`` and ``[p1]``,
   ``r.json.p0`` and ``r.json.p1`` and no ``r.json``, the batch phase's
   masks — then the same with ``--sharded_batch``, each rank batching its
   slice on its own ``dp=2`` mesh over its two devices.  Every rank's
   result identical; the batch phase's masks and scores bit for bit; each
   kernel's launches on every rank its device blocks x iterations (by
   path: ``sharded_sp2``, ``ranks2x2_sp4``, ``ranks2x2_dp2_sp2``,
   ``dp2_sp2``, ``nccl_sp1``, ``cli_ranks``, ``cli_ranks_sharded_batch``);
   no peer copy; the staged copies as the collectives' order predicts;
   per run the backend, ranks, positions, wall, the template chain's time
   and the bytes handed and staged per iteration; the phase within 120 s;
19. local mesh — the mesh over one process's devices
   (``parallel/mesh.make_mesh(devices=...)``), on this one card as logical
   devices: ``autoshard.default_devices`` replaced by ``[cuda:0, cuda:0]``
   for the phase's reroutes and ``make_mesh(devices=[cuda:0] * 4)`` for its
   batch (no environment variable or flag).  ``make_mesh()`` with no
   devices gives the one card, so every other phase's route is unchanged;
   (a) phase 4's cube through ``clean_cube`` with its defaults on a 2 GB
   ``ICT_HBM_BYTES``: the reroute's announcement, ``sp=2``, the oracle's
   mask, loops and converged, scores bit for bit the batch phase's
   one-card batched route, the same clean's syncs against the route
   contract (``ROUTE_HOST_READS['local']``); (b) the batch phase's seeds 42
   and 101 (the service phase's ``.ictb`` files) through
   ``clean_directory_batch`` on ``dp=2 x sp=2``: the batch phase's masks,
   loops, converged and scores bit for bit; (c) the same cube with
   ``--x64`` and with a residual: each declines to chunked, the oracle's
   mask.  Each clean's wall, launches (one per device block and
   iteration), bytes handed between devices per iteration and peak on the
   card (the whole cube: the logical devices share it);
20. fuzz — ``tools_torch/fuzz_sweep.py`` on cuda, 16 float32 seeds and 8
   ``--x64`` seeds from 1000 in two processes side by side: rc 0, every
   mode identical to the oracle, the per-mode drift and sparse-update
   counts printed; ``tools_torch/replay_repro.py`` on cuda on a bundle with
   one flipped served cell: cleared, rc 0;
21. sparse template — the incremental template's sparse update (from
   iteration 2, ``T_prev + sum (Δw) * profile`` over at most 512 flipped
   profiles) at full width.  LOFAR-quiet: ``make_archive(seed=42,
   rfi=RFISpec(n_bad_subints=0))`` at 256 x 1024 x 1024, phase 4's archive
   without its broadband burst, written as ``.ictb`` and run through the
   numpy oracle by a process started with the script.  ``cli.main`` with
   the defaults (the main path: stepwise, kernel, warm-up), ``--fused``,
   ``--chunk_block 32``, ``--no_kernel`` and ``--x64``, each also with
   ``--no_incremental_template``: the flips before each iteration (from
   iteration 2 at most 512, at least one iteration 2), every iteration's
   mask, loops, converged and termination the oracle's, the score drift
   within 5e-5, the sparse updates (``sparse_template_candidate.taken``,
   the warm-up's apart) and ``ordered_template`` launches (its float64
   instantiation under ``--x64``; template passes x blocks chunked) as the
   budget rule predicts, ``fused_fit_moments`` once per iteration (blocks
   x iterations chunked, none kernel-off or ``--x64``), sparse and dense
   masks identical with their score difference printed.  An
   ``OnlineSession`` fed LOFAR-quiet in 8 blocks of 32 subints beside one
   with the incremental template off (host inputs shared): each pass's
   flips, sparse updates and dense passes by the rule, a sparse update in a
   pass past the first, alerts identical, both finalizes the oracle's.
   ``sparse_template_candidate`` (gather, product, finite check) timed
   against the dense ``build_template`` it replaces (CUDA events, median
   of 10), at LOFAR-quiet's first step and at the quiet north star's
   (1024 x 4096 x 1024, seed 5, no bad channel or burst, made on the card);
   that cube from host memory in memory and on a 32 GB budget, sparse and
   dense: masks and loops identical, the score differences printed (the
   oracle does not run at that size within the script's limit);
22. north star — a seeded, preprocessed 1024 x 4096 x 1024 cube
   (BASELINE.json config #5) made on the card (``nsub`` cut, and the cut
   printed, where the host cannot hold ~2.5 cubes); the template over the
   whole cube in one launch, timed beside cuBLAS's matrix-vector product,
   against its sum continued over blocks
   whose offsets fit in 31 bits, bit for bit; the kernel over the
   whole cube (4.3e9 elements) against its plain version on slabs at its
   start, across element 2^31 and at its end; then, from host memory, the
   automatic route on this card and on a 32 GB budget (``ICT_HBM_BYTES``,
   which routes it chunked), each with its peak device memory held against
   the estimate or the budget, wall-clock and per-iteration times (no
   reroute over devices on this one-card host); masks identical;
23. one JSON line of the kernels (launches per path; the template kernel's
   per phase, each phase's count above 0; its float64 instantiation its own
   entry), then ``{"ok": true, "device": ...}`` last.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import multiprocessing as mp
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bandwidth and
# float32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
#: float64 outside the tensor cores (the same data sheet).
PEAK_F64_FLOPS = 34e12

LOFAR = (256, 1024, 1024)     # BASELINE.json config #2: nsub x nchan x nbin
ONLINE_SLAB = (32, 1024, 1024)  # the follow phase's provisional-pass slab at LOFAR
NORTH_STAR = (1024, 4096, 1024)  # BASELINE.json config #5
T_START = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T_START:7.1f}s] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


@contextlib.contextmanager
def _recording(module, name: str):
    """Replace ``module.<name>`` (a function or a class) for the ``with``
    block by a wrapper that keeps each object it returns or makes; yields
    that list."""
    orig = getattr(module, name)
    made = []
    if isinstance(orig, type):
        class Recorded(orig):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                made.append(self)
        wrapper = Recorded
    else:
        def wrapper(*args, **kwargs):
            out = orig(*args, **kwargs)
            made.append(out)
            return out
    setattr(module, name, wrapper)
    try:
        yield made
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def _stderr_to(buf: io.StringIO):
    """Capture stderr into ``buf`` and echo it to the log afterwards."""
    try:
        with contextlib.redirect_stderr(buf):
            yield buf
    finally:
        for line in buf.getvalue().splitlines():
            log(f"  stderr: {line}")


@contextlib.contextmanager
def _fd_stderr(path: str):
    """File descriptor 2 into ``path`` for the ``with`` block: what C++
    writes there (Kineto's messages) as well, which :func:`_stderr_to`
    does not see.  Yields a list that holds the lines once the block has
    ended; they are echoed to the log."""
    lines: list[str] = []
    sys.stderr.flush()
    saved = os.dup(2)
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    os.dup2(fd, 2)
    os.close(fd)
    try:
        yield lines
    finally:
        sys.stderr.flush()
        os.dup2(saved, 2)
        os.close(saved)
        with open(path, errors="replace") as fh:
            lines.extend(fh.read().splitlines())
        for line in lines:
            log(f"  stderr (fd 2): {line}")


@contextlib.contextmanager
def _hbm_budget(nbytes):
    """``ICT_HBM_BYTES`` set to ``nbytes`` for the ``with`` block."""
    saved = os.environ.get("ICT_HBM_BYTES")
    os.environ["ICT_HBM_BYTES"] = str(int(nbytes))
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("ICT_HBM_BYTES", None)
        else:
            os.environ["ICT_HBM_BYTES"] = saved


def phase_environment():
    import torch

    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: no CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    from iterative_cleaner_tpu_torch.utils.device_probe import init_watchdog

    with init_watchdog("chip smoke cuda init"):
        log(f"device 0: {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} visible")
    return card


#: The kernel sources of the main path (csrc/<stem>.cu).
KERNEL_STEMS = ("fused_fit_moments", "ordered_template", "preprocess")


def phase_build():
    """Every kernel of the main path from the checkout's sources, one nvcc
    per source, all started together."""
    from iterative_cleaner_tpu_torch.ops import cuda_build

    def build(stem):
        t0 = time.perf_counter()
        return cuda_build.build(stem), time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(KERNEL_STEMS)) as pool:
        built = list(pool.map(build, KERNEL_STEMS))
    for stem, (path, secs) in zip(KERNEL_STEMS, built):
        log(f"built {path.name} in {secs:.2f}s")
        for line in cuda_build.build_log(stem).splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas: {line.strip()}")


def _inputs(shape, gen, *, prezap=0.01, zero_template=False, offset=0):
    """A random cube (``offset`` floats into its buffer), its weights with a
    share ``prezap`` zapped, and its template."""
    import torch

    from iterative_cleaner_tpu_torch.ops.template import build_template

    nsub, nchan, nbin = shape
    D = torch.randn(nsub * nchan * nbin + offset, generator=gen, device="cuda",
                    dtype=torch.float32)[offset:].view(shape)
    w0 = 0.8 + 0.4 * torch.rand((nsub, nchan), generator=gen, device="cuda")
    w0[torch.rand((nsub, nchan), generator=gen, device="cuda") < prezap] = 0.0
    t = (torch.zeros(nbin, device="cuda") if zero_template
         else build_template(D, w0).contiguous())
    return D, t, w0


def _time_ms(fn, runs: int) -> float:
    """Median of ``runs`` CUDA-event timings after one warm-up call, each
    around one call: the host's time to launch is in it."""
    import torch

    fn()
    torch.cuda.synchronize()  # ict: backend-init-ok(phase 1 made CUDA live)
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def _device_ms(fn, runs: int) -> float:
    """Device milliseconds a call: ``runs`` calls back to back, queued behind
    a spin of the card long enough for the host to enqueue them all, between
    two CUDA events — the host's time to launch is not in it."""
    import torch

    fn()
    torch.cuda.synchronize()  # ict: backend-init-ok(phase 1 made CUDA live)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2_000_000 * runs)
    a.record()
    for _ in range(runs):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / runs


#: Phase 3's tolerances for the fit/moments kernel against its plain
#: version (the f32 sums run in another order).
FIT_TOL = {"centred": (1e-5, 1e-5), "mean": (1e-5, 1e-6), "std": (1e-5, 1e-6),
           "ptp": (1e-5, 1e-5)}
#: The main path's score drift from the oracle on the card with the first
#: fit/moments kernel (one block of 4 warps per 4 profiles, one sum a lane).
FIRST_KERNEL_DRIFT = 1.0188e-5


def _hold_fit(name, got, want, w0) -> float:
    """``got`` against the plain version's ``want`` within FIT_TOL, zapped
    profiles (w0 == 0) exactly 0; returns the largest |difference| over
    finite entries."""
    import torch

    err = 0.0
    for key, g, w in zip(FIT_TOL, got, want):
        rtol, atol = FIT_TOL[key]
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol, equal_nan=True,
                                   msg=lambda m, k=key, n=name: f"{n}: {k}: {m}")
        fin = torch.isfinite(w)
        if fin.any():
            err = max(err, float((g[fin] - w[fin]).abs().max()))
    zapped = w0 == 0
    for key, g in zip(("centred", "mean", "std"), got):
        check(bool((g[zapped] == 0).all()), f"{name}: {key} not exactly 0 at zapped profiles")
    return err


def _fit_timing(label, narch, shape, fn, plain, runs) -> dict:
    """The kernel's time a call with the host's launch in it (``ms``:
    ``_time_ms``, as the main path meets it and as every earlier PR timed
    it), its device time a launch (``device_ms``: ``_device_ms``, launches
    back to back) and the plain version's (None: not timed), each share
    and rate against the byte bound."""
    call_ms = _time_ms(fn, runs)
    device_ms = _device_ms(fn, runs)
    plain_ms = None if plain is None else _time_ms(plain, max(3, runs // 4))
    bound_ms, bound_by, nbytes = _kernel_bound_ms(narch, shape)
    log(f"fused_fit_moments {label}: ms={call_ms:.4f} a call ({bound_ms / call_ms:.1%} of the "
        f"bound, {nbytes / (call_ms * 1e-3) / 1e12:.3f} TB/s) device_ms={device_ms:.4f} "
        f"({bound_ms / device_ms:.1%}, {nbytes / (device_ms * 1e-3) / 1e12:.3f} TB/s) "
        f"plain_ms={plain_ms} bound_ms={bound_ms:.4f} ({nbytes / 1e9:.3f} GB, {bound_by})")
    return {"shape": [narch, *shape] if narch > 1 else list(shape), "ms": call_ms,
            "device_ms": device_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_share": bound_ms / call_ms,
            "device_bound_share": bound_ms / device_ms,
            "tb_per_s": nbytes / (call_ms * 1e-3) / 1e12,
            "device_tb_per_s": nbytes / (device_ms * 1e-3) / 1e12}


def phase_kernel_parity():
    """fused_fit_moments (CUDA) vs fused_fit_moments_plain on the card."""
    import dataclasses

    import torch

    from iterative_cleaner_tpu_torch.ops import fused_kernels as fk
    from iterative_cleaner_tpu_torch.parallel import autoshard

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    region = (0.25, 40.0, 90.0)
    # (name, shape, valid, pulse region, the load path the plan takes, _inputs keywords)
    cases = [
        ("lofar, valid", LOFAR, True, (0.0, 0.0, 1.0), "aligned", {}),
        ("lofar, raw maps", LOFAR, False, (0.0, 0.0, 1.0), "aligned", {}),
        ("32x1024x1024 (a chunked block), valid", (32, 1024, 1024), True,
         (0.0, 0.0, 1.0), "aligned", {}),
        ("128x1024x1024 (a rank's block, sp=2 at LOFAR), valid", (128, 1024, 1024), True,
         (0.0, 0.0, 1.0), "aligned", {}),
        ("5x33x100, raw maps", (5, 33, 100), False, (0.0, 0.0, 1.0), "aligned", {}),
        ("5x33x100, valid", (5, 33, 100), True, (0.0, 0.0, 1.0), "aligned", {}),
        ("8x128x96, valid, pulse region", (8, 128, 96), True, region, "aligned", {}),
        ("8x64x256, pulse region", (8, 64, 256), False, region, "aligned", {}),
        ("16x32x4096, valid", (16, 32, 4096), True, (0.0, 0.0, 1.0), "aligned", {}),
        ("8x64x256, zero template", (8, 64, 256), True, (0.0, 0.0, 1.0), "aligned",
         {"zero_template": True}),
        ("8x64x257, pre-zapped 20%", (8, 64, 257), False, (0.0, 0.0, 1.0), "unaligned",
         {"prezap": 0.2}),
        ("16x40x64 one float into its buffer (an unaligned base), valid", (16, 40, 64), True,
         (0.0, 0.0, 1.0), "unaligned", {"offset": 1}),
        ("3x7x3, valid (fewer bins than a lane's group)", (3, 7, 3), True, (0.0, 0.0, 1.0),
         "unaligned", {}),
        ("2x16x9685, valid (two stages of one profile)", (2, 16, 9685), True,
         (0.0, 0.0, 1.0), "unaligned", {}),
        ("1x8x14512, valid (the widest profile a block takes)", (1, 8, 14512), True,
         (0.0, 0.0, 1.0), "aligned", {}),
    ]
    max_err = 0.0
    fk.fused_fit_moments.launches = 0
    for name, shape, with_valid, pr, path, kw in cases:
        D, t, w0 = _inputs(shape, gen, **kw)
        valid = (w0 != 0) if with_valid else None
        plan = fk.plan_for(D)
        check(plan.path == path, f"{name}: the plan takes the {plan.path} path, not {path}")
        got = fk.fused_fit_moments(D, t, w0, valid, pulse_region=pr)
        torch.cuda.synchronize()  # ict: backend-init-ok(phase 1 made CUDA live)
        want = fk.fused_fit_moments_plain(D, t, w0, valid, pulse_region=pr)
        max_err = max(max_err, _hold_fit(name, got, want, w0))
        log(f"  {name}: ok, {path} path, {plan.stages} stages x {plan.rows_per_stage} "
            f"profiles, {plan.blocks} blocks ({int((w0 == 0).sum())} zapped profiles)")
        del D, t, w0, got, want
    check(fk.fused_fit_moments.launches == len(cases), "parity launches were not counted")
    torch.cuda.empty_cache()

    # The 4-byte path forced on an aligned cube, and one block of one stage
    # per tile: the same bits as the plan's launch (the lane map alone fixes
    # them).
    D, t, w0 = _inputs(ONLINE_SLAB, gen)
    valid = w0 != 0
    got = fk.fused_fit_moments(D, t, w0, valid)
    for over in ({"path": "unaligned"},
                 {"stages": 1, "rows": fk.KERNEL_CONSUMER_WARPS,
                  "blocks": fk.plan_for(D, stages=1, rows=fk.KERNEL_CONSUMER_WARPS).tiles}):
        other = fk.launch(fk.plan_for(D, **over), D, t, w0, valid)
        for key, g, o in zip(FIT_TOL, got, other):
            check(_same_bits(g, o), f"{ONLINE_SLAB} with {over}: {key} differs from the plan's "
                  "launch")
        del other
    log(f"  {ONLINE_SLAB}: the 4-byte path forced on the aligned cube and one block of one "
        "stage per tile give the plan's launch bit for bit")
    del D, t, w0, valid, got
    torch.cuda.empty_cache()

    # Timing at the main path's shape and inputs (fills on, as the step runs it).
    D, t, w0 = _inputs(LOFAR, gen)
    valid = w0 != 0
    plan = fk.plan_for(D)
    timed = _fit_timing(f"at {LOFAR}", 1, LOFAR, lambda: fk.fused_fit_moments(D, t, w0, valid),
                        lambda: fk.fused_fit_moments_plain(D, t, w0, valid), runs=20)
    log(f"  plan at {LOFAR}: {plan}; max_abs_err={max_err:.3e}")
    del D, t, w0, valid
    torch.cuda.empty_cache()
    online = _slab_timing(gen, ONLINE_SLAB)
    chunk = _north_star_chunk(gen, autoshard.block_subints(NORTH_STAR, 32 * 10**9,
                                                           use_kernel=True))
    max_err = max(max_err, chunk.pop("max_abs_err"))
    batched = _batched_kernel_parity(gen)
    max_err = max(max_err, batched["max_abs_err"])
    return {
        "name": "fused_fit_moments",
        "route": "cuda",
        "source": "iterative_cleaner_tpu_torch/csrc/fused_fit_moments.cu",
        "replaces": "iterative_cleaner_tpu/ops/pallas_kernels.py:201",
        "launches": None,
        "max_abs_err": max_err,
        "parity": "ok",
        "ms": timed["ms"],
        "plain_ms": timed["plain_ms"],
        "bound_ms": timed["bound_ms"],
        "bound_by": timed["bound_by"],
        "library_ms": None,
        "device_ms": timed["device_ms"],
        "bound_share": timed["bound_share"],
        "device_bound_share": timed["device_bound_share"],
        "tb_per_s": timed["tb_per_s"],
        "plan": dataclasses.asdict(plan),
        "batched": batched,
        "online_slab": online,
        "north_star_chunk": chunk,
    }


def _slab_timing(gen, shape) -> dict:
    """The kernel and its plain version timed at ``shape`` (the online
    session's provisional-pass slab), against the bound."""
    import dataclasses

    import torch

    from iterative_cleaner_tpu_torch.ops import fused_kernels as fk

    D, t, w0 = _inputs(shape, gen)
    valid = w0 != 0
    out = _fit_timing(f"at {shape} (the online slab)", 1, shape,
                      lambda: fk.fused_fit_moments(D, t, w0, valid),
                      lambda: fk.fused_fit_moments_plain(D, t, w0, valid), runs=50)
    out["plan"] = dataclasses.asdict(fk.plan_for(D))
    del D, t, w0, valid
    torch.cuda.empty_cache()
    return out


def _north_star_chunk(gen, block) -> dict:
    """The kernel on one slab of the north star as the chunked route cuts it
    on a 32 GB card (``block`` x 4096 x 1024): against its plain version on
    its first and last subints (the maths is per profile), then timed."""
    import dataclasses

    import torch

    from iterative_cleaner_tpu_torch.ops import fused_kernels as fk

    shape = (block, *NORTH_STAR[1:])
    D, t, w0 = _inputs(shape, gen)
    valid = w0 != 0
    got = fk.fused_fit_moments(D, t, w0, valid)
    err = 0.0
    for lo, hi in ((0, 8), (block - 8, block)):
        want = fk.fused_fit_moments_plain(D[lo:hi], t, w0[lo:hi], valid[lo:hi])
        err = max(err, _hold_fit(f"north-star chunk {shape} [{lo}:{hi}]",
                                 [g[lo:hi] for g in got], want, w0[lo:hi]))
        del want
    del got
    log(f"  north-star chunk {shape}: subints [0:8] and [{block - 8}:{block}] == plain "
        f"within tolerance, max_abs_err={err:.3e}")
    out = _fit_timing(f"at {shape} (a north-star chunk on a 32 GB card)", 1, shape,
                      lambda: fk.fused_fit_moments(D, t, w0, valid), None, runs=10)
    out["plan"] = dataclasses.asdict(fk.plan_for(D))
    out["max_abs_err"] = err
    del D, t, w0, valid
    torch.cuda.empty_cache()
    return out


def _kernel_bound_ms(narch: int, shape) -> tuple[float, str, float]:
    """(bound_ms, bound_by, bytes) of one launch over ``narch`` archives of
    ``shape``: the bytes and operations the service's cost model counts
    (``obs.memory.fit_moments_cost``) over the card's rates."""
    from iterative_cleaner_tpu_torch.obs.memory import fit_moments_cost

    bytes_moved, ops = fit_moments_cost(narch, shape)
    bytes_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_F32_FLOPS * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations", bytes_moved


def _same_bits(a, b) -> bool:
    """Bit-identical, NaN payloads included."""
    import torch

    return a.shape == b.shape and bool((a.view(torch.int32) == b.view(torch.int32)).all())


def _batched_kernel_parity(gen) -> dict:
    """The launch over a leading archive axis: each archive's outputs
    bit-identical to the 3-D launch on that archive alone, and within the
    phase-3 tolerances of the plain version; at small ragged shapes with a
    template per archive (one of them zero), then timed at 8 LOFAR cubes."""
    import torch

    from iterative_cleaner_tpu_torch.ops import fused_kernels as fk
    from iterative_cleaner_tpu_torch.ops.template import build_templates

    region = (0.25, 40.0, 90.0)
    cases = [
        ("3x5x33x100, valid", 3, (5, 33, 100), True, (0.0, 0.0, 1.0)),
        ("4x8x64x257, raw maps, pre-zapped 20%", 4, (8, 64, 257), False, (0.0, 0.0, 1.0)),
        ("2x8x128x96, valid, pulse region", 2, (8, 128, 96), True, region),
        ("2x16x32x4096, valid", 2, (16, 32, 4096), True, (0.0, 0.0, 1.0)),
        ("3x32x1024x1024 (the CLI batch's shape), valid", 3, (32, 1024, 1024), True,
         (0.0, 0.0, 1.0)),
    ]
    max_err = 0.0
    for name, narch, shape, with_valid, pr in cases:
        prezap = 0.2 if "pre-zapped" in name else 0.01
        parts = [_inputs(shape, gen, prezap=prezap) for _ in range(narch)]
        Db = torch.stack([d for d, _, _ in parts])
        wb = torch.stack([w for _, _, w in parts])
        tb = build_templates(Db, wb)
        tb[-1] = 0.0                      # the zero-template rule, per archive
        vb = (wb != 0) if with_valid else None
        del parts
        before = fk.fused_fit_moments.launches
        got = fk.fused_fit_moments(Db, tb, wb, vb, pulse_region=pr)
        torch.cuda.synchronize()  # ict: backend-init-ok(phase 1 made CUDA live)
        check(fk.fused_fit_moments.launches == before + 1, f"{name}: not one launch")
        want = fk.fused_fit_moments_plain(Db, tb, wb, vb, pulse_region=pr)
        for key, g, w in zip(FIT_TOL, got, want):
            rtol, atol = FIT_TOL[key]
            torch.testing.assert_close(g, w, rtol=rtol, atol=atol, equal_nan=True,
                                       msg=lambda m, k=key, n=name: f"batched {n}: {k}: {m}")
            fin = torch.isfinite(w)
            if fin.any():
                max_err = max(max_err, float((g[fin] - w[fin]).abs().max()))
        for j in range(narch):
            one = fk.fused_fit_moments(Db[j], tb[j], wb[j], None if vb is None else vb[j],
                                       pulse_region=pr)
            for key, g, w in zip(("centred", "mean", "std", "ptp"), got, one):
                check(_same_bits(g[j], w),
                      f"batched {name}: archive {j} {key} differs from its 3-D launch")
        log(f"  batched {name}: ok (bit-identical to the 3-D launches per archive)")
        del Db, wb, tb, vb, got, want
    torch.cuda.empty_cache()

    # Timing at the batch phase's shape: 8 LOFAR cubes, one launch.
    narch = 8
    Db = torch.randn((narch, *LOFAR), generator=gen, device="cuda")
    wb = 0.8 + 0.4 * torch.rand((narch, *LOFAR[:2]), generator=gen, device="cuda")
    tb = build_templates(Db, wb)
    vb = wb != 0
    timed = _fit_timing(f"batched at {narch} x {LOFAR} (one launch)", narch, LOFAR,
                        lambda: fk.fused_fit_moments(Db, tb, wb, vb),
                        lambda: fk.fused_fit_moments_plain(Db, tb, wb, vb), runs=10)
    got = fk.fused_fit_moments(Db, tb, wb, vb)
    for j in (0, narch - 1):
        one = fk.fused_fit_moments(Db[j], tb[j], wb[j], vb[j])
        for key, g, w in zip(("centred", "mean", "std", "ptp"), got, one):
            check(_same_bits(g[j], w), f"batched 8 x LOFAR: archive {j} {key} differs")
        del one
    want = fk.fused_fit_moments_plain(Db[-1], tb[-1], wb[-1], vb[-1])
    for key, g, w in zip(FIT_TOL, got, want):
        rtol, atol = FIT_TOL[key]
        torch.testing.assert_close(g[-1], w, rtol=rtol, atol=atol, equal_nan=True)
        max_err = max(max_err, float((g[-1] - w).abs().max()))
    log(f"  batched at {narch} x {LOFAR}: archives 0 and {narch - 1} bit-identical to their "
        f"3-D launches; max_abs_err={max_err:.3e}")
    del Db, wb, tb, vb, got, want
    torch.cuda.empty_cache()
    return {**timed, "max_abs_err": max_err}


def _same_floats(a, b) -> bool:
    """Bit-identical (float32 or float64) where either is a number; NaN
    where the other is NaN."""
    import torch

    nan = torch.isnan(a)
    bits = torch.int64 if a.dtype == torch.float64 else torch.int32
    return (a.shape == b.shape and a.dtype == b.dtype
            and bool((nan == torch.isnan(b)).all())
            and bool(((a.view(bits) == b.view(bits)) | nan).all()))


def _template_bound_ms(shape, narch=1, reads=None, t_add_ms=None) -> tuple[float, str, float]:
    """(bound_ms, bound_by, bytes) of one ordered template over ``narch``
    archives of ``shape``, the cube read ``reads`` times: the bytes and
    operations the service's cost model counts (``obs.memory.template_cost``)
    over the card's rates — and, given the card's time per dependent add
    ``t_add_ms``, the chain: each bin's nprof adds one after another (the
    archives' chains run side by side), bound_by ``"chain"`` where it wins."""
    from iterative_cleaner_tpu_torch.obs.memory import template_cost

    nsub, nchan, _nbin = shape
    bytes_moved, ops = template_cost(shape, narch, reads)
    times = {"bytes": bytes_moved / PEAK_BYTES_PER_S * 1e3,
             "operations": ops / PEAK_F32_FLOPS * 1e3}
    if t_add_ms is not None:
        times["chain"] = nsub * nchan * t_add_ms
    by = max(times, key=times.get)
    return times[by], by, bytes_moved


def _chain_probe() -> tuple[float, float, str]:
    """The card's time per dependent float32 add (one warp, 2^24 adds from
    registers; the second of two runs), its SM cycles per add and the SM
    clock nvidia-smi reads right after."""
    from iterative_cleaner_tpu_torch.ops import template as tp

    n_adds = 1 << 24
    tp.chain_probe(n_adds)
    ms, cycles = tp.chain_probe(n_adds)
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60).stdout.strip()
    return ms / n_adds, cycles / n_adds, clock


def _template_case(name, D, w, *, path, cut=None) -> None:
    """The kernel on ``D``/``w`` against its plain version bit for bit, on
    the load path ``path`` (as ``launch_plan`` picks it); continued from
    ``D[:cut]`` (its own path on ``D[cut:]``) and batched with a second
    archive, each the same."""
    import torch

    from iterative_cleaner_tpu_torch.ops import template as tp

    check(tp.plan_for(D, w)[0].path == path, f"ordered_template {name}: not the {path} path")
    got = tp.build_template(D, w)
    torch.cuda.synchronize()  # ict: backend-init-ok(phase 1 made CUDA live)
    want = tp.build_template_plain(D, w)
    check(_same_floats(got, want), f"ordered_template {name}: kernel != plain")
    cut = D.shape[0] // 2 if cut is None else cut
    rest = tp.plan_for(D[cut:], w[cut:])[0].path
    cont = tp.build_template(D[cut:], w[cut:], init=tp.build_template(D[:cut], w[:cut]))
    check(_same_floats(cont, got), f"ordered_template {name}: the continued sum differs")
    Db, wb = torch.stack([D, -2 * D]), torch.stack([w, w.flip(0)])
    tb = tp.build_template(Db, wb)
    for j in range(2):
        check(_same_floats(tb[j], tp.build_template(Db[j], wb[j])),
              f"ordered_template {name}: batched archive {j} != alone")
    log(f"  ordered_template {name} ({path} path, {D.shape[0] * D.shape[1]} profiles): "
        f"kernel == plain bit for bit; continued from subint {cut} ({rest} path there) and "
        "batched (2 archives) the same")


def phase_template_parity():
    """The template kernel ordered_template (``ops/template.build_template``)
    vs its plain PyTorch version on the card, bit for bit: ragged shapes on
    both load paths, zero weights, non-finite samples, fewer profiles than
    one stage, a running sum continued block by block (the chunked route;
    from an unaligned base too), a batch over a leading archive axis and the
    sweep's stride-0 pair axis in one launch; the chain probe (the card's
    time per dependent add); then at the main path's shape, over 8 such
    cubes and over the sweep's 9 pairs, timed against the plain version,
    cuBLAS's matrix-vector product (the same sum in another order) and the
    bound (bytes, operations, the chain)."""
    import torch

    from iterative_cleaner_tpu_torch.ops import template as tp

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    rows = tp.TEMPLATE_ROWS_PER_STAGE
    # (name, shape, load path, continuation cut, the cube's offset in floats)
    cases = [("5x33x100 (a partial last bin group)", (5, 33, 100), "aligned", None, 0),
             ("8x64x257", (8, 64, 257), "unaligned", None, 0),
             ("3x7x31", (3, 7, 31), "unaligned", None, 0),
             ("16x32x4096", (16, 32, 4096), "aligned", None, 0),
             ("32x1024x1024 (a chunked block)", (32, 1024, 1024), "aligned", None, 0),
             (f"2x50x64 (fewer profiles than a stage of {rows})", (2, 50, 64), "aligned", None,
              0),
             ("3x171x48 (two stages and a row)", (3, 171, 48), "aligned", None, 0),
             ("6x97x31 (continued from an unaligned base)", (6, 97, 31), "unaligned", 3, 0),
             ("4x40x64 at an unaligned base", (4, 40, 64), "unaligned", None, 1),
             ("4x64x1024", (4, 64, 1024), "aligned", None, 0)]
    tp.build_template.launches = 0
    for k, (name, shape, path, cut, offset) in enumerate(cases):
        n = shape[0] * shape[1] * shape[2]
        D = (torch.randn(n + offset, generator=gen, device="cuda") * 3)[offset:].view(shape)
        w = torch.rand(shape[:2], generator=gen, device="cuda")
        w[torch.rand(shape[:2], generator=gen, device="cuda") < 0.2] = 0.0
        if k == 1:   # an inf and a NaN sample, as the oracle meets them
            D[1, 2, 7], D[3, 4, 9] = float("inf"), float("nan")
        if cut is not None:
            check(D[cut:].data_ptr() % 16 != 0, f"{name}: the continuation's base is aligned")
        _template_case(name, D, w, path=path, cut=cut)
        del D, w
    check(tp.build_template.launches == 6 * len(cases), "parity launches were not counted")

    # The sweep's pair axis: one cube broadcast over 9 archives (stride 0),
    # 9 weight maps, one launch; then the first iteration's broadcast
    # weights as well.
    D = torch.randn((16, 64, 1024), generator=gen, device="cuda")
    wb = torch.rand((9, 16, 64), generator=gen, device="cuda")
    Db = D.expand(9, *D.shape)
    plan = tp.plan_for(Db, wb)[0]
    check(plan.d_arch_stride == 0 and plan.blocks == 9 * 1024 // plan.bins_per_block,
          f"the stride-0 plan: {plan}")
    before = tp.build_template.launches
    tb = tp.build_templates(Db, wb)
    check(tp.build_template.launches == before + 1, "the stride-0 batch was not one launch")
    for j in range(9):
        check(_same_floats(tb[j], tp.build_template(D, wb[j])), f"stride-0 archive {j} != alone")
        check(_same_floats(tb[j], tp.build_template_plain(D, wb[j])),
              f"stride-0 archive {j} != plain")
    w0 = wb[0].expand(9, *wb.shape[1:])
    check(tp.plan_for(Db, w0)[0].w_arch_stride == 0, "the broadcast weights were copied")
    t0 = tp.build_templates(Db, w0)
    check(all(_same_floats(t0[j], tb[0]) for j in range(9)), "broadcast weights differ")
    log("  ordered_template over the sweep's stride-0 pair axis (9 x 16x64x1024, one launch): "
        "each archive == the kernel on it alone == plain, bit for bit; with the weights "
        "broadcast too (stride 0) the same")
    del D, wb, Db, tb, w0, t0
    torch.cuda.empty_cache()

    # The ranks' chain (parallel/collectives.continue_template): LOFAR's
    # subints in two blocks with a leading archive axis, the second
    # continuing the first's (1, nbin) sum: the one-card build bit for bit.
    D = torch.randn(LOFAR, generator=gen, device="cuda")
    w = torch.rand(LOFAR[:2], generator=gen, device="cuda")
    half = LOFAR[0] // 2
    first = tp.build_template(D[None, :half], w[None, :half])
    cont = tp.build_template(D[None, half:], w[None, half:], init=first)
    check(_same_floats(cont[0], tp.build_template(D, w)),
          "the ranks' continued template differs from the one-card build")
    log(f"  ordered_template as the ranks continue it: {LOFAR} in two blocks of {half} "
        "subints, (1, nbin) carried from the first: the one-card build bit for bit")
    del D, w, first, cont
    torch.cuda.empty_cache()

    t_add_ms, cycles, clock = _chain_probe()
    log(f"chain probe: {t_add_ms * 1e6:.4f} ns ({cycles:.3f} SM cycles) per dependent "
        f"float32 add; SM clock read after it {clock}")

    nsub, nchan, nbin = LOFAR
    D = torch.randn(LOFAR, generator=gen, device="cuda")
    w = 0.8 + 0.4 * torch.rand((nsub, nchan), generator=gen, device="cuda")
    w[torch.rand((nsub, nchan), generator=gen, device="cuda") < 0.01] = 0.0
    kernel_ms = _time_ms(lambda: tp.build_template(D, w), runs=20)
    library_ms = _time_ms(lambda: torch.matmul(w.reshape(-1), D.reshape(-1, nbin)), runs=20)
    got = tp.build_template(D, w)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    want = tp.build_template_plain(D, w)
    b.record()
    b.synchronize()
    plain_ms = a.elapsed_time(b)
    check(_same_floats(got, want), f"ordered_template at {LOFAR}: kernel != plain")
    lib = torch.matmul(w.reshape(-1), D.reshape(-1, nbin))
    rel = float(((lib - got).abs() / got.abs().clamp_min(1e-30)).max())
    bound_ms, bound_by, bytes_moved = _template_bound_ms(LOFAR)
    floor_ms, floor_by, _ = _template_bound_ms(LOFAR, t_add_ms=t_add_ms)
    chain_ms = nsub * nchan * t_add_ms
    log(f"ordered_template at {LOFAR}: kernel_ms={kernel_ms:.4f} (a thread per chain: 9.9001) "
        f"plain_ms={plain_ms:.4f} (one call: {nsub * nchan} ordered adds) "
        f"library_ms={library_ms:.4f} (cuBLAS matrix-vector product, another order: max "
        f"relative difference {rel:.3e}) bound_ms={bound_ms:.4f} ({bytes_moved / 1e9:.3f} GB, "
        f"{bound_by}); chain floor {chain_ms:.4f} ms, so the bound with the chain "
        f"{floor_ms:.4f} ({floor_by}; the kernel at {floor_ms / kernel_ms:.1%} of it); "
        "kernel == plain bit for bit")
    del got, want, lib

    # The online session's slab (its first 32 subints: a contiguous slice).
    Ds, ws = D[:ONLINE_SLAB[0]], w[:ONLINE_SLAB[0]]
    slab_ms = _time_ms(lambda: tp.build_template(Ds, ws), runs=50)
    slab_lib = _time_ms(lambda: torch.matmul(ws.reshape(-1), Ds.reshape(-1, nbin)), runs=50)
    sb, sb_by, snb = _template_bound_ms(ONLINE_SLAB)
    sf, sf_by, _ = _template_bound_ms(ONLINE_SLAB, t_add_ms=t_add_ms)
    log(f"ordered_template at {ONLINE_SLAB} (the online slab): kernel_ms={slab_ms:.4f} "
        f"library_ms={slab_lib:.4f} (cuBLAS matrix-vector product) bound_ms={sb:.4f} "
        f"({snb / 1e9:.3f} GB, {sb_by}); with the chain {sf:.4f} ({sf_by})")
    timed = {"online_slab": {"shape": list(ONLINE_SLAB), "ms": slab_ms, "library_ms": slab_lib,
                             "bound_ms": sb, "bound_by": sb_by, "floor_ms": sf,
                             "floor_by": sf_by}}

    # Over 8 such cubes (the batch phase), and the sweep's 9 pairs of one cube.
    Db = torch.randn((8, *LOFAR), generator=gen, device="cuda")
    wb = 0.8 + 0.4 * torch.rand((8, nsub, nchan), generator=gen, device="cuda")
    batch_ms = _time_ms(lambda: tp.build_templates(Db, wb), runs=10)
    batch_lib = _time_ms(lambda: torch.matmul(wb.reshape(8, 1, -1), Db.reshape(8, -1, nbin)),
                         runs=10)
    tb = tp.build_templates(Db, wb)
    check(_same_floats(tb[7], tp.build_template(Db[7], wb[7])), "batch archive 7 != alone")
    del Db, tb
    wp = torch.rand((9, nsub, nchan), generator=gen, device="cuda")
    Dp = D.expand(9, *LOFAR)
    sweep_ms = _time_ms(lambda: tp.build_templates(Dp, wp), runs=10)
    sweep_lib = _time_ms(lambda: torch.matmul(wp.reshape(9, -1), D.reshape(-1, nbin)), runs=10)
    tb = tp.build_templates(Dp, wp)
    check(_same_floats(tb[4], tp.build_template(D, wp[4])), "sweep pair 4 != alone")
    for key, ms, lib_ms, narch, reads, call in (
            ("batch8", batch_ms, batch_lib, 8, 8, "batched matrix-vector products"),
            ("sweep9", sweep_ms, sweep_lib, 9, 1, "one 9-row matrix product")):
        bb, bb_by, nbytes = _template_bound_ms(LOFAR, narch, reads)
        fb, fb_by, _ = _template_bound_ms(LOFAR, narch, reads, t_add_ms)
        timed[key] = {"shape": [narch, *LOFAR], "ms": ms, "library_ms": lib_ms,
                      "bound_ms": bb, "bound_by": bb_by, "floor_ms": fb, "floor_by": fb_by}
        layout = "one cube, stride 0" if reads == 1 else "contiguous"
        log(f"ordered_template over {narch} x {LOFAR} ({layout}, one launch): "
            f"kernel_ms={ms:.4f} library_ms={lib_ms:.4f} (cuBLAS, {call}) bound_ms={bb:.4f} "
            f"({nbytes / 1e9:.3f} GB, {bb_by}); with the chain {fb:.4f} ({fb_by})")
    del D, w, Ds, ws, wp, Dp, tb, wb
    torch.cuda.empty_cache()
    return {
        "name": "ordered_template",
        "route": "cuda",
        "source": "iterative_cleaner_tpu_torch/csrc/ordered_template.cu",
        "replaces": "iterative_cleaner_tpu/ops/template.py:45",
        "launches": None,
        "max_abs_err": 0.0,
        "parity": "ok (bit for bit)",
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "chain_floor_ms": chain_ms,
        "t_add_ns": t_add_ms * 1e6,
        "bound_with_chain_ms": floor_ms,
        "bound_with_chain_by": floor_by,
        **timed,
    }


def phase_template_f64():
    """Phase 3, float64: ``ordered_template``'s float64 instantiation (the
    ``--x64`` routes) against ``build_template_plain`` in float64, bit for
    bit: ragged shapes on both load paths (an odd bin count and a base one
    double off 16 bytes take the 8-byte copies), zero weights, an inf and a
    NaN sample, fewer profiles than a stage, a sum continued from an
    unaligned subint, a batch of two archives, the sweep's stride-0 pair
    axis; the float64 chain probe;
    then at the main path's shape in float64, timed against the plain
    version, cuBLAS's float64 matrix-vector product, the byte bound (twice
    the float32 bytes) and the float64 chain floor."""
    import torch

    from iterative_cleaner_tpu_torch.obs.memory import template_cost
    from iterative_cleaner_tpu_torch.ops import template as tp

    f64 = torch.float64
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6464)
    rows = tp.TEMPLATE_ROWS_PER_STAGE_F64
    # (name, shape, load path, continuation cut, the cube's offset in doubles)
    cases = [("5x33x100 (a partial last bin group)", (5, 33, 100), "aligned", None, 0),
             ("8x64x257", (8, 64, 257), "unaligned", None, 0),
             ("3x7x31", (3, 7, 31), "unaligned", None, 0),
             ("16x32x4096", (16, 32, 4096), "aligned", None, 0),
             (f"2x50x64 (fewer profiles than a stage of {rows})", (2, 50, 64), "aligned", None,
              0),
             ("3x171x48 (several stages and a row)", (3, 171, 48), "aligned", None, 0),
             ("6x97x31 (continued from an unaligned base)", (6, 97, 31), "unaligned", 3, 0),
             ("4x40x64 at an unaligned base", (4, 40, 64), "unaligned", None, 1),
             ("32x1024x1024 (a chunked block)", (32, 1024, 1024), "aligned", None, 0)]
    tp.build_template.launches = tp.build_template.launches_f64 = 0
    for k, (name, shape, path, cut, offset) in enumerate(cases):
        n = shape[0] * shape[1] * shape[2]
        D = (torch.randn(n + offset, generator=gen, device="cuda", dtype=f64) * 3
             )[offset:].view(shape)
        w = torch.rand(shape[:2], generator=gen, device="cuda", dtype=f64)
        w[torch.rand(shape[:2], generator=gen, device="cuda") < 0.2] = 0.0
        if k == 1:   # an inf and a NaN sample, as the oracle meets them
            D[1, 2, 7], D[3, 4, 9] = float("inf"), float("nan")
        if cut is not None:
            check(D[cut:].data_ptr() % 16 != 0, f"{name}: the continuation's base is aligned")
        plan = tp.plan_for(D, w)[0]
        check(plan.path == path and plan.rows_per_stage == rows,
              f"float64 ordered_template {name}: plan {plan}")
        got = tp.build_template(D, w)
        torch.cuda.synchronize()  # ict: backend-init-ok(phase 1 made CUDA live)
        check(got.dtype == f64 and _same_floats(got, tp.build_template_plain(D, w)),
              f"float64 ordered_template {name}: kernel != plain")
        c = shape[0] // 2 if cut is None else cut
        cont = tp.build_template(D[c:], w[c:], init=tp.build_template(D[:c], w[:c]))
        check(_same_floats(cont, got), f"float64 ordered_template {name}: continued sum differs")
        Db, wb = torch.stack([D, -2 * D]), torch.stack([w, w.flip(0)])
        tb = tp.build_template(Db, wb)
        check(all(_same_floats(tb[j], tp.build_template(Db[j], wb[j])) for j in range(2)),
              f"float64 ordered_template {name}: batched archive != alone")
        log(f"  float64 ordered_template {name} ({path} path): kernel == plain bit for bit; "
            f"continued from subint {c} and batched (2 archives) the same")
        del D, w, Db, wb
    check(tp.build_template.launches_f64 == 6 * len(cases) and tp.build_template.launches == 0,
          "float64 parity launches were not counted as float64")

    # The sweep's pair axis in float64 (--sweep --x64): one cube broadcast
    # over 9 archives (stride 0), 9 weight maps, one launch.
    D = torch.randn((16, 64, 1024), generator=gen, device="cuda", dtype=f64)
    wb = torch.rand((9, 16, 64), generator=gen, device="cuda", dtype=f64)
    Db = D.expand(9, *D.shape)
    plan = tp.plan_for(Db, wb)[0]
    check(plan.d_arch_stride == 0 and plan.blocks == 9 * 1024 // plan.bins_per_block,
          f"the float64 stride-0 plan: {plan}")
    before = tp.build_template.launches_f64
    tb = tp.build_templates(Db, wb)
    check(tp.build_template.launches_f64 == before + 1,
          "the float64 stride-0 batch was not one launch")
    for j in range(9):
        check(_same_floats(tb[j], tp.build_template(D, wb[j])),
              f"float64 stride-0 archive {j} != alone")
        check(_same_floats(tb[j], tp.build_template_plain(D, wb[j])),
              f"float64 stride-0 archive {j} != plain")
    log("  float64 ordered_template over the sweep's stride-0 pair axis (9 x 16x64x1024, one "
        "launch): each archive == the kernel on it alone == plain, bit for bit")
    del D, wb, Db, tb

    n_adds = 1 << 24
    tp.chain_probe(n_adds, dtype=f64)
    ms, cycles = tp.chain_probe(n_adds, dtype=f64)
    t_add_ms = ms / n_adds
    log(f"chain probe (float64): {t_add_ms * 1e6:.4f} ns ({cycles / n_adds:.3f} SM cycles) per "
        "dependent float64 add")

    nsub, nchan, nbin = LOFAR
    D = torch.randn(LOFAR, generator=gen, device="cuda", dtype=f64)
    w = 0.8 + 0.4 * torch.rand((nsub, nchan), generator=gen, device="cuda", dtype=f64)
    w[torch.rand((nsub, nchan), generator=gen, device="cuda") < 0.01] = 0.0
    kernel_ms = _time_ms(lambda: tp.build_template(D, w), runs=20)
    library_ms = _time_ms(lambda: torch.matmul(w.reshape(-1), D.reshape(-1, nbin)), runs=20)
    got = tp.build_template(D, w)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    want = tp.build_template_plain(D, w)
    b.record()
    b.synchronize()
    plain_ms = a.elapsed_time(b)
    check(_same_floats(got, want), f"float64 ordered_template at {LOFAR}: kernel != plain")
    def bound(shape):
        bytes32, ops = template_cost(shape)
        times = {"bytes": 2 * bytes32 / PEAK_BYTES_PER_S * 1e3,
                 "operations": ops / PEAK_F64_FLOPS * 1e3}
        by = max(times, key=times.get)
        return times[by], by, 2 * bytes32

    bound_ms, bound_by, bytes_moved = bound(LOFAR)
    chain_ms = nsub * nchan * t_add_ms
    log(f"float64 ordered_template at {LOFAR}: kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f} (cuBLAS float64 matrix-vector product, another order) "
        f"bound_ms={bound_ms:.4f} ({bytes_moved / 1e9:.3f} GB, {bound_by}); chain floor "
        f"{chain_ms:.4f} ms (the kernel at {chain_ms / kernel_ms:.1%} of it); kernel == plain "
        "bit for bit")

    # The chunked route's block at LOFAR (32 subints: a contiguous slice).
    block = (32, nchan, nbin)
    Dc, wc = D[:block[0]], w[:block[0]]
    chunk_ms = _time_ms(lambda: tp.build_template(Dc, wc), runs=50)
    chunk_lib = _time_ms(lambda: torch.matmul(wc.reshape(-1), Dc.reshape(-1, nbin)), runs=50)
    a.record()
    want = tp.build_template_plain(Dc, wc)
    b.record()
    b.synchronize()
    chunk_plain = a.elapsed_time(b)
    check(_same_floats(tp.build_template(Dc, wc), want), "float64 chunk block: kernel != plain")
    cb, cb_by, cnb = bound(block)
    log(f"float64 ordered_template at {block} (the chunked route's block): kernel_ms="
        f"{chunk_ms:.4f} plain_ms={chunk_plain:.4f} library_ms={chunk_lib:.4f} bound_ms={cb:.4f} "
        f"({cnb / 1e9:.3f} GB, {cb_by}); chain floor {block[0] * nchan * t_add_ms:.4f} ms")
    del D, w, got, want, Dc, wc
    torch.cuda.empty_cache()
    return {
        "name": "ordered_template_f64",
        "route": "cuda",
        "source": "iterative_cleaner_tpu_torch/csrc/ordered_template.cu",
        "replaces": "iterative_cleaner_tpu/ops/template.py:45",
        "launches": None,
        "max_abs_err": 0.0,
        "parity": "ok (bit for bit)",
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "chain_floor_ms": chain_ms,
        "t_add_ns": t_add_ms * 1e6,
        "chunk_block": {"shape": list(block), "ms": chunk_ms, "plain_ms": chunk_plain,
                        "library_ms": chunk_lib, "bound_ms": cb, "bound_by": cb_by,
                        "chain_floor_ms": block[0] * nchan * t_add_ms},
    }


def phase_preprocess(lofar_prep, t_add_ns: float) -> dict:
    """The device preprocess at LOFAR: the seed-42 raw archive through
    ``preprocess(ar, device="cuda")`` against the native host pass bit for
    bit (its peak against the native cube's ``nanmin`` / ``nanmax``) and
    against the plain twin on the same plane; the kernels on the uploaded
    plane (the upload left out) a call and back to back, each kernel's
    device time from a profiler, beside the bytes the cube needs (read and
    written once, 2 GiB) and the float64 total's chain floor (``nsub x
    nchan`` dependent adds at ``t_add_ns``, phase 3's float64 chain probe)."""
    import numpy as np
    import torch

    from iterative_cleaner_tpu_torch import native
    from iterative_cleaner_tpu_torch.ops import preprocess as pp

    ar = lofar_prep.result()[0]
    nsub, nchan, nbin = LOFAR
    t0 = time.perf_counter()
    want, _ = native.preprocess_native(ar)
    native_s = time.perf_counter() - t0
    D, _w0, peak = pp.preprocess(ar, device="cuda")
    got = D.cpu().numpy()
    check(got.tobytes() == want.tobytes(), f"device preprocess at {LOFAR} != the native pass")
    check(peak.read() == (float(want.min()), float(want.max())),
          f"device preprocess peak {peak.read()} != the native cube's")

    shifts = pp.archive_shifts(ar)
    w = torch.from_numpy(np.array(ar.weights, np.float32)).cuda()
    sh = torch.from_numpy(shifts).cuda()
    width = pp.baseline_width(nbin)
    plane = torch.from_numpy(np.ascontiguousarray(ar.data[:, 0])).cuda()
    twin = plane.clone()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    pp.preprocess_plane_plain(twin, w, sh, width)
    b.record()
    b.synchronize()
    plain_ms = a.elapsed_time(b)
    check(torch.equal(twin, D), f"the plain twin at {LOFAR} != the kernels")

    buf = plane.clone()

    def call():
        pp.preprocess_plane(buf, w, sh, width)

    ms = _time_ms(call, runs=20)
    device_ms = _device_ms(call, runs=20)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            call()
        torch.cuda.synchronize()  # ict: backend-init-ok(phase 1 made CUDA live)
    per_kernel = {}
    for e in prof.key_averages():
        name = re.search(r"preprocess_\w+_kernel(<\w+>)?", e.key)
        if name and e.count:
            total_us = getattr(e, "device_time_total", None) or e.cuda_time_total
            per_kernel[name.group(0)] = total_us / e.count / 1e3
    bytes_moved = 2 * plane.nbytes
    times = {"bytes": bytes_moved / PEAK_BYTES_PER_S * 1e3,
             "chain": nsub * nchan * t_add_ns * 1e-6}
    bound_by = max(times, key=times.get)
    log(f"preprocess at {LOFAR}: ms={ms:.4f} device_ms={device_ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={times[bound_by]:.4f} ({bound_by}; bytes {times['bytes']:.4f} for "
        f"{bytes_moved / 2**30:.0f} GiB, chain floor {times['chain']:.4f}); the native host "
        f"pass {native_s * 1e3:.1f} ms; kernels == native == plain twin bit for bit")
    log("  per kernel (device ms a call): " + ", ".join(
        f"{k} {v:.4f}" for k, v in sorted(per_kernel.items())))
    del D, plane, twin, buf
    torch.cuda.empty_cache()
    return {
        "name": "preprocess",
        "route": "cuda",
        "source": "iterative_cleaner_tpu_torch/csrc/preprocess.cu",
        "replaces": "none: the native host pass native/ict_native.cc:107-160",
        "launches": None,
        "max_abs_err": 0.0,
        "parity": "ok (bit for bit with the native pass and the plain twin)",
        "ms": ms,
        "device_ms": device_ms,
        "plain_ms": plain_ms,
        "bound_ms": times[bound_by],
        "bound_by": bound_by,
        "bytes_ms": times["bytes"],
        "chain_floor_ms": times["chain"],
        "native_ms": native_s * 1e3,
        "kernels_ms": per_kernel,
    }


def _drift(scores, oracle) -> float:
    """Unit-floored relative score drift, as obs/audit.run_audit measures
    it, over the entries finite on both sides."""
    import numpy as np

    fin = np.isfinite(oracle) & np.isfinite(scores)
    return float(np.max(np.abs(scores[fin] - oracle[fin]) / np.maximum(np.abs(oracle[fin]), 1.0)))


def _lofar_archive(work, pool):
    """The main path's archive: made and written to ``work/main`` on this
    thread while the host references (preprocessing, the numpy oracle) run
    on the pool's other thread.  Started before the build, so the host's
    single-threaded zlib writer overlaps the kernel phases; both are done
    before the CLI starts, so its wall-clock is its own.  Returns (archive,
    path, write seconds, (D, w0, oracle result, preprocess s, oracle s))."""
    from iterative_cleaner_tpu_torch.config import CleanConfig
    from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
    from iterative_cleaner_tpu_torch.io.npz import NpzIO
    from iterative_cleaner_tpu_torch.io.synthetic import make_archive
    from iterative_cleaner_tpu_torch.ops.preprocess import preprocess

    def references(ar):
        t0 = time.perf_counter()
        # The numpy path: phase 14 holds the native route against it.
        D, w0 = preprocess(ar, prefer_native=False)
        t1 = time.perf_counter()
        ora = clean_cube(D, w0, CleanConfig(backend="numpy"))
        return D, w0, ora, t1 - t0, time.perf_counter() - t1

    t0 = time.perf_counter()
    tmp = os.path.join(work, "main")
    os.makedirs(tmp)
    ar = make_archive(nsub=LOFAR[0], nchan=LOFAR[1], nbin=LOFAR[2], seed=42)
    refs = pool.submit(references, ar)
    path = os.path.join(tmp, "lofar_seed42.npz")
    NpzIO().save(ar, path)
    return ar, path, time.perf_counter() - t0, refs.result()


def phase_main_path(entries, lofar_prep):
    import numpy as np
    import torch

    from iterative_cleaner_tpu_torch import cli
    from iterative_cleaner_tpu_torch.backends import torch_backend
    from iterative_cleaner_tpu_torch.config import CleanConfig
    from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
    from iterative_cleaner_tpu_torch.obs.audit import AUDIT_DRIFT_BOUND
    from iterative_cleaner_tpu_torch.ops import fused_kernels as fk
    from iterative_cleaner_tpu_torch.ops import template as tp

    nsub, nchan, nbin = LOFAR
    cwd = os.getcwd()
    ar, path, write_s, (D, w0, ora, pre_s, ora_s) = lofar_prep.result()
    tmp = os.path.dirname(path)
    log(f"wrote {path} ({os.path.getsize(path) / 1e9:.2f} GB) in {write_s:.1f}s (started "
        "before the build)")
    log(f"preprocessed the same archive (numpy path) for the references in {pre_s:.1f}s and ran "
        f"the numpy oracle at full size {LOFAR} in {ora_s:.1f}s, beside the write: "
        f"loops={ora.loops}")

    report_path = os.path.join(tmp, "report.json")
    os.chdir(tmp)   # clean.log goes to the working directory
    try:
        torch.cuda.reset_peak_memory_stats()  # ict: backend-init-ok(phase 1 made CUDA live)
        fk.fused_fit_moments.launches = tp.build_template.launches = 0
        t0 = time.perf_counter()
        with _recording(torch_backend, "start_precompile") as warm:
            rc = cli.main([path, "-q", "--dump_masks", "--report", report_path])
        wall = time.perf_counter() - t0
        launches = fk.fused_fit_moments.launches
        t_launches = tp.build_template.launches
    finally:
        os.chdir(cwd)
    check(rc == 0, f"cli.main returned {rc}")
    rep = json.load(open(report_path))[0]
    out_path = rep["out_path"]
    check(out_path and os.path.exists(out_path), "no cleaned archive written")
    check(os.path.exists(out_path + "_masks.npz"), "no mask dump written")
    check(os.path.exists(os.path.join(tmp, "clean.log")), "no clean.log written")
    loops, iters = rep["loops"], rep["iteration_s"]
    log(f"CLI clean: rc={rc} wall={wall:.2f}s loops={loops} converged={rep['converged']} "
        f"peak_device_mem={torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    log("  per-iteration wall-clock (s): " + ", ".join(f"{s:.4f}" for s in iters))
    # The warm-up's dummy step (the route once on a zero cube while the
    # host preprocesses) launches once; the clean once per loop.
    check(len(warm) == 1 and warm[0] is not None, "the CLI started no warm-up")
    check(warm[0].error is None, f"the warm-up failed: {warm[0].error!r}")
    warm_launches = warm[0].launches
    check(warm_launches == 1, f"the warm-up launched the kernel {warm_launches} times")
    launches -= warm_launches
    check(launches > 0, "the main path never launched the kernel")
    check(launches == len(iters) and len(iters) == loops,
          f"kernel launches {launches} (warm-up's {warm_launches} apart) != "
          f"iterations {len(iters)} (loops {loops})")
    # The template kernel: once in the warm-up, then for each dense
    # build (iteration 1, and wherever more profiles flipped than the
    # sparse update takes).
    check(warm[0].template_launches == 1,
          f"the warm-up launched ordered_template {warm[0].template_launches} times")
    t_launches -= warm[0].template_launches
    check(1 <= t_launches <= loops, f"ordered_template launches {t_launches} outside "
          f"1..{loops} (one per dense template build)")
    log(f"  launches: fused_fit_moments {launches} + the warm-up's {warm_launches}, "
        f"ordered_template {t_launches} + the warm-up's {warm[0].template_launches}")
    with np.load(out_path) as z:   # the weights member only, not the cube
        served = z["weights"]
    log(f"  {sum(iters):.3f}s of the CLI wall-clock was the cleaning loop")
    with np.load(out_path + "_masks.npz") as z:
        check(np.array_equal(z["history"][-1], served), "mask dump != cleaned weights")
        scores = z["test_results"]
        history = z["history"]
    check(scores.shape == (nsub, nchan), f"scores shape {scores.shape}")
    n_zapped = int((served == 0).sum())
    log(f"  zapped {n_zapped} / {served.size} profiles "
        f"({int(np.isfinite(scores).sum())} finite scores)")
    check(0 < n_zapped < served.size, "implausible zap count")

    t0 = time.perf_counter()
    before = fk.fused_fit_moments.launches
    off = clean_cube(D, w0, CleanConfig(backend="torch", kernel=False), device="cuda")
    log(f"kernel-off route (plain PyTorch on the card): loops={off.loops} "
        f"in {time.perf_counter() - t0:.2f}s")
    check(fk.fused_fit_moments.launches == before, "the kernel-off route launched it")
    check(np.array_equal(off.weights, served), "mask differs from the kernel-off route")
    check(off.loops == loops, "loops differ from the kernel-off route")

    layer_times(D, w0, served)

    n_diff = int((ora.weights != served).sum())
    check(n_diff == 0, f"{n_diff} mask entries differ from the numpy oracle")
    check(ora.loops == loops and ora.converged == rep["converged"],
          "loops/converged differ from the numpy oracle")
    drift = _drift(scores, ora.test_results)
    log(f"  mask identical to the oracle and the kernel-off route; "
        f"max score drift vs oracle {drift:.4e} (bound {AUDIT_DRIFT_BOUND:g}; with the first "
        f"fit/moments kernel {FIRST_KERNEL_DRIFT:.4e})")
    drift_layers(D, w0, ora, drift, off)
    check(drift <= AUDIT_DRIFT_BOUND, f"score drift {drift:.4e} beyond the "
          f"{AUDIT_DRIFT_BOUND:g} envelope")
    entries["fused_fit_moments"]["launches"] = launches
    entries["ordered_template"]["launches"] = t_launches
    return {"archive": ar, "D": D, "w0": w0, "served": served, "history": history,
            "loops": loops, "path": path, "wall": wall, "scores": scores,
            "converged": rep["converged"], "iteration_s": iters, "oracle": ora,
            "warm_launches": warm_launches, "warm_template_launches": warm[0].template_launches,
            "preprocess_s": pre_s}


def drift_layers(D, w0, ora, drift, off) -> None:
    """The score drift against the oracle at the main path's shape, split
    by layer: the kernel route (the CLI's) against the plain route, the FFT
    diagnostic in 2^25-element pieces against one transform, the template
    summed in the oracle's order against one matrix-vector product (the
    port's template before it took the oracle's order); TF32's flags."""
    import torch

    from iterative_cleaner_tpu_torch.backends import torch_backend
    from iterative_cleaner_tpu_torch.config import CleanConfig
    from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
    from iterative_cleaner_tpu_torch.ops import stats

    cfg = CleanConfig(backend="torch")
    pieces = stats.FFT_PIECE_ELEMENTS
    stats.FFT_PIECE_ELEMENTS = D.size
    try:
        one_fft = clean_cube(D, w0, cfg, device="cuda")
    finally:
        stats.FFT_PIECE_ELEMENTS = pieces
    ordered = torch_backend.build_template
    torch_backend.build_template = lambda D_, w_: torch.matmul(
        w_.reshape(-1).to(D_.dtype), D_.reshape(-1, D_.shape[-1]))
    try:
        matmul = {name: clean_cube(D, w0, cfg.replace(fused=fused), device="cuda")
                  for name, fused in (("stepwise", False), ("fused", True))}
    finally:
        torch_backend.build_template = ordered
    log("  score drift vs the oracle by layer: kernel route (the CLI) "
        f"{drift:.4e}; plain route (kernel off) {_drift(off.test_results, ora.test_results):.4e}; "
        f"FFT diagnostic as one transform instead of 2^25-element pieces "
        f"{_drift(one_fft.test_results, ora.test_results):.4e}; the template as one cuBLAS "
        "matrix-vector product instead of the oracle's order: stepwise "
        f"{_drift(matmul['stepwise'].test_results, ora.test_results):.4e}, fused "
        f"{_drift(matmul['fused'].test_results, ora.test_results):.4e}")
    log(f"  TF32: torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}, float32 matmul precision "
        f"{torch.get_float32_matmul_precision()!r} (cuDNN's TF32 flag "
        f"{torch.backends.cudnn.allow_tf32} is not read: no convolution runs)")
    for res in (one_fft, *matmul.values()):
        check((res.weights == ora.weights).all(), "a layer variant's mask differs")
    torch.cuda.empty_cache()


def layer_times(D, w0, served) -> None:
    """Device time of each layer of one steady iteration on the main path's
    cube (CUDA events, median of 10 after a warm-up)."""
    import torch

    from iterative_cleaner_tpu_torch.backends.torch_backend import (
        incremental_template,
        to_device,
    )
    from iterative_cleaner_tpu_torch.convert import state_from_numpy
    from iterative_cleaner_tpu_torch.ops import fused_kernels as fk
    from iterative_cleaner_tpu_torch.ops.stats import fft_diagnostic, scale_and_combine
    from iterative_cleaner_tpu_torch.ops.template import build_template

    Dt, wt, vt, _ = state_from_numpy(D, w0, device="cuda")
    new_w = to_device(served, "cuda")
    t = build_template(Dt, wt)
    c, m, s, p = fk.fused_fit_moments(Dt, t, wt, vt)
    f = fft_diagnostic(c)
    parts = {
        "dense template": lambda: build_template(Dt, wt),
        "incremental template": lambda: incremental_template(Dt, t, wt, new_w),
        "fused_fit_moments kernel": lambda: fk.fused_fit_moments(Dt, t, wt, vt),
        "fft diagnostic": lambda: fft_diagnostic(c),
        "robust scalers": lambda: scale_and_combine(s, m, p, f, vt, 5.0, 5.0),
    }
    # This phase with the previous designs of both kernels (a 16-bin block's
    # chain warp for the template, one block of 4 warps per 4 profiles for
    # fused_fit_moments; NVIDIA H100 80GB HBM3, 700 W).
    before = {"dense template": 0.8959, "incremental template": 1.3799,
              "fused_fit_moments kernel": 0.9240, "fft diagnostic": 2.4108,
              "robust scalers": 3.3299}
    for name, fn in parts.items():
        log(f"  layer {name}: {_time_ms(fn, runs=10):.4f} ms a call (the previous kernels: "
            f"{before[name]:.4f} ms)")
    log(f"  layer fused_fit_moments kernel, device time of launches back to back: "
        f"{_device_ms(parts['fused_fit_moments kernel'], runs=10):.4f} ms")
    del Dt, wt, vt, new_w, t, c, m, s, p, f
    torch.cuda.empty_cache()


#: Device-activity categories of a torch.profiler Chrome trace.
#: The obs CLI's depth: phase 4's first subints (the audit replays the
#: numpy oracle on them).
OBS_NSUB = 64
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
FUSED_KERNEL = "fused_fit_moments_kernel"
TEMPLATE_KERNEL = "ordered_template_kernel"


def _trace_file(directory) -> str:
    import glob

    from iterative_cleaner_tpu_torch.obs.profiling import TRACE_SUFFIX

    files = glob.glob(os.path.join(directory, "*" + TRACE_SUFFIX))
    check(len(files) == 1, f"{directory}: {len(files)} Chrome traces, want 1")
    return files[0]


def _device_events(path) -> list[dict]:
    """The device activity of a Chrome trace: kernels, copies and sets,
    sorted by start (microseconds)."""
    with open(path) as fh:
        evs = json.load(fh)["traceEvents"]
    dev = [e for e in evs if e.get("cat") in DEVICE_CATS and "dur" in e]
    return sorted(dev, key=lambda e: e["ts"]), evs


def _short(name: str) -> str:
    """A device operation's name without return type, namespaces, template
    arguments and parameter list ("Memcpy HtoD (Pageable -> Device)" kept
    to its first two words)."""
    if name.startswith(("Memcpy", "Memset")):
        return " ".join(name.split()[:2])
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0].split("<")[0].split("::")[-1][:60]


def _busy_report(dev: list[dict], t0: float, t1: float, label: str) -> dict:
    """Busy share over [t0, t1] (the union of device intervals there), the
    five device operations that took the most time and the largest idle
    gaps, logged under ``label``."""
    spans = sorted((max(e["ts"], t0), min(e["ts"] + e["dur"], t1)) for e in dev
                   if e["ts"] < t1 and e["ts"] + e["dur"] > t0)
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    window = max(t1 - t0, 1e-9)
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1])
                   for i in range(len(merged) - 1)), reverse=True)[:5]
    by_op: dict = {}
    for e in dev:
        if t0 <= e["ts"] < t1:
            key = (e["cat"], _short(e["name"]))
            tot, n = by_op.get(key, (0.0, 0))
            by_op[key] = (tot + e["dur"], n + 1)
    top = sorted(by_op.items(), key=lambda kv: -kv[1][0])[:5]
    log(f"  {label}: device busy {busy / 1e3:.3f} ms of a {window / 1e3:.3f} ms window, "
        f"busy share {busy / window:.4f}, idle share {1 - busy / window:.4f}")
    log("    top device operations: " + "; ".join(
        f"{name} ({cat}) {tot / 1e3:.3f} ms x{n}" for (cat, name), (tot, n) in top))
    log("    largest idle gaps: " + ", ".join(
        f"{g / 1e3:.3f} ms at +{(at - t0) / 1e3:.1f} ms" for g, at in gaps))
    return {"busy_share": busy / window, "window_ms": window / 1e3,
            "top": [(name, tot / 1e3, n) for (_cat, name), (tot, n) in top],
            "gaps_ms": [g / 1e3 for g, _ in gaps]}


def phase_obs(lofar, entries) -> dict:
    """Observability on the card, on the main path's LOFAR archive: the CLI
    with --telemetry, --trace, --audit and --report under ICT_FORENSICS=1
    (events, forensics, the audit, the report, the capture's kernels and
    the device's busy share), the fused loop's host syncs with telemetry
    on, a bounded capture around run_fused, the device-memory view, the
    watchdog on a live card, the metrics exposition through the strict
    parser, and the CLI's wall-clock with and without telemetry and
    forensics."""
    import numpy as np
    import torch

    from iterative_cleaner_tpu_torch import cli
    from iterative_cleaner_tpu_torch.backends.torch_backend import run_fused
    from iterative_cleaner_tpu_torch.config import CleanConfig
    from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
    from iterative_cleaner_tpu_torch.io.ictb import IctbIO
    from iterative_cleaner_tpu_torch.io.npz import NpzIO
    from iterative_cleaner_tpu_torch.io.synthetic import make_archive
    from iterative_cleaner_tpu_torch.obs import events, flight, memory, metrics, profiling, tracing
    from iterative_cleaner_tpu_torch.ops import fused_kernels as fk
    from iterative_cleaner_tpu_torch.ops import template as tp
    from iterative_cleaner_tpu_torch.parallel import autoshard
    from iterative_cleaner_tpu_torch.utils import device_probe

    ora = lofar["oracle"]
    work = os.path.join(os.path.dirname(os.path.dirname(lofar["path"])), "obs")
    os.makedirs(work)
    D, w0 = lofar["D"], lofar["w0"]
    fcfg = CleanConfig(backend="torch", fused=True)
    # A bounded capture around run_fused, first: no capture ran in this process yet.
    root = os.path.join(work, "profiles")
    rec = profiling.start(root, duration_s=60, tag="fused")
    try:
        try:
            profiling.start(root, duration_s=1, tag="second")
            check(False, "an overlapping capture was not refused")
        except RuntimeError as exc:
            check("already running" in str(exc), f"unexpected refusal {exc!r}")
        before = fk.fused_fit_moments.launches
        out = run_fused(D, w0, fcfg)
        torch.cuda.synchronize()  # ict: backend-init-ok(phase 1 made CUDA live)
        x = fk.fused_fit_moments.launches - before
    finally:
        stopped = profiling.stop(expected_dir=rec["dir"])
    check(stopped and "error" not in stopped, f"the bounded capture's stop: {stopped}")
    check(np.array_equal(out[1], ora.weights), "run_fused under the capture: mask != oracle")
    listed = [p["name"] for p in profiling.list_profiles(root)]
    check(listed == [os.path.basename(rec["dir"])], f"list_profiles: {listed}")
    dev_b, evs_b = _device_events(stopped["trace"])
    fused_b = [e for e in dev_b if e["cat"] == "kernel" and FUSED_KERNEL in e["name"]]
    spans_b = sum(1 for e in evs_b if e.get("cat") == "user_annotation"
                  and e.get("name") == "fused_fit_moments")
    log(f"  bounded capture (profiling.start -> run_fused -> stop; prepared on this thread, "
        f"started and stopped on its own): {stopped['duration_s']:.2f}s, listed, an "
        f"overlapping start refused; {FUSED_KERNEL} device kernels {len(fused_b)} at +"
        + ", +".join(f"{(e['ts'] - dev_b[0]['ts']) / 1e3:.2f}" for e in fused_b)
        + f" ms, host spans {spans_b}, launches {x}")
    check(len(fused_b) == x, f"the bounded capture holds {len(fused_b)} {FUSED_KERNEL} device "
          f"kernels, the wrapper counted {x} launches")
    fused_stats = _busy_report(dev_b, dev_b[0]["ts"], max(e["ts"] + e["dur"] for e in dev_b),
                               "run_fused from host arrays (upload, loop, fetch)")

    ev_path, tdir = os.path.join(work, "ev.jsonl"), os.path.join(work, "tdir")
    rep_path = os.path.join(work, "r.json")
    tracing.reset_counters()
    flight.reset()
    cwd = os.getcwd()
    # The obs CLI reads and writes the archive as .ictb: the NPZ zlib writer
    # took 60 s of this phase's 172 s, and phase 4 runs the NPZ path at
    # this size already.  Its depth is cut to phase 4's first OBS_NSUB
    # subints (the audit's oracle replay took 69 s of it at 256): the
    # channels and bins stay LOFAR's.
    ar = lofar["archive"]
    obs_ar = dataclasses.replace(ar, data=ar.data[:OBS_NSUB], weights=ar.weights[:OBS_NSUB])
    obs_shape = (OBS_NSUB, *LOFAR[1:])
    obs_in, obs_out = os.path.join(work, "lofar_seed42.ictb"), os.path.join(work, "obs.ictb")
    t0 = time.perf_counter()
    IctbIO().save(obs_ar, obs_in)
    log(f"obs: phase 4's archive cut to its first {OBS_NSUB} subints (nsub cut from "
        f"{LOFAR[0]} for the script's time limit), written as {obs_in} in "
        f"{time.perf_counter() - t0:.2f}s")
    os.environ["ICT_FORENSICS"] = "1"
    os.environ["ICT_REPRO_DIR"] = os.path.join(work, "repro")
    fk.fused_fit_moments.launches = tp.build_template.launches = 0
    os.chdir(work)
    try:
        t0 = time.perf_counter()
        with _stderr_to(io.StringIO()) as said:
            rc = cli.main([obs_in, "-q", "-o", obs_out,
                           "--telemetry", ev_path, "--trace", tdir, "--audit",
                           "--report", rep_path])
        obs_wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        os.environ.pop("ICT_FORENSICS")
        os.environ.pop("ICT_REPRO_DIR")
        events.configure(None)
    launches = {"obs_cli": fk.fused_fit_moments.launches,
                "obs_cli_template": tp.build_template.launches, "obs_capture": x}
    check(rc == 0, f"the obs CLI returned {rc}")
    check("backend_init_watchdog" not in said.getvalue(), "the watchdog fired on a live card")
    rep = json.load(open(rep_path))[0]
    aud, qual, loops = rep["audit"], rep["quality"], rep["loops"]

    # The event log.
    with open(ev_path) as fh:
        recs = [json.loads(line) for line in fh]
    names = [r["event"] for r in recs]
    for want in ("cli_run_start", "job_submitted", "clean_archive_start", "clean_archive_end",
                 "cli_run_end"):
        check(want in names, f"no {want} event")
    # The clean's route, then the audit's replay through the oracle (its
    # own clean_route and iterations, as in the JAX package).
    routes = [r["route"] for r in recs if r["event"] == "clean_route"]
    check(routes == ["stepwise", "numpy"], f"clean_route events {routes}")
    replay = names.index("clean_route", names.index("clean_route") + 1)
    iters = [r for r in recs[:replay] if r["event"] == "iteration"]
    check(len(iters) == loops, f"{len(iters)} iteration events for {loops} loops")
    check(names.count("iteration") == loops + aud["oracle_loops"],
          f"{names.count('iteration')} iteration events in all, want {loops} + the "
          f"replay's {aud['oracle_loops']}")
    check(all(r.get("zaps_by_diagnostic") for r in recs if r["event"] == "iteration"),
          "an iteration event has no zaps_by_diagnostic")
    check(len({r["trace_id"] for r in recs}) == 1, "the run's events carry several trace ids")
    log(f"obs: CLI --telemetry --trace --audit --report under ICT_FORENSICS=1 on {obs_shape}: "
        f"rc 0, wall {obs_wall:.2f}s; {len(recs)} events: " + ", ".join(names))
    log("  iterations: " + "; ".join(
        f"{r['index']}: {r['n_new_zaps']} new zaps, rfi_frac {r['rfi_frac']:.6f}, votes "
        f"{r['zaps_by_diagnostic']}" for r in iters))

    # The report: the audit and the quality summary.
    check(aud["mask_identical"] and aud["drift_within_bound"],
          f"the audit on the card: {aud}")
    check(qual and qual["n_zapped"] == int((IctbIO().load(obs_out).weights == 0).sum()),
          f"the report's quality summary {qual}")
    check(loops == aud["oracle_loops"], "the obs CLI's loops differ from the oracle's")
    log(f"  audit: mask identical, max score drift {aud['max_score_drift']:.4e} (bound "
        f"{aud['drift_bound']:g}; with the first fit/moments kernel {FIRST_KERNEL_DRIFT:.4e}), "
        f"oracle replay {aud['duration_s']:.1f}s; quality: zap_frac "
        f"{qual['zap_frac']:.6f}, {qual['channels_fully_zapped']} channels and "
        f"{qual['subints_fully_zapped']} subints fully zapped, termination "
        f"{qual['termination']}")

    # The capture: the kernels on both sides, the busy share of the loop.
    dev, evs = _device_events(_trace_file(tdir))
    fused_dev = [e for e in dev if e["cat"] == "kernel" and FUSED_KERNEL in e["name"]]
    tmpl_dev = [e for e in dev if e["cat"] == "kernel" and TEMPLATE_KERNEL in e["name"]]
    host = {n: sum(1 for e in evs if e.get("cat") == "user_annotation" and e.get("name") == n)
            for n in ("fused_fit_moments", "ordered_template")}
    check(len(fused_dev) == loops + 1, f"the capture holds {len(fused_dev)} {FUSED_KERNEL} "
          f"device kernels, want loops + 1 = {loops + 1}")
    check(len(fused_dev) == launches["obs_cli"], "device kernels != counted launches")
    check(len(tmpl_dev) == launches["obs_cli_template"],
          f"the capture holds {len(tmpl_dev)} {TEMPLATE_KERNEL} kernels, counted "
          f"{launches['obs_cli_template']}")
    check(host["fused_fit_moments"] >= loops, f"host spans {host}")
    log(f"  --trace capture ({os.path.getsize(_trace_file(tdir)) / 1e6:.1f} MB): device "
        f"kernels {FUSED_KERNEL} x{len(fused_dev)} (loops + the warm-up's), {TEMPLATE_KERNEL} "
        f"x{len(tmpl_dev)}; host spans (every thread's, the warm-up's included) "
        f"fused_fit_moments x{host['fused_fit_moments']}, ordered_template "
        f"x{host['ordered_template']}")
    # The loop's window: from its first template build (the warm-up's comes
    # first) to the capture's last device event; under ICT_FORENSICS=1 it
    # holds the host's attribution replays between iterations.
    t_loop = tmpl_dev[1]["ts"] if len(tmpl_dev) > 1 else fused_dev[1]["ts"]
    t_end = max(e["ts"] + e["dur"] for e in dev)
    trace_stats = _busy_report(dev, t_loop, t_end, "the CLI's cleaning loop (forensics on)")

    # The fused loop's host syncs, telemetry off and on.
    _, s_off = _count_syncs(lambda: clean_cube(D, w0, fcfg, device="cuda"))
    events.configure(os.path.join(work, "sync.jsonl"))
    try:
        _, s_on = _count_syncs(lambda: clean_cube(D, w0, fcfg, device="cuda"))
    finally:
        events.configure(None)
    check(len(s_on) == len(s_off), f"telemetry changed the fused route's host syncs: "
          f"{len(s_off)} -> {len(s_on)}")
    log(f"  fused route through clean_cube (upload included): host syncs {len(s_off)} with "
        f"telemetry off, {len(s_on)} on")

    # Device memory, the watchdog, the exposition.
    memory.update_process_gauges()
    snap = memory.device_snapshot()
    total = torch.cuda.mem_get_info()[1]  # ict: backend-init-ok(phase 1 made CUDA live)
    _, labeled = tracing.gauges_snapshot()
    peak = labeled.get(("route_hbm_peak_bytes", (("route", "stepwise"),)), 0.0)
    check(snap and snap[0]["bytes_limit"] == total, f"device_snapshot {snap}")
    check(peak > 0, "no stepwise route peak recorded")
    check(autoshard.device_memory_bytes() == memory.device_memory_bytes() == total,
          "autoshard and obs.memory disagree about the card's memory")
    with _stderr_to(io.StringIO()) as quiet:
        with device_probe.init_watchdog("smoke", timeout_s=0.1):
            time.sleep(0.5)
    check("backend_init_watchdog" not in quiet.getvalue()
          and "backend_init_watchdog_fired" not in tracing.counters_snapshot(),
          "the watchdog fired on a live card")
    fams = metrics.parse_exposition(metrics.render_prometheus())
    log(f"  memory: limit {total / 1e9:.2f} GB, in use {snap[0]['bytes_in_use'] / 1e9:.2f} GB, "
        f"allocator peak {snap[0]['peak_bytes_in_use'] / 1e9:.2f} GB, route peaks "
        + ", ".join(f"{dict(k[1])['route']} {v / 1e9:.2f} GB" for k, v in labeled.items()
                    if k[0] == "route_hbm_peak_bytes")
        + f"; watchdog silent on the live card; the exposition parses strictly "
        f"({len(fams)} families)")

    # The CLI's wall-clock with and without telemetry and forensics, on a
    # small archive (nsub cut for the NPZ writer).
    shape = (8, LOFAR[1], LOFAR[2])
    small = os.path.join(work, "small.npz")
    NpzIO().save(make_archive(*shape, seed=401), small)
    walls = {}
    os.chdir(work)
    try:
        for name in ("off", "on"):
            flags = ["--telemetry", os.path.join(work, "t.jsonl")] if name == "on" else []
            if name == "on":
                os.environ["ICT_FORENSICS"] = "1"
            t0 = time.perf_counter()
            try:
                rc = cli.main([small, "-q", "-l", *flags])
            finally:
                os.environ.pop("ICT_FORENSICS", None)
                events.configure(None)
            walls.setdefault(name, []).append(time.perf_counter() - t0)
            check(rc == 0, f"the timing CLI ({name}) returned {rc}")
    finally:
        os.chdir(cwd)
    log(f"  CLI wall on {shape}: without telemetry "
        + ", ".join(f"{w:.2f}" for w in walls["off"]) + " s; with --telemetry and "
        "ICT_FORENSICS=1 " + ", ".join(f"{w:.2f}" for w in walls["on"]) + " s")
    log(f"  CLI wall: the main path on {LOFAR} (defaults, NPZ) {lofar['wall']:.2f}s; on "
        f"{obs_shape} with --telemetry, ICT_FORENSICS=1, --audit and --trace, .ictb in and "
        f"out, {obs_wall:.2f}s")
    del out
    torch.cuda.empty_cache()
    return launches, {"trace": trace_stats, "fused": fused_stats}


def _count_syncs(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``; returns its
    result and the source lines of the synchronising calls it made."""
    import warnings

    import torch

    torch.cuda.synchronize()  # ict: backend-init-ok(phase 1 made CUDA live)
    torch.cuda.set_sync_debug_mode("warn")  # ict: backend-init-ok(phase 1 made CUDA live)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)  # ict: backend-init-ok(phase 1 made CUDA live)
    where = [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
             if "synchroniz" in str(w.message)]
    return out, where


def phase_fused(lofar) -> int:
    """run_fused on the main path's preprocessed cube; the device-resident
    loop's host syncs."""
    import numpy as np
    import torch

    from iterative_cleaner_tpu_torch.backends.torch_backend import (
        fused_clean,
        kernel_for,
        run_fused,
        to_device,
    )
    from iterative_cleaner_tpu_torch.config import CleanConfig
    from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
    from iterative_cleaner_tpu_torch.ops import fused_kernels as fk

    D, w0, ora = lofar["D"], lofar["w0"], lofar["oracle"]
    cfg = CleanConfig(backend="torch", fused=True)
    run_fused(D, w0, cfg)   # settles the allocator for this route; not counted
    torch.cuda.empty_cache()
    fk.fused_fit_moments.launches = 0
    t0 = time.perf_counter()
    test, w_final, loops, done, x, history = run_fused(D, w0, cfg)
    fused_host_s = time.perf_counter() - t0
    launches = fk.fused_fit_moments.launches
    log(f"fused loop (run_fused from host arrays): loops={loops} converged={done} x={x} "
        f"launches={launches} in {fused_host_s:.4f}s")
    check(launches == x, f"fused kernel launches {launches} != iterations {x}")
    check(np.array_equal(w_final, lofar["served"]), "fused mask differs from the CLI's")
    check(np.array_equal(w_final, ora.weights), "fused mask differs from the oracle's")
    check((loops, done) == (lofar["loops"], lofar["converged"]) == (ora.loops, ora.converged),
          "fused loops/converged differ from the CLI's / the oracle's")
    check(history.shape == lofar["history"].shape
          and np.array_equal(history, lofar["history"]), "fused history != CLI history")
    fin = np.isfinite(ora.test_results) & np.isfinite(test)
    drift = float(np.max(np.abs(test[fin] - ora.test_results[fin])
                         / np.maximum(np.abs(ora.test_results[fin]), 1.0)))
    log(f"  mask, loops, converged and history identical to the CLI and the oracle; "
        f"max score drift vs oracle {drift:.3e}")

    # The loop on the cube already on the card (run_fused after its upload),
    # with its final fetch: host syncs and device-resident wall-clock.
    dev = torch.device("cuda")
    Dt, wt = to_device(D, dev), to_device(w0, dev)
    vt = wt != 0
    kw = dict(max_iter=int(cfg.max_iter), pulse_region=tuple(cfg.pulse_region),
              use_kernel=kernel_for(cfg, D.shape[-1], dev),
              incremental=cfg.incremental_template)

    def loop_and_fetch() -> int:
        t, _w, _l, _d, n, _r, hist = fused_clean(
            Dt, wt, vt, float(cfg.chanthresh), float(cfg.subintthresh), **kw)
        torch.cat((t[None], hist[: n + 1])).cpu()
        return n

    loop_and_fetch()
    t0 = time.perf_counter()
    x_dev, syncs = _count_syncs(loop_and_fetch)
    device_s = time.perf_counter() - t0
    log(f"  fused_clean on the device-resident cube: x={x_dev} in {device_s:.4f}s, "
        f"host syncs {len(syncs)} {syncs}")
    check(x_dev == x, "the device-resident loop ran another number of iterations")
    check(len(syncs) <= x + 1, f"{len(syncs)} host syncs in {x} iterations + the final "
          f"fetch: {syncs}")
    del Dt, wt, vt
    m = torch.rand(LOFAR[0] * LOFAR[1], device="cuda") < 1e-3
    _, ns = _count_syncs(lambda: torch.nonzero_static(m, size=512, fill_value=0))
    log(f"  torch.nonzero_static on the card: {len(ns)} host syncs")
    del m

    t0 = time.perf_counter()
    step = clean_cube(D, w0, CleanConfig(backend="torch"), device="cuda")
    step_s = time.perf_counter() - t0
    check(np.array_equal(step.weights, w_final), "stepwise mask differs from the fused")
    log(f"  wall-clock from host arrays: fused {fused_host_s:.4f}s, stepwise "
        f"{step_s:.4f}s (its iterations: "
        + ", ".join(f"{i.duration_s:.4f}" for i in step.iterations) + ")")
    torch.cuda.empty_cache()
    return launches


def phase_chunked(lofar) -> int:
    """clean_cube with chunk_block=32 on the main path's cube (8 blocks)."""
    import numpy as np
    import torch

    from iterative_cleaner_tpu_torch.backends.torch_backend import INCREMENTAL_TEMPLATE_BUDGET
    from iterative_cleaner_tpu_torch.config import CleanConfig
    from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
    from iterative_cleaner_tpu_torch.ingest import pipeline
    from iterative_cleaner_tpu_torch.ops import fused_kernels as fk
    from iterative_cleaner_tpu_torch.parallel import chunked

    D, w0, ora = lofar["D"], lofar["w0"], lofar["oracle"]
    block = 32
    nblocks = -(-D.shape[0] // block)
    pipeline.reset_stats()
    fk.fused_fit_moments.launches = 0
    t0 = time.perf_counter()
    with _stderr_to(io.StringIO()) as said, _recording(chunked, "ChunkedTorchCleaner") as made:
        res = clean_cube(D, w0, CleanConfig(backend="torch", chunk_block=block), device="cuda")
    wall = time.perf_counter() - t0
    launches = fk.fused_fit_moments.launches
    st = pipeline.stats_snapshot()
    check(f"--chunk_block override; streaming {block}-subint blocks" in said.getvalue(),
          "clean_cube did not announce the chunked route")
    check(len(made) == 1, f"clean_cube made {len(made)} chunked backends")
    backend = made[0]
    up = backend.uploader
    log(f"chunked route (clean_cube, chunk_block={block}, {nblocks} blocks): loops={res.loops} "
        f"launches={launches} template_passes={backend.template_passes} in {wall:.3f}s "
        f"(iterations: " + ", ".join(f"{i.duration_s:.4f}" for i in res.iterations) + ")")
    check(launches == nblocks * len(res.iterations),
          f"chunked launches {launches} != {nblocks} blocks x {len(res.iterations)} iterations")
    check(np.array_equal(res.weights, ora.weights), "chunked mask differs from the oracle's")
    check((res.loops, res.converged, res.termination)
          == (ora.loops, ora.converged, ora.termination),
          "chunked loops/converged/termination differ from the oracle's")
    drift = _drift(res.test_results, ora.test_results)
    log(f"  max score drift vs oracle {drift:.4e} (with the first fit/moments kernel at the "
        f"main path {FIRST_KERNEL_DRIFT:.4e})")
    check(drift <= 5e-5, f"chunked score drift {drift:.4e} beyond the 5e-05 envelope")
    # The streamed template pass runs in iteration 1 and wherever more
    # profiles flipped than the sparse update's budget.
    flips = _flips(res.history)
    want = _sparse_rule(flips)[1]
    log(f"  profiles flipped before iterations 2..: {flips} (sparse budget "
        f"{INCREMENTAL_TEMPLATE_BUDGET}); template passes {backend.template_passes}, "
        f"expected {want}")
    check(backend.template_passes == want, "template passes differ from the budget rule")
    log(f"  staged {st['blocks']} blocks, {st['bytes'] / 1e9:.3f} GB: host->device "
        f"{st['effective_gbps']:.2f} GB/s over the upload busy time {st['upload_busy_s']:.4f}s "
        f"(of which host memcpy into pinned buffers {up.copy_s:.4f}s, "
        f"{st['bytes'] / 1e9 / up.copy_s:.2f} GB/s); stall {st['stall_s']:.4f}s, "
        f"overlap efficiency 1 - stall/upload = {st['overlap_efficiency']:.4f}")
    del backend, up, made

    # Staging through pinned buffers against registering the host cube.
    cudart = torch.cuda.cudart()  # ict: backend-init-ok(phase 1 made CUDA live)
    host = np.ascontiguousarray(D)
    slab = torch.empty((block, *D.shape[1:]), dtype=torch.float32, device="cuda")
    t0 = time.perf_counter()
    err = cudart.cudaHostRegister(host.ctypes.data, host.nbytes, 0)
    reg_s = time.perf_counter() - t0
    check(int(err) == 0, f"cudaHostRegister failed: {err}")
    try:
        src = torch.from_numpy(host)
        t0 = time.perf_counter()
        for lo in range(0, D.shape[0], block):
            slab.copy_(src[lo:lo + block], non_blocking=True)
        torch.cuda.synchronize()  # ict: backend-init-ok(phase 1 made CUDA live)
        direct_s = time.perf_counter() - t0
    finally:
        cudart.cudaHostUnregister(host.ctypes.data)
    pass_s = st["upload_busy_s"] / (st["blocks"] / nblocks)
    log(f"  registered host cube: cudaHostRegister {reg_s:.4f}s for {host.nbytes / 1e9:.3f} GB, "
        f"then one pass host->device {direct_s:.4f}s ({host.nbytes / 1e9 / direct_s:.2f} GB/s), "
        f"against {pass_s:.4f}s per pass through the pinned staging buffers")
    del slab, src
    torch.cuda.empty_cache()
    return launches


def phase_cli_routes() -> dict:
    """cli.main with --fused and with --chunk_block 8 on a small archive."""
    import numpy as np

    from iterative_cleaner_tpu_torch import cli
    from iterative_cleaner_tpu_torch.backends import torch_backend
    from iterative_cleaner_tpu_torch.config import CleanConfig
    from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
    from iterative_cleaner_tpu_torch.io.npz import NpzIO
    from iterative_cleaner_tpu_torch.io.synthetic import make_archive
    from iterative_cleaner_tpu_torch.ops import fused_kernels as fk
    from iterative_cleaner_tpu_torch.ops.preprocess import preprocess

    shape = (32, 128, 256)
    ar = make_archive(nsub=shape[0], nchan=shape[1], nbin=shape[2], seed=7)
    ora = clean_cube(*preprocess(ar), CleanConfig(backend="numpy"))
    launches = {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="ict_cli_") as tmp:
        path = os.path.join(tmp, "small.npz")
        NpzIO().save(ar, path)
        os.chdir(tmp)
        try:
            for name, flags in (("cli_fused", ["--fused"]),
                                ("cli_chunked", ["--chunk_block", "8"])):
                fk.fused_fit_moments.launches = 0
                with _stderr_to(io.StringIO()) as err, \
                        _recording(torch_backend, "start_precompile") as warm:
                    rc = cli.main([path, "-q", "-l", "--dump_masks", *flags])
                n = fk.fused_fit_moments.launches
                check(rc == 0, f"cli.main {flags} returned {rc}")
                warm_n = warm[0].launches if warm and warm[0] is not None else 0
                served = NpzIO().load(path + "_cleaned.npz").weights
                with np.load(path + "_cleaned.npz_masks.npz") as z:
                    loops = int(z["loops"])
                log(f"CLI {' '.join(flags)} on {shape}: loops={loops} launches={n} "
                    f"(warm-up {warm_n}), zapped {int((served == 0).sum())}")
                check(np.array_equal(served, ora.weights), f"CLI {flags}: mask != oracle")
                check(loops == ora.loops, f"CLI {flags}: loops != oracle")
                if name == "cli_chunked":
                    check("streaming 8-subint blocks" in err.getvalue(),
                          "the CLI's chunked route was not announced")
                    check(warm_n == 0 and n == 4 * loops,
                          f"CLI --chunk_block 8: launches {n} != 4 blocks x {loops}")
                else:
                    check(n - warm_n == loops, f"CLI --fused: launches {n - warm_n} != {loops}")
                launches[name] = n - warm_n
        finally:
            os.chdir(cwd)
    return launches


def phase_peak_model(lofar) -> None:
    """Peak device bytes of whole cleans per route at two shapes of the same
    bytes, fitted as cubes plus bytes per profile and held against
    parallel/autoshard's estimate; the masks of those cleans."""
    import gc

    import numpy as np
    import torch

    from iterative_cleaner_tpu_torch.config import CleanConfig
    from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
    from iterative_cleaner_tpu_torch.io.synthetic import make_preprocessed_cube
    from iterative_cleaner_tpu_torch.ops import stats
    from iterative_cleaner_tpu_torch.parallel import autoshard

    D, w0, ora = lofar["D"], lofar["w0"], lofar["oracle"]
    wide = (2048, 1024, 128)   # LOFAR's bytes, 8x its profiles
    Dn, wn = make_preprocessed_cube(*wide, seed=11, device="cuda")
    cubes = {LOFAR: (D, w0), wide: (Dn.cpu().numpy(), wn.cpu().numpy())}
    del Dn, wn
    masks = {}
    for route, kernel in (("kernel", True), ("plain", False)):
        peaks = {}
        for shape, (Dc, wc) in cubes.items():
            for fused in (False, True):
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()  # ict: backend-init-ok(phase 1 made CUDA live)
                base = torch.cuda.memory_allocated()
                res = clean_cube(Dc, wc, CleanConfig(backend="torch", kernel=kernel,
                                                     fused=fused, auto_shard=False),
                                 device="cuda")
                peaks[shape, fused] = torch.cuda.max_memory_allocated() - base
                masks[shape, route, fused] = res
            log(f"peak, {route} route at {shape}: stepwise "
                f"{peaks[shape, False] / Dc.nbytes:.4f}, fused "
                f"{peaks[shape, True] / Dc.nbytes:.4f} cubes "
                f"({max(peaks[shape, False], peaks[shape, True]) / 1e9:.4f} GB); "
                f"estimate {autoshard.working_set_bytes(shape, 4, kernel) / 1e9:.4f} GB")
        # peak = factor * cube + per_profile * profiles, from the worst loop
        # at each shape (both cubes have the same bytes).
        sa, sb, cube = LOFAR, wide, D.nbytes
        pa = max(peaks[sa, False], peaks[sa, True])
        pb = max(peaks[sb, False], peaks[sb, True])
        na, nb = sa[0] * sa[1], sb[0] * sb[1]
        per_profile = (pb - pa) / (nb - na)
        factor = (pa - per_profile * na) / cube
        log(f"  fitted {route} peak model: {factor:.4f} cubes + {per_profile:.2f} B per "
            f"profile (autoshard: {autoshard.PEAK_CUBE_FACTOR[route]} cubes + "
            f"{autoshard.PER_PROFILE_BYTES[route]} B)")
        for (shape, fused), peak in peaks.items():
            est = autoshard.working_set_bytes(shape, 4, kernel)
            check(peak <= est, f"{route} route at {shape} (fused={fused}): peak {peak} B "
                  f"exceeds the autoshard estimate {est} B")
    # The plain route in float64 (--x64, where the kernel is off), fitted
    # the same way against the float32 plain model scaled to 8-byte elements.
    peaks = {}
    for shape, (Dc, wc) in cubes.items():
        for fused in (False, True):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()  # ict: backend-init-ok(phase 1 made CUDA live)
            base = torch.cuda.memory_allocated()
            res = clean_cube(Dc, wc, CleanConfig(backend="torch", x64=True, fused=fused,
                                                 auto_shard=False), device="cuda")
            peaks[shape, fused] = torch.cuda.max_memory_allocated() - base
            masks[shape, "x64", fused] = res
        log(f"peak, plain route in float64 at {shape}: stepwise "
            f"{peaks[shape, False] / (2 * Dc.nbytes):.4f}, fused "
            f"{peaks[shape, True] / (2 * Dc.nbytes):.4f} float64 cubes "
            f"({max(peaks[shape, False], peaks[shape, True]) / 1e9:.4f} GB); estimate "
            f"{autoshard.working_set_bytes(shape, 8, False) / 1e9:.4f} GB")
    pa = max(peaks[LOFAR, False], peaks[LOFAR, True])
    pb = max(peaks[wide, False], peaks[wide, True])
    na, nb = LOFAR[0] * LOFAR[1], wide[0] * wide[1]
    per_profile = (pb - pa) / (nb - na)
    factor = (pa - per_profile * na) / (2 * D.nbytes)
    log(f"  fitted float64 plain peak model: {factor:.4f} float64 cubes + {per_profile:.2f} B "
        f"per profile (autoshard: {autoshard.PEAK_CUBE_FACTOR['plain']} + "
        f"{autoshard.PER_PROFILE_BYTES['plain'] * 2} B)")
    for (shape, fused), peak in peaks.items():
        est = autoshard.working_set_bytes(shape, 8, False)
        check(peak <= est, f"float64 plain route at {shape} (fused={fused}): peak {peak} B "
              f"exceeds the autoshard estimate {est} B")
    # Every clean of this phase gives the same mask: the oracle's at LOFAR.
    for (shape, route, fused), res in masks.items():
        ref = ora if shape == LOFAR else masks[shape, "kernel", False]
        check(np.array_equal(res.weights, ref.weights)
              and (res.loops, res.converged, res.termination)
              == (ref.loops, ref.converged, ref.termination),
              f"{route} route at {shape} (fused={fused}): mask, loops or termination differ")
    log(f"  every clean above: mask, loops and termination identical (the oracle's at "
        f"{LOFAR}; zapped {int((masks[wide, 'kernel', False].weights == 0).sum())} at {wide})")
    del cubes, masks

    # The same with the FFT diagnostic as one cuFFT call over the cube.
    pieces = stats.FFT_PIECE_ELEMENTS
    stats.FFT_PIECE_ELEMENTS = D.size
    try:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()  # ict: backend-init-ok(phase 1 made CUDA live)
        base = torch.cuda.memory_allocated()
        clean_cube(D, w0, CleanConfig(backend="torch", auto_shard=False), device="cuda")
        whole = (torch.cuda.max_memory_allocated() - base) / D.nbytes
    finally:
        stats.FFT_PIECE_ELEMENTS = pieces
    log(f"  kernel route with one FFT call over the cube instead of {pieces}-element "
        f"pieces: {whole:.4f} cubes")

    # cuFFT's workspace: through the caching allocator, or beside it?
    gc.collect()
    torch.cuda.empty_cache()
    x = torch.from_numpy(D).to("cuda")
    torch.backends.cuda.cufft_plan_cache.clear()
    torch.cuda.synchronize()  # ict: backend-init-ok(phase 1 made CUDA live)
    free0, reserved0 = torch.cuda.mem_get_info()[0], torch.cuda.memory_reserved()  # ict: backend-init-ok(phase 1 made CUDA live)
    torch.cuda.reset_peak_memory_stats()  # ict: backend-init-ok(phase 1 made CUDA live)
    base = torch.cuda.memory_allocated()
    y = torch.fft.rfft(x, dim=-1)
    torch.cuda.synchronize()  # ict: backend-init-ok(phase 1 made CUDA live)
    through = torch.cuda.max_memory_allocated() - base - y.numel() * y.element_size()
    beside = (free0 - torch.cuda.mem_get_info()[0]) - (torch.cuda.memory_reserved() - reserved0)  # ict: backend-init-ok(phase 1 made CUDA live)
    log(f"  one cuFFT R2C over the whole {LOFAR} cube: {through / 1e9:.3f} GB of workspace "
        f"through the caching allocator (counted by max_memory_allocated), "
        f"{beside / 1e9:.3f} GB allocated beside it")
    whole_diag = y.abs().amax(dim=-1)
    del y
    diff = float((stats.fft_diagnostic(x) - whole_diag).abs().max())
    log(f"  FFT diagnostic in pieces against one call: max |difference| {diff:.3e} "
        f"(cuFFT's batch size can move the last bits)")
    del x, whole_diag
    torch.cuda.empty_cache()


_WARMUP_CHILD = """
import json, sys, time
import numpy as np
from iterative_cleaner_tpu_torch.backends.torch_backend import start_precompile
from iterative_cleaner_tpu_torch.config import CleanConfig
from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
D, w0 = np.load(sys.argv[1]), np.load(sys.argv[2])
cfg = CleanConfig(backend="torch")
t0 = time.perf_counter()
th = start_precompile(D.shape, cfg, device="cuda") if sys.argv[3] == "1" else None
if th is not None:
    th.join()
warm_s = time.perf_counter() - t0
res = clean_cube(D, w0, cfg, device="cuda")
print(json.dumps({"warm_s": warm_s, "ran": th is not None,
                  "launches": 0 if th is None else th.launches,
                  "error": None if th is None or th.error is None else repr(th.error),
                  "iterations": [i.duration_s for i in res.iterations],
                  "mask": int((res.weights == 0).sum())}))
"""


def phase_warmup(lofar) -> None:
    """Iteration 1 of a clean in a fresh process, without and with the
    warm-up thread run (and joined) first."""
    import numpy as np

    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    with tempfile.TemporaryDirectory(prefix="ict_warm_") as tmp:
        paths = [os.path.join(tmp, n) for n in ("D.npy", "w0.npy")]
        np.save(paths[0], lofar["D"])
        np.save(paths[1], lofar["w0"])
        got = {}
        for warm in ("0", "1"):
            proc = subprocess.run([sys.executable, "-c", _WARMUP_CHILD, *paths, warm],
                                  capture_output=True, text=True, env=env, timeout=300)
            check(proc.returncode == 0, f"warm-up child failed:\n{proc.stderr}")
            got[warm] = json.loads(proc.stdout.strip().splitlines()[-1])
    off, on = got["0"], got["1"]
    check(on["ran"] and on["error"] is None and on["launches"] == 1,
          f"the warm-up did not run cleanly: {on}")
    check(off["mask"] == on["mask"] == int((lofar["served"] == 0).sum()),
          "a warm-up child's mask differs")
    log(f"fresh process, no warm-up: iterations "
        + ", ".join(f"{t:.4f}" for t in off["iterations"]) + " s")
    log(f"fresh process, warm-up first ({on['warm_s']:.3f}s, overlapping preprocessing "
        f"on the CLI path): iterations " + ", ".join(f"{t:.4f}" for t in on["iterations"])
        + " s")
    log(f"  iteration 1: {off['iterations'][0]:.4f}s without the warm-up, "
        f"{on['iterations'][0]:.4f}s with it (the CLI run above: "
        f"{lofar['iteration_s'][0]:.4f}s)")


#: Archives 1-7 of the batch phase (archive 0 is phase 4's seed-42 cube):
#: (seed, RFISpec fields or None for an archive without RFI), made already
#: preprocessed on the card; distinct seeds and RFI loads, so the archives
#: stop at different iterations.
BATCH_ARCHIVES = (
    (101, {}),
    (102, {"n_profile_spikes": 64, "n_dc_profiles": 32, "n_bad_channels": 4,
           "n_bad_subints": 2, "n_prezapped": 16}),
    (103, None),
    (104, {"n_profile_spikes": 256, "n_dc_profiles": 192, "n_bad_channels": 8,
           "n_bad_subints": 4, "n_prezapped": 128}),
    (105, {"n_bad_channels": 16, "amplitude": 10.0}),
    (106, {"n_profile_spikes": 16, "amplitude": 8.0}),
    (107, {"n_dc_profiles": 64, "n_bad_subints": 8, "amplitude": 20.0}),
)
#: ICT_HBM_BYTES of the batch phase's budgeted run: 9 GB, so that about 3
#: LOFAR archives fit one dispatch.
BATCH_BUDGET = 9 * 10**9


#: Archives of the batch phase the service phase submits as jobs: phase 4's
#: seed 42 and the first three of BATCH_ARCHIVES.
SERVICE_JOBS = 4


def _cube_archive(D, w0, seed):
    """An Intensity archive (dm 0) holding a preprocessed cube: what a
    telescope writing cleaned-ready cubes would hand the service."""
    import numpy as np

    from iterative_cleaner_tpu_torch.io.base import Archive

    nchan = D.shape[1]
    return Archive(data=D[:, None], weights=w0,
                   freqs=149.0 + 78.125 * (np.arange(nchan) / nchan - 0.5),
                   centre_frequency=149.0, dm=0.0, period=0.714,
                   source=f"SYNTH{seed}", filename=f"cube_seed{seed}")


def _batch_cubes(lofar):
    """The batch phase's 8 LOFAR cubes in host memory (archive 0 is phase
    4's preprocessed seed-42 cube).  The next SERVICE_JOBS - 1 are written
    as ``.ictb`` archives (the service phase's jobs) and their cubes are
    what ``preprocess`` makes of those archives, so the service's masks can
    be held bit for bit against this phase's."""
    import torch

    from iterative_cleaner_tpu_torch import native
    from iterative_cleaner_tpu_torch.io.synthetic import RFISpec, make_preprocessed_cube
    from iterative_cleaner_tpu_torch.ops.preprocess import preprocess

    check(native.available(), f"the native runtime did not build:\n{native.build_log()}")
    cubes, w0s = [lofar["D"]], [lofar["w0"]]
    work = os.path.dirname(lofar["path"])
    lofar["service_paths"] = []
    for seed, spec in BATCH_ARCHIVES:
        Dt, wt = make_preprocessed_cube(*LOFAR, seed=seed,
                                        rfi=None if spec is None else RFISpec(**spec),
                                        device="cuda")
        D, w0 = Dt.cpu().numpy(), wt.cpu().numpy()
        del Dt, wt
        if len(cubes) < SERVICE_JOBS:
            ar = _cube_archive(D, w0, seed)
            path = os.path.join(work, f"cube_seed{seed}.ictb")
            native.save_ictb(path, ar)
            lofar["service_paths"].append(path)
            D, w0 = preprocess(ar)
            del ar
        cubes.append(D)
        w0s.append(w0)
    torch.cuda.empty_cache()
    return cubes, w0s


def _batch_library(lofar) -> dict:
    """sharded_clean over 8 LOFAR cubes in one dispatch, each archive held
    against run_fused on it alone (dense template); then the same bucket on
    a budget that cuts it into several dispatches."""
    import gc

    import numpy as np
    import torch

    from iterative_cleaner_tpu_torch.backends.torch_backend import run_fused
    from iterative_cleaner_tpu_torch.config import CleanConfig
    from iterative_cleaner_tpu_torch.ops import fused_kernels as fk
    from iterative_cleaner_tpu_torch.parallel import autoshard, batch, sharded
    from iterative_cleaner_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    cubes, w0s = _batch_cubes(lofar)
    n = len(cubes)
    log(f"batch: {n} archives of {LOFAR} ({sum(c.nbytes for c in cubes) / 1e9:.2f} GB of cubes "
        f"in host memory), archives 1-{n - 1} made in {time.perf_counter() - t0:.1f}s")
    cfg = CleanConfig(backend="torch")
    mesh = make_mesh()

    singles, walls = [], []
    one_cfg = cfg.replace(fused=True, incremental_template=False)
    for D, w0 in zip(cubes, w0s):
        torch.cuda.synchronize()  # ict: backend-init-ok(phase 1 made CUDA live)
        t0 = time.perf_counter()
        singles.append(run_fused(D, w0, one_cfg))    # (test, w, loops, done, x, history)
        walls.append(time.perf_counter() - t0)
    xs = [r[4] for r in singles]
    log("  alone (run_fused, dense template): loops " + str([r[2] for r in singles])
        + f", iterations {xs}, zapped " + str([int((r[1] == 0).sum()) for r in singles])
        + ", walls " + ", ".join(f"{w:.4f}" for w in walls) + " s")
    check(len(set(xs)) > 1, f"every archive stopped at iteration {xs[0]}: the batch's "
          "freeze rule for an archive that stopped first would go untested")

    k = autoshard.archives_per_dispatch(LOFAR, cfg, "cuda")
    est = autoshard.batch_working_set_bytes(LOFAR, cfg, True, n)
    check(k is not None and k >= n, f"{n} LOFAR archives do not fit one dispatch (k={k})")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()  # ict: backend-init-ok(phase 1 made CUDA live)
    base = torch.cuda.memory_allocated()
    fk.fused_fit_moments.launches = 0
    t0 = time.perf_counter()
    test_b, w_b, loops_b, done_b = sharded.sharded_clean(cubes, w0s, cfg, mesh)
    wall = time.perf_counter() - t0
    launches = fk.fused_fit_moments.launches
    peak = torch.cuda.max_memory_allocated() - base
    score_diff = 0.0
    for j, (t1, w1, l1, d1, _x1, _h1) in enumerate(singles):
        check(np.array_equal(w_b[j], w1), f"batch archive {j}: mask differs from run_fused")
        check((int(loops_b[j]), bool(done_b[j])) == (l1, d1),
              f"batch archive {j}: loops/converged differ from run_fused")
        check(np.array_equal(np.isnan(test_b[j]), np.isnan(t1)),
              f"batch archive {j}: NaN scores differ")
        fin = ~np.isnan(t1)
        score_diff = max(score_diff, float(np.abs(test_b[j][fin] - t1[fin]).max()))
    check(np.array_equal(w_b[0], lofar["oracle"].weights), "batch archive 0: mask != oracle")
    # The service phase's references: the masks, loops and converged of the
    # archives it submits again as jobs.
    lofar["service_refs"] = [(w_b[j].copy(), int(loops_b[j]), bool(done_b[j]))
                             for j in range(SERVICE_JOBS)]
    # The ranks phase's: archives 0 and 1 (seeds 42 and 101) as .npy files
    # its ranks memory-map, with their scores, masks, loops and converged.
    rdir = os.path.join(os.path.dirname(lofar["path"]), "ranks")
    os.makedirs(rdir, exist_ok=True)
    lofar["ranks_inputs"], lofar["ranks_refs"] = {}, {}
    for j in (0, 1):
        lofar["ranks_inputs"][j] = (os.path.join(rdir, f"D{j}.npy"),
                                    os.path.join(rdir, f"w{j}.npy"))
        np.save(lofar["ranks_inputs"][j][0], cubes[j])
        np.save(lofar["ranks_inputs"][j][1], w0s[j])
        lofar["ranks_refs"][j] = (test_b[j].copy(), w_b[j].copy(), int(loops_b[j]),
                                  bool(done_b[j]))
    check(launches == max(xs), f"batch launches {launches} != the batch's iterations {max(xs)} "
          f"(not {n} archives x iterations)")
    check(peak <= est, f"batch peak {peak} B exceeds the batched estimate {est} B")
    log(f"  batch (sharded_clean, one dispatch of {n}; {k} would fit this card): masks, loops "
        f"and converged identical to each alone, archive 0's to the oracle; max |score "
        f"difference| {score_diff:.3e}; launches {launches} = iterations {max(xs)}")
    log(f"  batch wall {wall:.4f}s with the upload, against {sum(walls):.4f}s for the {n} "
        f"single run_fused; peak_device_mem {peak / 1e9:.2f} GB against the batched "
        f"estimate {est / 1e9:.2f} GB")

    # The loop on the batch already on the card, with its final fetch.
    Dt, wt = sharded.shard_batch(cubes, w0s, mesh)
    vt = wt != 0

    def loop_and_fetch():
        out = sharded.batched_fused_clean(Dt, wt, vt, 5.0, 5.0, max_iter=int(cfg.max_iter),
                                          pulse_region=tuple(cfg.pulse_region),
                                          use_kernel=True)
        torch.cat((out[0].reshape(-1), out[1].reshape(-1))).cpu()

    loop_and_fetch()
    t0 = time.perf_counter()
    _, syncs = _count_syncs(loop_and_fetch)
    dev_s = time.perf_counter() - t0
    log(f"  batched_fused_clean on the device-resident batch: {dev_s:.4f}s, host syncs "
        f"{len(syncs)} {syncs}")
    check(len(syncs) <= max(xs) + 1, f"{len(syncs)} host syncs in {max(xs)} iterations + the "
          f"final fetch: {syncs}")
    del Dt, wt, vt
    gc.collect()
    torch.cuda.empty_cache()

    # The same bucket on a budget: several dispatches, each under it.
    peaks = []
    real = batch.sharded_clean

    def measured(Db, w0b, *args, **kwargs):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()  # ict: backend-init-ok(phase 1 made CUDA live)
        b0 = torch.cuda.memory_allocated()
        out = real(Db, w0b, *args, **kwargs)
        peaks.append((len(Db), torch.cuda.max_memory_allocated() - b0))
        return out

    batch.sharded_clean = measured
    try:
        with _hbm_budget(BATCH_BUDGET):
            kb = autoshard.archives_per_dispatch(LOFAR, cfg, "cuda")
            items = [batch.BatchItem(path=f"archive {j}") for j in range(n)]
            fk.fused_fit_moments.launches = 0
            t0 = time.perf_counter()
            batch._finish_bucket(items, list(range(n)), list(cubes), list(w0s), cfg, mesh)
            wall_b = time.perf_counter() - t0
            launches_b = fk.fused_fit_moments.launches
    finally:
        batch.sharded_clean = real
    sizes = [m for m, _ in peaks]
    want_sizes = [min(kb, n - lo) for lo in range(0, n, max(kb, 1))]
    check(0 < kb < n and sizes == want_sizes,
          f"budget {BATCH_BUDGET}: {kb} per dispatch, dispatches {sizes}")
    for it, (_t1, w1, l1, d1, _x1, _h1) in zip(items, singles):
        check(it.error is None and np.array_equal(it.weights, w1)
              and (it.loops, it.converged) == (l1, d1),
              f"budgeted batch {it.path}: mask/loops/converged differ from run_fused")
    usable = BATCH_BUDGET * autoshard.HBM_USABLE_FRACTION
    for m, pk in peaks:
        check(pk <= usable and pk <= autoshard.batch_working_set_bytes(LOFAR, cfg, True, m),
              f"budgeted dispatch of {m}: peak {pk} B over the {usable:.0f} B usable budget "
              "or its estimate")
    want_launches = sum(max(xs[lo:lo + kb]) for lo in range(0, n, kb))
    check(launches_b == want_launches,
          f"budgeted launches {launches_b} != {want_launches} (per dispatch, its iterations)")
    log(f"  on a {BATCH_BUDGET / 1e9:.0f} GB budget (ICT_HBM_BYTES): {kb} archives per "
        f"dispatch, dispatches {sizes}, peaks "
        + ", ".join(f"{pk / 1e9:.2f}" for _, pk in peaks)
        + f" GB against {usable / 1e9:.2f} GB usable; masks identical; launches {launches_b}; "
        f"wall {wall_b:.4f}s")
    del cubes, w0s, singles, items, test_b, w_b
    gc.collect()
    return {"batch": launches, "batch_budget": launches_b}


def _batch_archive(args):
    """One archive of the batch CLI part, written to ``tmp``, and the
    oracle's result on it (run in a worker process)."""
    from iterative_cleaner_tpu_torch.config import CleanConfig
    from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
    from iterative_cleaner_tpu_torch.io.npz import NpzIO
    from iterative_cleaner_tpu_torch.io.synthetic import make_archive
    from iterative_cleaner_tpu_torch.ops.preprocess import preprocess

    tmp, nsub, nchan, nbin, seed = args
    ar = make_archive(nsub=nsub, nchan=nchan, nbin=nbin, seed=seed)
    path = os.path.join(tmp, f"b{seed}.npz")
    NpzIO().save(ar, path)
    return path, clean_cube(*preprocess(ar), CleanConfig(backend="numpy"))


def _batch_cli() -> dict:
    """cli.main with --sharded_batch, then --stream, then --resume, on 4
    archives of 8 x 1024 x 1024, one of 4 x 1024 x 1024 and a missing
    path."""
    import numpy as np

    from iterative_cleaner_tpu_torch import cli
    from iterative_cleaner_tpu_torch.io.npz import NpzIO
    from iterative_cleaner_tpu_torch.ops import fused_kernels as fk
    from iterative_cleaner_tpu_torch.parallel import batch

    nchan, nbin = LOFAR[1:]
    log(f"CLI batch: nsub cut from {LOFAR[0]} to 8 (and 4 for a second bucket): the NPZ "
        f"zlib writer runs at about 48 s per GB on this host; channels and bins stay at "
        f"full width ({nchan} x {nbin})")
    specs = [(8, 201), (8, 202), (8, 203), (8, 204), (4, 205)]
    cwd = os.getcwd()
    launches = {}
    with tempfile.TemporaryDirectory(prefix="ict_batch_cli_") as tmp:
        # One process per archive: the oracle's robust scalers loop in
        # Python over every channel and subint, which threads would
        # serialise on the interpreter lock.
        t0 = time.perf_counter()
        with ProcessPoolExecutor(len(specs), mp_context=mp.get_context("spawn")) as pool:
            made = list(pool.map(_batch_archive, [(tmp, nsub, nchan, nbin, seed)
                                                  for nsub, seed in specs]))
        paths = [p for p, _ in made]
        oracle = dict(made)
        del made
        log(f"  wrote {len(paths)} archives and ran the oracle on each in "
            f"{time.perf_counter() - t0:.1f}s ({len(specs)} processes); oracle loops "
            + str([oracle[p].loops for p in paths]))
        missing = os.path.join(tmp, "missing.npz")
        argv = paths[:2] + [missing] + paths[2:]
        bucket_a, bucket_b = paths[:4], paths[4:]

        def iterations(group):
            # An archive's iterations are its loops (a loop that never
            # converges runs max_iter and reports it).
            return max(oracle[p].loops for p in group) if group else 0

        os.chdir(tmp)
        try:
            for name, flags, todo in (("cli_sharded_batch", [], paths),
                                      ("cli_stream", ["--stream"], paths),
                                      ("cli_resume", ["--resume"], [paths[1]])):
                for p in todo:
                    if os.path.exists(p + "_cleaned.npz"):
                        os.remove(p + "_cleaned.npz")
                report = os.path.join(tmp, f"{name}.json")
                fk.fused_fit_moments.launches = 0
                t0 = time.perf_counter()
                with _stderr_to(io.StringIO()) as err, \
                        _recording(batch, "clean_directory_streaming") as streamed:
                    rc = cli.main([*argv, "-q", "--sharded_batch", *flags, "--report", report])
                wall = time.perf_counter() - t0
                n = fk.fused_fit_moments.launches
                reps = {r["path"]: r for r in json.load(open(report))}
                check(rc == 1, f"CLI {name}: rc {rc}, want 1 (the missing path)")
                check(reps[missing]["error"] and "ERROR cleaning" in err.getvalue(),
                      f"CLI {name}: the missing path was not reported")
                for p in paths:
                    r = reps[p]
                    check(r["error"] is None, f"CLI {name}: {p} failed: {r['error']}")
                    check(r["skipped"] == (p not in todo), f"CLI {name}: {p} skipped flag")
                    served = NpzIO().load(p + "_cleaned.npz").weights
                    check(np.array_equal(served, oracle[p].weights),
                          f"CLI {name}: {p} mask != oracle")
                    if p in todo:
                        check(r["loops"] == oracle[p].loops, f"CLI {name}: {p} loops")
                want = (iterations([p for p in bucket_a if p in todo])
                        + iterations([p for p in bucket_b if p in todo]))
                check(n == want, f"CLI {name}: launches {n} != {want} (per bucket, its "
                      "iterations)")
                check(bool(streamed) == (name == "cli_stream"),
                      f"CLI {name}: streaming dispatcher used: {bool(streamed)}")
                lines = open(os.path.join(tmp, "clean.log")).read().count(": Cleaned ")
                log(f"CLI --sharded_batch {' '.join(flags)}: rc={rc} wall={wall:.2f}s "
                    f"cleaned {len(todo)}, launches {n}, clean.log lines {lines}; masks = "
                    "oracle, the missing path isolated")
                launches[name] = n
            check(lines == 2 * len(paths) + 1, f"clean.log has {lines} lines")
        finally:
            os.chdir(cwd)
    return launches


def phase_batch(lofar) -> dict:
    """The directory batch: the library at LOFAR width, then the CLI."""
    launches = _batch_library(lofar)
    launches.update(_batch_cli())
    return launches


#: The sweep phase's grid: chanthresh x subintthresh, channel-major.
SWEEP_AXIS = (4.0, 5.0, 6.0)
#: ICT_HBM_BYTES of the sweep's budgeted runs: 20 GB cuts the 9-pair grid
#: into dispatches of 2 (one pair is ~6.5 GB on the plain route), 2 GB is
#: beneath one pair and beneath one in-memory clean on the kernel route
#: (~2.5 GB), so each pair is a solo clean through the chunked cleaner.
SWEEP_BUDGETS = (20 * 10**9, 2 * 10**9)


def _same_points(got, want) -> bool:
    import numpy as np

    return len(got) == len(want) and all(
        (p.chanthresh, p.subintthresh, p.loops, p.converged, p.rfi_frac)
        == (q.chanthresh, q.subintthresh, q.loops, q.converged, q.rfi_frac)
        and np.array_equal(p.weights, q.weights) for p, q in zip(got, want))


def _dispatch_iterations(dispatches) -> list[int]:
    """The batched iterations each recorded ``batched_fused_clean`` call
    ran: the largest of its archives' iteration counts."""
    return [int(out[4].max()) for out in dispatches]


def _sweep_library(lofar) -> dict:
    """The 3 x 3 grid at LOFAR in one dispatch against the solo cleans, then
    on a budget that chunks it and on one beneath a single pair."""
    import gc

    import numpy as np
    import torch

    from iterative_cleaner_tpu_torch.config import CleanConfig
    from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
    from iterative_cleaner_tpu_torch.models import sweep
    from iterative_cleaner_tpu_torch.ops import fused_kernels as fk
    from iterative_cleaner_tpu_torch.ops import template as tp
    from iterative_cleaner_tpu_torch.parallel import autoshard, sharded

    D, w0, ora = lofar["D"], lofar["w0"], lofar["oracle"]
    cfg = CleanConfig(backend="torch")
    pairs = sweep.grid(SWEEP_AXIS, SWEEP_AXIS)
    est = autoshard.batch_working_set_bytes(LOFAR, cfg, False, len(pairs))
    sweep.sweep_thresholds(D, w0, cfg, pairs[:1])   # settles the allocator; not counted
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()  # ict: backend-init-ok(phase 1 made CUDA live)
    base = torch.cuda.memory_allocated()
    fk.fused_fit_moments.launches = 0
    t_before = tp.build_template.launches
    with _recording(sharded, "batched_fused_clean") as dispatches:
        t0 = time.perf_counter()
        points = sweep.sweep_thresholds(D, w0, cfg, pairs)
        wall = time.perf_counter() - t0
    launches = fk.fused_fit_moments.launches
    t_launches = tp.build_template.launches - t_before
    peak = torch.cuda.max_memory_allocated() - base
    check(len(dispatches) == 1, f"the grid took {len(dispatches)} dispatches, not one")
    iters = _dispatch_iterations(dispatches)
    check(t_launches == sum(iters), f"the grid launched ordered_template {t_launches} times "
          f"over {iters} batched iterations: not once per iteration")
    check(launches == 0, f"the sweep launched the kernel {launches} times (it runs the "
          "plain route, as the JAX package's vmapped sweep does)")
    check(peak <= est, f"sweep peak {peak} B exceeds the sizing's {len(pairs)}-pair "
          f"estimate {est} B")
    del dispatches
    log(f"sweep: {len(pairs)} pairs {SWEEP_AXIS} x {SWEEP_AXIS} at {LOFAR} in one dispatch: "
        f"wall {wall:.4f}s (upload included; a template launch per pair: 0.5391s, cuBLAS's "
        f"template: 0.348s), peak_device_mem "
        f"{peak / 1e9:.2f} GB against the estimate {est / 1e9:.2f} GB "
        f"({est / len(pairs) / 1e9:.2f} GB per pair), kernel launches {launches}, "
        f"ordered_template launches {t_launches} (one per batched iteration: {iters[0]})")
    log("  chanthresh subintthresh: loops converged zapped")
    for p in points:
        log(f"  {p.chanthresh:.0f} {p.subintthresh:.0f}: {p.loops} {p.converged} "
            f"{int((p.weights == 0).sum())}")

    solo_walls = []
    for p in points:
        torch.cuda.synchronize()  # ict: backend-init-ok(phase 1 made CUDA live)
        t0 = time.perf_counter()
        solo = clean_cube(D, w0, cfg.replace(chanthresh=p.chanthresh,
                                             subintthresh=p.subintthresh), device="cuda")
        solo_walls.append(time.perf_counter() - t0)
        check(np.array_equal(p.weights, solo.weights)
              and (p.loops, p.converged) == (solo.loops, solo.converged)
              and p.rfi_frac == float((solo.weights == 0).mean()),
              f"sweep point ({p.chanthresh}, {p.subintthresh}) differs from its solo clean")
    mid = points[pairs.index((5.0, 5.0))]
    check(np.array_equal(mid.weights, ora.weights) and mid.loops == ora.loops,
          "the (5, 5) point differs from the oracle's mask")
    log(f"  every point's mask, loops and converged equal the solo clean (default route: "
        f"stepwise, kernel, incremental template); (5, 5) equals the oracle. Grid wall "
        f"{wall:.4f}s against {sum(solo_walls):.4f}s for the 9 solo cleans ("
        + ", ".join(f"{w:.4f}" for w in solo_walls) + ")")

    out = {"sweep": launches}
    for budget in SWEEP_BUDGETS:
        name = f"sweep_{budget // 10**9}gb"
        sizes = []
        real = sharded.batched_fused_clean

        def sized(Db, *args, **kwargs):
            sizes.append(Db.shape[0])
            return real(Db, *args, **kwargs)

        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()  # ict: backend-init-ok(phase 1 made CUDA live)
        base = torch.cuda.memory_allocated()
        fk.fused_fit_moments.launches = 0
        t_before = tp.build_template.launches
        sharded.batched_fused_clean = sized
        try:
            with _hbm_budget(budget), _stderr_to(io.StringIO()) as said, \
                    _recording(sharded, "batched_fused_clean") as dispatches:
                t0 = time.perf_counter()
                got = sweep.sweep_thresholds(D, w0, cfg, pairs)
                wall_b = time.perf_counter() - t0
        finally:
            sharded.batched_fused_clean = real
        n = fk.fused_fit_moments.launches
        t_n = tp.build_template.launches - t_before
        iters = _dispatch_iterations(dispatches)
        peak_b = torch.cuda.max_memory_allocated() - base
        usable = budget * autoshard.HBM_USABLE_FRACTION
        check(_same_points(got, points), f"{name}: the points differ from the one dispatch")
        per_pair = autoshard.batch_working_set_bytes(LOFAR, cfg, False, 1)
        if per_pair <= usable:
            k = int(usable // per_pair)
            want = [min(k, len(pairs) - lo) for lo in range(0, len(pairs), k)]
            check(sizes == want and len(set(sizes)) > 1, f"{name}: dispatches {sizes}, "
                  f"want {want} (chunks of unequal sizes)")
            check(f"in chunks of {k}" in said.getvalue(), f"{name}: chunking not announced")
            check(n == 0 and peak_b <= usable, f"{name}: launches {n}, peak {peak_b} B "
                  f"against {usable:.0f} B usable")
            check(t_n == sum(iters), f"{name}: ordered_template launched {t_n} times over "
                  f"the dispatches' batched iterations {iters}")
            route = f"dispatches {sizes}, ordered_template once per batched iteration ({t_n})"
        else:
            check(sizes == [] and "even for a single pair" in said.getvalue()
                  and said.getvalue().count("chunked clean:") == len(pairs),
                  f"{name}: the solo reroute through the chunked cleaner did not run")
            check(n > 0 and peak_b <= usable, f"{name}: launches {n}, peak {peak_b} B "
                  f"against {usable:.0f} B usable")
            route = "solo cleans through the chunked cleaner"
        log(f"  on a {budget / 1e9:.0f} GB budget (ICT_HBM_BYTES): {route}, wall {wall_b:.4f}s, "
            f"peak {peak_b / 1e9:.2f} GB against {usable / 1e9:.2f} GB usable, kernel "
            f"launches {n}; points identical")
        out[name] = n
    del points
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _sweep_cli() -> None:
    """cli.main --sweep 4:4 5:5 6:6 on a 32 x 1024 x 1024 archive: its
    _sweep.npz equals the library's points."""
    import numpy as np

    from iterative_cleaner_tpu_torch import cli
    from iterative_cleaner_tpu_torch.config import CleanConfig
    from iterative_cleaner_tpu_torch.io.npz import NpzIO
    from iterative_cleaner_tpu_torch.io.synthetic import make_archive
    from iterative_cleaner_tpu_torch.models import sweep
    from iterative_cleaner_tpu_torch.ops.preprocess import preprocess

    shape = (32, *LOFAR[1:])
    ar = make_archive(nsub=shape[0], nchan=shape[1], nbin=shape[2], seed=301)
    pairs = [(4.0, 4.0), (5.0, 5.0), (6.0, 6.0)]
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="ict_sweep_cli_") as tmp:
        path = os.path.join(tmp, "s.npz")
        NpzIO().save(ar, path)
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as out:
                rc = cli.main([path, "--sweep", "4:4", "5:5", "6:6"])
            wall = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        check(rc == 0, f"cli.main --sweep returned {rc}")
        lib = sweep.sweep_thresholds(*preprocess(ar), CleanConfig(backend="torch"), pairs)
        check(sweep.format_table(lib) in out.getvalue(), "the CLI's table != the library's")
        with np.load(path + "_sweep.npz") as z:
            check(np.array_equal(z["weights"], np.stack([p.weights for p in lib]))
                  and z["loops"].tolist() == [p.loops for p in lib]
                  and z["converged"].tolist() == [p.converged for p in lib],
                  "the CLI's _sweep.npz != the library's points")
        check(not os.path.exists(path + "_cleaned.npz")
              and not os.path.exists(os.path.join(tmp, "clean.log")),
              "--sweep wrote a cleaned archive or clean.log")
    log(f"CLI --sweep 4:4 5:5 6:6 on {shape} (nsub cut for the NPZ writer): rc 0, wall "
        f"{wall:.2f}s, _sweep.npz = the library's points (loops "
        f"{[p.loops for p in lib]}, zapped {[int((p.weights == 0).sum()) for p in lib]})")


def phase_sweep(lofar) -> dict:
    """The threshold sweep: the library at LOFAR, then the CLI."""
    launches = _sweep_library(lofar)
    _sweep_cli()
    return launches


#: The follow phase's blocks: LOFAR's 256 subints in 8 blocks of 32.
FOLLOW_BLOCK = 32
#: The service phase's session: the raw LOFAR archive's first blocks of
#: FOLLOW_BLOCK subints, held against the follow phase's alerts for them.
SERVICE_BLOCKS = 4


@contextlib.contextmanager
def _init_times(module, name: str):
    """Replace the class ``module.<name>`` for the ``with`` block by a
    subclass whose constructor records its wall-clock; yields that list."""
    orig = getattr(module, name)
    times = []

    class Timed(orig):
        def __init__(self, *args, **kwargs):
            t0 = time.perf_counter()
            super().__init__(*args, **kwargs)
            times.append(time.perf_counter() - t0)

    setattr(module, name, Timed)
    try:
        yield times
    finally:
        setattr(module, name, orig)


def _alert_key(alert) -> dict:
    d = alert.to_dict()
    d.pop("latency_s")
    return d


#: The block of the kernel-off session whose first submission dies in its
#: pass (the rollback check); it is then resubmitted.
ROLLBACK_BLOCK = 3


def _check_rollback(sess, data, weights) -> None:
    """A pass that dies leaves ``nsub``, ``prov_w`` and the block count as
    they were; the caller then resubmits the block."""
    import numpy as np

    nsub, prov, blocks = sess.state.nsub, sess.state.prov_w.copy(), sess.blocks_ingested

    class Dying:
        def step(self, w_prev):
            raise RuntimeError("a pass that dies")

    sess._backend = lambda D, w0: Dying()
    try:
        sess.ingest(data, weights)
        check(False, "the dying pass did not raise")
    except RuntimeError as exc:
        check("dies" in str(exc), f"unexpected error {exc!r}")
    finally:
        del sess._backend
    check(sess.state.nsub == nsub and np.array_equal(sess.state.prov_w, prov)
          and sess.blocks_ingested == blocks, "a failed pass did not roll the append back")
    log(f"  rollback: a pass that died left nsub={nsub}, prov_w and the block count as "
        "they were; the block is resubmitted")


def _follow_library(lofar) -> dict:
    """OnlineSession on the card at LOFAR, 8 blocks of 32 subints: per-block
    latency and launches, alerts identical to the kernel-off session,
    finalize identical to the oracle, rollback of a failing pass."""
    import gc

    import numpy as np
    import torch

    from iterative_cleaner_tpu_torch.config import CleanConfig
    from iterative_cleaner_tpu_torch.obs import tracing
    from iterative_cleaner_tpu_torch.online import OnlineSession, SessionMeta
    from iterative_cleaner_tpu_torch.ops import fused_kernels as fk
    from iterative_cleaner_tpu_torch.parallel import chunked

    ar, ora = lofar["archive"], lofar["oracle"]
    nblocks = ar.nsub // FOLLOW_BLOCK
    meta = SessionMeta.from_archive(ar)
    sess = OnlineSession(meta, CleanConfig(backend="torch"), alert_iters=2, device="cuda")
    plain = OnlineSession(meta, CleanConfig(backend="torch", kernel=False), alert_iters=2,
                          device="cuda")
    # The kernel-off session takes the kernel session's host inputs: the
    # same values from the same slabs (both passes only read them), and the
    # host's baseline removal over the slab is most of a block's latency.
    shared, host_s = [], []
    inputs = sess.state.provisional_inputs

    def timed_inputs():
        t0 = time.perf_counter()
        shared[:] = [inputs()]
        host_s.append(time.perf_counter() - t0)
        return shared[0]

    sess.state.provisional_inputs = timed_inputs
    plain.state.provisional_inputs = lambda: shared[0]
    rows = []
    counted = {"online_blocks_ingested": 0.0, "online_block_n": 0.0}
    for b in range(nblocks):
        lo = b * FOLLOW_BLOCK
        data, weights = ar.data[lo:lo + FOLLOW_BLOCK], ar.weights[lo:lo + FOLLOW_BLOCK]
        before = fk.fused_fit_moments.launches
        snap = tracing.snapshot()
        with _init_times(chunked, "SlabUploader") as up:
            alert = sess.ingest(data, weights)
        for key in counted:
            counted[key] += tracing.delta(snap, key)
        n = fk.fused_fit_moments.launches - before
        # The pass streams nsub_total / pass_block slabs per iteration.
        want = (alert.nsub_total // FOLLOW_BLOCK) * alert.pass_iterations
        check(n == want, f"follow block {b}: launches {n} != {want} (slabs x iterations)")
        if b == ROLLBACK_BLOCK:
            _check_rollback(plain, data, weights)
        before = fk.fused_fit_moments.launches
        off = plain.ingest(data, weights)
        n_off = fk.fused_fit_moments.launches - before
        check(n_off == 0, f"follow block {b}: the kernel-off session launched the kernel "
              f"{n_off} times")
        check(_alert_key(off) == _alert_key(alert),
              f"follow block {b}: the alerts differ between the kernel and plain routes")
        rows.append((alert, n, sum(up), host_s[-1], off.latency_s, n_off))
    del sess.state.provisional_inputs, plain.state.provisional_inputs
    lofar["follow_alerts"] = [_alert_key(row[0]) for row in rows[:SERVICE_BLOCKS]]
    check(sess._pass_block == FOLLOW_BLOCK, f"pass_block {sess._pass_block}")
    check(counted == {"online_blocks_ingested": nblocks, "online_block_n": nblocks},
          f"the kernel session's counters {counted}, want {nblocks} blocks")
    log(f"  session counters (kernel session): online_blocks_ingested "
        f"{counted['online_blocks_ingested']:.0f}, online_block phase count "
        f"{counted['online_block_n']:.0f}")
    log(f"follow, OnlineSession on the card, {nblocks} blocks of {FOLLOW_BLOCK} subints of "
        f"{LOFAR}, alert_iters=2:")
    for alert, n, up_s, in_s, off_s, _ in rows:
        log(f"  block {alert.block_index} (subints {alert.subint_lo}:{alert.subint_hi}): "
            f"latency {alert.latency_s:.4f}s (host baseline removal over the slab "
            f"{in_s:.4f}s, uploader set-up {up_s:.4f}s), {alert.n_new_zaps} new zaps, "
            f"rfi_frac {alert.provisional_rfi_frac:.4f}, {alert.pass_iterations} iterations, "
            f"converged {alert.pass_converged}, kernel launches {n}; the kernel-off "
            f"session's block (host inputs shared) {off_s:.4f}s")
    log("  alerts identical (every field but latency) between the kernel and plain routes")
    out = {"follow_passes_kernel": sum(row[1] for row in rows),
           "follow_passes_plain": sum(row[5] for row in rows)}
    del plain

    gc.collect()
    torch.cuda.empty_cache()
    fk.fused_fit_moments.launches = 0
    t0 = time.perf_counter()
    fin = sess.finalize()
    fin_s = time.perf_counter() - t0
    out["follow_finalize"] = fk.fused_fit_moments.launches
    res = fin.result
    check(np.array_equal(res.weights, ora.weights)
          and (res.loops, res.converged) == (ora.loops, ora.converged),
          "finalize's mask differs from the oracle's")
    check(out["follow_finalize"] == res.loops + 1,
          f"finalize launches {out['follow_finalize']} != {res.loops} loops + 1 warm-up")
    log(f"  finalize (the canonical clean of the assembled archive): {fin_s:.2f}s, mask "
        f"identical to the oracle's, {fin.to_dict()}, kernel launches "
        f"{out['follow_finalize']} (loops + the warm-up's 1)")
    del sess, fin
    gc.collect()
    return out


def _write_prefix(full, path: str, n: int) -> None:
    """Atomically rewrite ``path`` with the first ``n`` subints of ``full``."""
    from dataclasses import replace

    from iterative_cleaner_tpu_torch.io.npz import NpzIO

    part = replace(full, data=full.data[:n].copy(), weights=full.weights[:n].copy())
    NpzIO().save(part, path + ".tmp")
    os.replace(path + ".tmp", path)


def _follow_cli() -> int:
    """follow_archive on a 16 x 1024 x 1024 archive grown in 4 atomic
    rewrites of 4 subints; then one ``python -m iterative_cleaner_tpu_torch
    --follow`` process on the complete file."""
    import numpy as np

    from iterative_cleaner_tpu_torch.config import CleanConfig
    from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
    from iterative_cleaner_tpu_torch.io.npz import NpzIO
    from iterative_cleaner_tpu_torch.io.synthetic import make_archive
    from iterative_cleaner_tpu_torch.io.tail import eos_sentinel
    from iterative_cleaner_tpu_torch.online.follow import follow_archive
    from iterative_cleaner_tpu_torch.ops import fused_kernels as fk
    from iterative_cleaner_tpu_torch.ops.preprocess import preprocess

    nsub, step = 16, 4
    full = make_archive(nsub=nsub, nchan=LOFAR[1], nbin=LOFAR[2], seed=302)
    ora = clean_cube(*preprocess(full), CleanConfig(backend="numpy"))
    log(f"CLI follow: nsub cut from {LOFAR[0]} to {nsub} for the NPZ writer (each growth "
        f"step rewrites the file); channels and bins at full width; oracle loops {ora.loops}")
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="ict_follow_") as tmp:
        path = os.path.join(tmp, "grow.npz")
        writes = []

        def grow(n):
            t0 = time.perf_counter()
            _write_prefix(full, path, n)
            writes.append(time.perf_counter() - t0)

        grow(step)
        steps = iter([lambda n=n: grow(n) for n in range(2 * step, nsub + 1, step)]
                     + [lambda: open(eos_sentinel(path), "w").close()])
        os.chdir(tmp)
        fk.fused_fit_moments.launches = 0
        try:
            t0 = time.perf_counter()
            with _stderr_to(io.StringIO()) as said:
                rep = follow_archive(path, CleanConfig(backend="torch"), poll_s=0.0,
                                     idle_timeout_s=600,
                                     sleep=lambda s: next(steps, lambda: None)())
            wall = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        launches = fk.fused_fit_moments.launches
        text = said.getvalue()
        check(rep.error is None and text.count("provisional zap") == nsub // step,
              f"follow_archive: {text.count('provisional zap')} alerts, want {nsub // step}")
        check("end of stream after 4 block(s)" in text, "no end-of-stream line")
        served = NpzIO().load(rep.out_path).weights
        check(np.array_equal(served, ora.weights) and rep.loops == ora.loops,
              "follow_archive's mask differs from the oracle's on the finished file")
        log(f"  follow_archive in-process: {nsub // step} growth steps (rewrites "
            + ", ".join(f"{w:.2f}" for w in writes) + " s), wall "
            f"{wall:.2f}s of which the rewrites {sum(writes[1:]):.2f}s; 4 alerts; mask = the "
            f"oracle's; kernel launches {launches}")

        os.remove(rep.out_path)
        repo = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "iterative_cleaner_tpu_torch", "--follow",
                               "--follow_poll", "0.01", "-q", path],
                              capture_output=True, text=True, env=env, cwd=tmp, timeout=300)
        sub_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"--follow process exited {proc.returncode}:\n"
              f"{proc.stderr[-2000:]}")
        check(np.array_equal(NpzIO().load(path + "_cleaned.npz").weights, ora.weights),
              "the --follow process's mask differs from the oracle's")
        log(f"  python -m iterative_cleaner_tpu_torch --follow on the complete file (.eos "
            f"present): rc 0 in {sub_s:.2f}s, mask = the oracle's")
    return launches


def phase_follow(lofar) -> dict:
    """The online session: the library at LOFAR, then the CLI's tail."""
    launches = _follow_library(lofar)
    launches["follow_cli"] = _follow_cli()
    return launches


#: The service phase's replica: its dispatch worker's thread is named for it.
SERVICE_REPLICA = "chip-smoke"


@contextlib.contextmanager
def _launches_by_thread():
    """Tally each kernel wrapper's launches by the host thread that made
    them, for the ``with`` block: ``fused_fit_moments`` through
    ``ops/fused_kernels.launch`` (one call per launch) and
    ``ordered_template`` through ``ops/template._library`` (fetched once per
    launch).  Yields {kernel: {thread name: launches}}.  The wrappers' own
    counts stay the authority; the tallies must sum to them."""
    import threading

    from iterative_cleaner_tpu_torch.ops import fused_kernels as fk
    from iterative_cleaner_tpu_torch.ops import template as tp

    tally = {"fused_fit_moments": {}, "ordered_template": {}}
    lock = threading.Lock()

    def note(kernel):
        name = threading.current_thread().name
        with lock:
            tally[kernel][name] = tally[kernel].get(name, 0) + 1

    real_launch, real_library = fk.launch, tp._library

    def launch(*args, **kwargs):
        out = real_launch(*args, **kwargs)
        note("fused_fit_moments")
        return out

    def library():
        lib = real_library()
        note("ordered_template")
        return lib

    fk.launch, tp._library = launch, library
    try:
        yield tally
    finally:
        fk.launch, tp._library = real_launch, real_library


def _service_path(thread_name: str) -> str:
    """The path a launch belongs to, by its host thread: the phase's
    replica's dispatch worker (jobs), another replica's (``serve
    --smoke``), this script's main thread (references), else the HTTP
    request threads and the finish's warm-up (the session)."""
    if thread_name == f"ict-serve-dispatch-{SERVICE_REPLICA}":
        return "service"
    if thread_name.startswith("ict-serve-dispatch-"):
        return "serve_smoke"
    if thread_name == "MainThread":
        return "service_reference"
    return "service_session"


def _ictb_weights(path, nsub, nchan):
    """The weights of an ``.ictb`` file, read without its cube (they follow
    the header and the channel frequencies)."""
    import ctypes

    import numpy as np

    from iterative_cleaner_tpu_torch import native

    return np.fromfile(path, dtype=np.float32, count=nsub * nchan,
                       offset=ctypes.sizeof(native.IctbHeader) + 8 * nchan).reshape(nsub, nchan)


def _http(base, route, body=None):
    import urllib.request

    data = None if body is None else body if isinstance(body, bytes) else json.dumps(body).encode()
    with urllib.request.urlopen(urllib.request.Request(base + route, data=data),
                                timeout=600) as resp:
        return json.load(resp)


def phase_service(lofar, card) -> tuple[dict, dict]:
    """The serving replica on the card: the native runtime, four LOFAR
    ``.ictb`` jobs in one coalesced dispatch, a session alongside, an
    audited job, ``serve --smoke``."""
    import threading
    import traceback

    import numpy as np
    import torch

    from iterative_cleaner_tpu_torch import native
    from iterative_cleaner_tpu_torch.config import CleanConfig
    from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
    from iterative_cleaner_tpu_torch.io.ictb import IctbIO
    from iterative_cleaner_tpu_torch.io.npz import NpzIO
    from iterative_cleaner_tpu_torch.io.synthetic import make_archive
    from iterative_cleaner_tpu_torch.obs import tracing
    from iterative_cleaner_tpu_torch.online.blocks import encode_block
    from iterative_cleaner_tpu_torch.online.state import SessionMeta
    from iterative_cleaner_tpu_torch.ops import fused_kernels as fk
    from iterative_cleaner_tpu_torch.ops import template as tp
    from iterative_cleaner_tpu_torch.ops.preprocess import preprocess
    from iterative_cleaner_tpu_torch.service import CleaningService, ServeConfig, daemon
    from iterative_cleaner_tpu_torch.service.jobs import TERMINAL

    ar, nsub, nchan = lofar["archive"], LOFAR[0], LOFAR[1]
    work = os.path.join(os.path.dirname(lofar["path"]), "service")
    os.makedirs(work)

    # The native runtime: built on this host, the route counted, bit for bit
    # the numpy preprocess phase 4 ran on the same archive.
    check(native.available(), f"the native runtime did not build:\n{native.build_log()}")
    log(f"native runtime {native.library_path().name}; build log: "
        + (native.build_log().strip().splitlines()[0] if native.build_log() else "(built before)"))
    snap = tracing.snapshot()
    t0 = time.perf_counter()
    D, w0 = preprocess(ar)
    native_s = time.perf_counter() - t0
    check(tracing.delta(snap, "preprocess_native") == 1
          and tracing.delta(snap, "preprocess_numpy") == 0,
          "preprocess fell back to numpy with the native runtime built")
    check(D.tobytes() == lofar["D"].tobytes() and w0.tobytes() == lofar["w0"].tobytes(),
          "the native preprocess differs from the numpy one")
    log(f"preprocess of the seed-42 {LOFAR} archive on the host: native {native_s:.3f}s, numpy "
        f"{lofar['preprocess_s']:.3f}s (phase 4), bit for bit ({card})")
    del D, w0

    # The session's blocks encoded beside the .ictb write (the client's
    # work), the jobs' archives: seed 42 here, 101-103 from the batch phase.
    meta = SessionMeta.from_archive(ar).to_dict()
    with ThreadPoolExecutor(SERVICE_BLOCKS) as pool:
        t0 = time.perf_counter()
        futs = [pool.submit(encode_block, ar.data[b * FOLLOW_BLOCK:(b + 1) * FOLLOW_BLOCK],
                            ar.weights[b * FOLLOW_BLOCK:(b + 1) * FOLLOW_BLOCK])
                for b in range(SERVICE_BLOCKS)]
        path42 = os.path.join(work, "lofar_seed42.ictb")
        IctbIO().save(ar, path42)
        write_s = time.perf_counter() - t0
        payloads = [f.result() for f in futs]
        encode_s = time.perf_counter() - t0
    paths = [path42, *lofar["service_paths"]]
    check(len(paths) == SERVICE_JOBS, f"{len(paths)} job archives")
    log(f"wrote {path42} ({os.path.getsize(path42) / 1e9:.2f} GB) in {write_s:.2f}s; "
        f"{SERVICE_BLOCKS} session blocks encoded in {encode_s:.2f}s "
        f"({sum(len(p) for p in payloads) / 1e6:.1f} MB on the wire)")
    small = os.path.join(work, "audit.npz")
    NpzIO().save(make_archive(nsub=4, nchan=16, nbin=64, seed=99), small)

    cfg = ServeConfig(spool_dir=os.path.join(work, "spool"), port=0, replica_id=SERVICE_REPLICA,
                      bucket_cap=SERVICE_JOBS, deadline_s=60.0, quiet=True, device="cuda",
                      clean=CleanConfig(backend="torch", quiet=True, no_log=True))
    snap = tracing.snapshot()
    labeled = tracing.labeled_snapshot()
    # The card's byte rate as an operator pins it: the jobs' cost records
    # then hold the kernels' bytes of every iteration against it.
    saved_gbps = os.environ.get("ICT_ROOFLINE_GBPS")
    os.environ["ICT_ROOFLINE_GBPS"] = repr(PEAK_BYTES_PER_S / 1e9)
    fk.fused_fit_moments.launches = tp.build_template.launches = 0
    with _launches_by_thread() as tally:
        svc = CleaningService(cfg)
        svc.start()
        try:
            check(svc.ctx.on_card, "the replica does not hold its cubes on the card")
            base = f"http://127.0.0.1:{svc.port}"
            dispatching = threading.Event()
            sess, sess_err = {}, []

            def session():
                try:
                    sid = _http(base, "/sessions", meta)["id"]
                    rows = []
                    for b, payload in enumerate(payloads):
                        if b == 1:   # one block while the job bucket dispatches
                            check(dispatching.wait(300), "the job bucket never dispatched")
                        t0 = time.perf_counter()
                        alert = _http(base, f"/sessions/{sid}/blocks", payload)
                        rows.append((alert, t0, time.perf_counter()))
                    t0 = time.perf_counter()
                    sess["finish"] = _http(base, f"/sessions/{sid}/finish", b"")
                    sess["finish_s"] = time.perf_counter() - t0
                    sess["rows"] = rows
                except BaseException:   # re-raised on the main thread
                    sess_err.append(traceback.format_exc())

            th = threading.Thread(target=session, name="chip-smoke-session-client")
            th.start()
            t_submit = time.perf_counter()
            ids = [_http(base, "/jobs", {"path": p})["id"] for p in paths]
            audit_id = _http(base, "/jobs", {"path": small, "audit": True})["id"]
            t_run = t_done = None
            while True:
                jobs = [_http(base, f"/jobs/{i}") for i in ids]
                states = [j["state"] for j in jobs]
                now = time.perf_counter()
                if t_run is None and any(s != "pending" for s in states):
                    t_run = now
                    dispatching.set()
                if t_done is None and any(s in TERMINAL for s in states):
                    t_done = now
                if all(s in TERMINAL for s in states) or now - t_submit > 600:
                    break
                time.sleep(0.01)
            jobs_s = time.perf_counter() - t_submit
            for j, p, (w, loops, done) in zip(jobs, paths, lofar["service_refs"]):
                check(j["state"] == "done" and j["served_by"] == "sharded",
                      f"job {p}: {j['state']} via {j['served_by']!r}: {j.get('error')}")
                check(np.array_equal(_ictb_weights(j["out_path"], nsub, nchan), w),
                      f"job {p}: mask differs from the batch phase's")
                check((j["loops"], j["converged"]) == (loops, done),
                      f"job {p}: loops/converged differ from the batch phase's")
            waits = [j["finished_s"] - j["submitted_s"] for j in jobs]
            log(f"{SERVICE_JOBS} LOFAR .ictb jobs over HTTP: done in {jobs_s:.2f}s (submit to "
                f"done per job " + ", ".join(f"{s:.2f}" for s in waits) + " s), served "
                f"'sharded', masks, loops and converged identical to the batch phase's; "
                f"dispatch seen at +{t_run - t_submit:.2f}s, first job done at "
                f"+{t_done - t_submit:.2f}s ({card})")

            # The audited job's bucket is parked below its cap: drain flushes it.
            check(_http(base, "/drain", {})["draining"], "drain refused")
            while _http(base, f"/jobs/{audit_id}")["state"] not in TERMINAL:
                time.sleep(0.01)
            check(svc.auditor.drain(120), "the shadow audit did not finish")
            health = _http(base, "/healthz")
            audit_job = _http(base, f"/jobs/{audit_id}")
            check(audit_job["state"] == "done" and audit_job["served_by"] == "sharded",
                  f"audited job: {audit_job['state']} via {audit_job['served_by']!r}")
            check(tracing.delta(snap, "audit_runs") >= 1 and health["audits_run"] >= 1
                  and health["audit_divergences"] == 0,
                  f"audit: {health['audits_run']} run, {health['audit_divergences']} divergences")
            check(health["backend"] == "torch", f"/healthz backend {health['backend']!r}")
            log(f"  audited 4x16x64 job: served 'sharded', audit mask identical "
                f"{audit_job['audit_result']['mask_identical']}, drift "
                f"{audit_job['audit_result'].get('max_score_drift')}; /healthz backend "
                f"{health['backend']}, audits_run {health['audits_run']}, divergences "
                f"{health['audit_divergences']}")

            # serve --smoke: its own replica, archive and audit, over HTTP.
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = daemon.serve_main(["--smoke", "-q"])
            smoke_s = time.perf_counter() - t0
            said = json.loads(out.getvalue().strip().splitlines()[-1])
            check(rc == 0 and said["smoke"] == "ok" and said["backend"] == "torch",
                  f"serve --smoke: rc {rc}, {said}")
            log(f"  serve --smoke: {json.dumps(said)} in {smoke_s:.2f}s")
            # The cost record lands on the manifest after the bucket's
            # emission; read it back now.
            cost = _http(base, f"/jobs/{ids[0]}").get("cost", {})
            log(f"  job cost record: device_s {cost.get('device_s')}, batch_k "
                f"{cost.get('batch_k')}, bytes_accessed {cost.get('bytes_accessed')}, "
                f"attainment {cost.get('attainment')} (of {PEAK_BYTES_PER_S / 1e12} TB/s), "
                f"phases {cost.get('phases')}")
            check(cost.get("attainment") is not None and 0 < cost["attainment"] <= 1,
                  f"the job's attainment {cost.get('attainment')} is not a share of the "
                  "card's byte rate")

            th.join(900)
            check(not th.is_alive(), "the session client did not finish")
            check(not sess_err, "the session failed:\n" + "".join(sess_err))
        finally:
            svc.stop()
            if saved_gbps is None:
                os.environ.pop("ICT_ROOFLINE_GBPS")
            else:
                os.environ["ICT_ROOFLINE_GBPS"] = saved_gbps
        # The wrappers' own counts over the tallied block (the references
        # below launch too).
        totals = {"fused_fit_moments": fk.fused_fit_moments.launches,
                  "ordered_template": tp.build_template.launches}

    # Counters over the phase: one coalesced dispatch of 4, no fall back.
    key = ("coalesce_batch_size_total",
           (("k", str(SERVICE_JOBS)), ("shape_bucket", "x".join(map(str, LOFAR)))))
    k4 = tracing.labeled_snapshot().get(key, 0.0) - labeled.get(key, 0.0)
    check(k4 == 1, f"{k4} coalesced dispatches of {SERVICE_JOBS} LOFAR cubes, want 1")
    counters = tracing.counters_snapshot()
    for name in ("service_oracle_fallbacks", "service_backend_demotions"):
        check(counters.get(name, 0.0) == 0, f"{name} = {counters.get(name)}: the card was bypassed")
    check(tracing.delta(snap, "preprocess_numpy") == 0
          and tracing.delta(snap, "preprocess_native") >= SERVICE_JOBS,
          "a preprocess of the phase fell back to numpy")
    log(f"  counters: coalesce_batch_size_total{{k={SERVICE_JOBS}}} +{k4:.0f}, oracle fallbacks 0, "
        f"demotions 0, preprocess native +{tracing.delta(snap, 'preprocess_native'):.0f}, numpy +0")
    stages = {name: (tracing.delta(snap, f"{name}_s"), tracing.delta(snap, f"{name}_n"))
              for name in ("service_load", "service_dispatch", "service_emit", "online_pass")}
    log("  stage means over the phase (host clock): " + ", ".join(
        f"{name} {t / n:.3f}s x{n:.0f}" for name, (t, n) in stages.items() if n)
        + " (service_load: the .ictb read and the native preprocess, before the loader's "
        "two SHA-256 passes)")

    # The session: each alert the follow phase's, the finish the canonical
    # clean of the same subints on another route (the fused loop).
    for b, (alert, t0, t1) in enumerate(sess["rows"]):
        got = {k: v for k, v in alert.items() if k != "latency_s"}
        check(got == lofar["follow_alerts"][b],
              f"session block {b}: the alert differs from the follow phase's")
    overlap = sess["rows"][1][1] < t_done
    check(overlap, "session block 1 was not posted while the job bucket dispatched")
    fin = sess["finish"]
    nsub_s = SERVICE_BLOCKS * FOLLOW_BLOCK
    prefix = dataclasses.replace(ar, data=ar.data[:nsub_s], weights=ar.weights[:nsub_s])
    ref = clean_cube(*preprocess(prefix), CleanConfig(backend="torch", fused=True), device="cuda")
    with np.load(fin["out_path"]) as z:
        served = z["weights"]
    check(fin["state"] == "done" and np.array_equal(served, ref.weights)
          and (fin["loops"], fin["converged"]) == (ref.loops, ref.converged),
          "the session's finish differs from the fused clean of the same subints")
    log(f"session over HTTP, {SERVICE_BLOCKS} blocks of {FOLLOW_BLOCK} subints: alerts identical "
        "to the follow phase's; block latency (server / round trip) "
        + ", ".join(f"{a['latency_s']:.3f}/{t1 - t0:.3f}" for a, t0, t1 in sess["rows"])
        + f" s; block 1 posted at +{sess['rows'][1][1] - t_submit:.2f}s, inside the job "
        f"dispatch; finish {sess['finish_s']:.2f}s (NPZ write included), mask identical to the "
        f"fused clean of the same {nsub_s} subints, loops {fin['loops']}")
    del prefix, ref, served

    # Launches by path, their sum each wrapper's own count.
    paths_by = {}
    for kernel, counts in tally.items():
        total = totals[kernel]
        check(sum(counts.values()) == total,
              f"{kernel}: {sum(counts.values())} launches tallied by thread, the wrapper "
              f"counted {total}")
        split = {}
        for name, n in counts.items():
            split[_service_path(name)] = split.get(_service_path(name), 0) + n
        for path in ("service", "service_session", "serve_smoke"):
            check(split.get(path, 0) > 0, f"{kernel} was launched no time on the {path} path")
        paths_by[kernel] = split
        log(f"  {kernel} launches: " + ", ".join(f"{k} {v}" for k, v in sorted(split.items())))
    want = sum((a["nsub_total"] // FOLLOW_BLOCK) * a["pass_iterations"]
               for a, _t0, _t1 in sess["rows"]) + fin["loops"] + 1
    check(paths_by["fused_fit_moments"]["service_session"] == want,
          f"session launches {paths_by['fused_fit_moments']['service_session']} != slabs x "
          f"iterations of its passes + the finish's loops + its warm-up ({want})")
    torch.cuda.empty_cache()
    keep = ("service", "service_session", "serve_smoke")
    return ({k: paths_by["fused_fit_moments"][k] for k in keep},
            {k: paths_by["ordered_template"][k] for k in keep})


#: The fleet phase's replicas: ``a`` parks its cubes, ``b`` drains.
FLEET_REPLICAS = ("fleet-a", "fleet-b")
#: The fleet's three smokes, each the port's CLI in a process of its own on
#: the card: (label, arguments after ``python -m iterative_cleaner_tpu_torch``).
FLEET_SMOKES = (
    ("serve-fleet --smoke", ["serve-fleet", "--smoke", "-q"]),
    ("serve-fleet --smoke --autoscale act", ["serve-fleet", "--smoke", "--autoscale", "act", "-q"]),
    ("prove --smoke", ["prove", "--smoke", "-q"]),
)
#: How far the card's allocated bytes may stay above their value before the
#: fleet phase once its replicas have stopped.
FLEET_MEMORY_SLACK = 64 << 20
#: The fleet phase's time limit, the smokes included.
FLEET_PHASE_S = 120


def _main_line(main, argv) -> tuple[int, str]:
    """A sub-command's rc and its standard output."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _start_smokes(work):
    """Start the fleet's three smokes together, each in its own process;
    returns {label: (process, start, stdout path, stderr path)}."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = {}
    for i, (label, argv) in enumerate(FLEET_SMOKES):
        out, err = (os.path.join(work, f"smoke{i}.{k}") for k in ("out", "err"))
        with open(out, "w") as fo, open(err, "w") as fe:
            proc = subprocess.Popen([sys.executable, "-m", "iterative_cleaner_tpu_torch", *argv],
                                    stdout=fo, stderr=fe, env=env, cwd=work)
        procs[label] = (proc, time.perf_counter(), out, err)
    return procs


def _finish_smokes(procs, timeout_s: float) -> None:
    """Wait for the smokes (each one's seconds to its exit), check each
    verdict and print its line; kill any still running."""
    deadline = time.perf_counter() + timeout_s
    ends = {}
    try:
        while len(ends) < len(procs):
            check(time.perf_counter() < deadline,
                  f"{sorted(set(procs) - set(ends))} still running after {timeout_s:.0f}s")
            for label, (proc, *_rest) in procs.items():
                if label not in ends and proc.poll() is not None:
                    ends[label] = time.perf_counter()
            time.sleep(0.05)
        for label, (proc, t0, out, err) in procs.items():
            with open(out) as fh:
                lines = fh.read().strip().splitlines()
            with open(err) as fh:
                tail = fh.read()[-4000:]
            check(proc.returncode == 0 and lines, f"{label}: rc {proc.returncode}\n{tail}")
            said = json.loads(lines[-1])
            want = "pass" if label.startswith("prove") else "ok"
            check(said.get("prove", said.get("smoke")) == want, f"{label}: {lines[-1]}\n{tail}")
            if "autoscale" in label:
                check(said["scaled_up"] and said["scaled_down"], f"{label}: did not scale up and down")
            log(f"  {label}: {ends[label] - t0:.1f}s, {lines[-1]}")
    finally:
        _kill_smokes(procs)


def _kill_smokes(procs) -> None:
    for proc, *_rest in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def phase_fleet(lofar, card) -> tuple[dict, dict]:
    """The fleet tier on the card: a router in front of two replicas takes
    the service phase's four LOFAR ``.ictb`` jobs through a failover; the
    ``explain``, ``trends`` and ``campaign`` sub-commands and ``fleet_top``
    against it; the three smokes in processes of their own."""
    import gc
    import threading
    import urllib.request

    import numpy as np
    import torch

    from iterative_cleaner_tpu_torch import cli
    from iterative_cleaner_tpu_torch.config import CleanConfig
    from iterative_cleaner_tpu_torch.fleet import explain as fleet_explain
    from iterative_cleaner_tpu_torch.fleet.router import (
        FleetConfig,
        FleetRouter,
        _merged_counters_equal,
    )
    from iterative_cleaner_tpu_torch.obs import metrics as obs_metrics
    from iterative_cleaner_tpu_torch.obs import tracing
    from iterative_cleaner_tpu_torch.ops import fused_kernels as fk
    from iterative_cleaner_tpu_torch.ops import template as tp
    from iterative_cleaner_tpu_torch.service import CleaningService, ServeConfig
    from iterative_cleaner_tpu_torch.service.jobs import TERMINAL
    from iterative_cleaner_tpu_torch.service.worker import DispatchWorker

    t_phase = time.perf_counter()
    nsub, nchan = LOFAR[0], LOFAR[1]
    root = os.path.dirname(lofar["path"])
    work = os.path.join(root, "fleet")
    os.makedirs(work)
    paths = [os.path.join(root, "service", "lofar_seed42.ictb"), *lofar["service_paths"]]
    refs = dict(zip(paths, lofar["service_refs"]))
    check(len(refs) == SERVICE_JOBS and all(os.path.exists(p) for p in paths),
          "the service phase's .ictb archives are missing")
    smokes = _start_smokes(work)

    gc.collect()
    torch.cuda.synchronize()  # ict: backend-init-ok(phase 1 made CUDA live)
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()  # ict: backend-init-ok(phase 1 made CUDA live)
    limit = torch.cuda.get_device_properties(0).total_memory  # ict: backend-init-ok(phase 1 made CUDA live)
    snap = tracing.snapshot()
    counters0 = tracing.counters_snapshot()
    # The router hashes a submitted file for its result cache only below
    # this size; a LOFAR .ictb is 1.07 GB.
    saved_max = os.environ.get("ICT_FLEET_CACHE_MAX_BYTES")
    os.environ["ICT_FLEET_CACHE_MAX_BYTES"] = str(4 << 30)
    dispatches = {}
    real_dispatch = DispatchWorker._dispatch_sharded

    def counted(self, entries):
        dispatches.setdefault(threading.current_thread().name, []).append(len(entries))
        return real_dispatch(self, entries)

    def serve_cfg(tag, **kw):
        return ServeConfig(spool_dir=os.path.join(work, f"spool_{tag}"), port=0, replica_id=tag,
                           quiet=True, device="cuda",
                           clean=CleanConfig(backend="torch", quiet=True, no_log=True), **kw)

    def metrics_text(base):
        with urllib.request.urlopen(base + "/fleet/metrics", timeout=60) as resp:
            return resp.read().decode()

    fk.fused_fit_moments.launches = tp.build_template.launches = 0
    DispatchWorker._dispatch_sharded = counted
    svcs = []
    router = None
    try:
        with _launches_by_thread() as tally:
            svc_a = CleaningService(serve_cfg(FLEET_REPLICAS[0], deadline_s=3600.0, bucket_cap=8))
            svcs.append(svc_a)
            svc_a.start()
            svc_b = CleaningService(serve_cfg(FLEET_REPLICAS[1], deadline_s=1.0, bucket_cap=2,
                                              coalesce=2))
            svcs.append(svc_b)
            svc_b.start()
            urls = [f"http://127.0.0.1:{s.port}" for s in svcs]
            router = FleetRouter(FleetConfig(
                replicas=tuple(urls), port=0, poll_interval_s=0.25, dead_after=2, quiet=True,
                spool_dir=os.path.join(work, "router_spool")))
            router.start()
            base = f"http://127.0.0.1:{router.port}"
            router.poll_tick()

            # (a) Four LOFAR jobs through the router; a dies with its cubes parked.
            t_submit = time.perf_counter()
            jobs = {p: _http(base, "/jobs", {"path": p, "shape": list(LOFAR)}) for p in paths}
            submit_s = time.perf_counter() - t_submit
            on_a = [p for p, j in jobs.items() if j["replica_id"] == FLEET_REPLICAS[0]]
            check(0 < len(on_a) < len(paths),
                  f"placements {[j['replica_id'] for j in jobs.values()]}: want both replicas")
            # Stop a once its cubes are parked and b has served its own.
            deadline = time.perf_counter() + 300
            while (_http(urls[0], "/healthz").get("bucketed_cubes", 0) < len(on_a)
                   or any(_http(base, f"/jobs/{j['id']}")["state"] not in TERMINAL
                          for p, j in jobs.items() if p not in on_a)):
                check(time.perf_counter() < deadline, "replica a never parked its cubes, or "
                      "replica b never served its own")
                time.sleep(0.05)
            check(_http(urls[0], "/healthz")["backend"] == "torch", "replica a is not on torch")
            router.poll_tick()
            torch.cuda.synchronize()  # ict: backend-init-ok(phase 1 made CUDA live)
            peak_both = torch.cuda.max_memory_allocated()
            t_kill = time.perf_counter()
            svc_a.stop()
            while router.metrics.counter_total("fleet_failovers_total") < 1:
                check(time.perf_counter() - t_kill < 120, "no failover within 120 s")
                time.sleep(0.01)
            failover_s = time.perf_counter() - t_kill
            while True:
                states = {p: _http(base, f"/jobs/{j['id']}") for p, j in jobs.items()}
                if all(s["state"] in TERMINAL for s in states.values()):
                    break
                check(time.perf_counter() - t_submit < 600, "fleet jobs not terminal in 600 s")
                time.sleep(0.05)
            jobs_s = time.perf_counter() - t_submit
            for p, st in states.items():
                w, loops, done = refs[p]
                check(st["state"] == "done" and st["served_by"] == "sharded",
                      f"fleet job {p}: {st['state']} via {st.get('served_by')!r}: {st.get('error')}")
                check(np.array_equal(_ictb_weights(st["out_path"], nsub, nchan), w)
                      and (st["loops"], st["converged"]) == (loops, done),
                      f"fleet job {p}: mask, loops or converged differ from the batch phase's")
            torch.cuda.synchronize()  # ict: backend-init-ok(phase 1 made CUDA live)
            peak_after = torch.cuda.max_memory_allocated()
            health_b = _http(urls[1], "/healthz")
            check(health_b["backend"] == "torch", f"replica b /healthz backend {health_b['backend']!r}")
            failovers = router.metrics.counter_total("fleet_failovers_total")
            completed = router.metrics.counter_value("fleet_jobs_completed_total", {"state": "done"})
            done_delta = tracing.delta(snap, "service_jobs_done")
            check(done_delta == len(paths) and completed == len(paths) and failovers >= 1,
                  f"exactly once: {done_delta:.0f} replica completions, {completed:.0f} fleet "
                  f"completions, {failovers:.0f} failovers for {len(paths)} jobs")
            counters = tracing.counters_snapshot()
            for name in ("service_oracle_fallbacks", "service_backend_demotions"):
                check(counters.get(name, 0.0) == counters0.get(name, 0.0),
                      f"{name} moved: the card was bypassed")
            fams = obs_metrics.parse_exposition(metrics_text(base))
            check(_merged_counters_equal(fams),
                  "/fleet/metrics: merged counters differ from the per-replica sums")
            check(peak_both < limit and peak_after < limit,
                  f"peak device memory {peak_both} / {peak_after} B over the card's {limit} B")
            log(f"{len(paths)} LOFAR .ictb jobs through the router: submitted in {submit_s:.2f}s, "
                f"all done in {jobs_s:.2f}s; submit to done per job "
                + ", ".join(f"{s['finished_s'] - s['submitted_s']:.2f}" for s in states.values())
                + f" s; {len(on_a)} parked on {FLEET_REPLICAS[0]} failed over "
                f"{failover_s:.2f}s after its stop; masks, loops and converged identical to the "
                f"batch phase's; {failovers:.0f} failovers, {done_delta:.0f} completions ({card})")
            log("  dispatches per replica (cubes each): " + ", ".join(
                f"{name.rsplit('-', 1)[-1]} {sizes}" for name, sizes in sorted(dispatches.items()))
                + f"; peak device memory with both replicas alive (b's own jobs served, a's "
                f"parked) {peak_both / 2**30:.2f} GiB, over the whole lane "
                f"{peak_after / 2**30:.2f} GiB, of {limit / 2**30:.1f} GiB (each replica sizes "
                "its buckets against the whole card)")
            log("  0 oracle fallbacks, 0 demotions, /healthz backend torch on both replicas, "
                "merged /fleet/metrics counters equal the per-replica sums")

            # (b) The sub-commands against the lane's router.
            exp_id = jobs[next(p for p in paths if p not in on_a)]["id"]
            rc, out = _main_line(cli.main, ["explain", exp_id, "--router", base, "--json"])
            report = json.loads(out.strip().splitlines()[-1])
            check(rc == 0 and set(report.get("planes") or {}) == set(fleet_explain.PLANES),
                  f"explain: rc {rc}, planes {sorted(report.get('planes') or {})}")
            rc, out = _main_line(cli.main, ["trends", "--router", base])
            check(rc == 0, f"trends: rc {rc}")
            manifest = os.path.join(work, "campaign.json")
            with open(manifest, "w") as fh:
                json.dump({"name": "chip-smoke", "tenant": "survey", "archives": paths}, fh)
            done0 = tracing.counters_snapshot().get("service_jobs_done", 0)
            t0 = time.perf_counter()
            rc, out = _main_line(cli.main, ["campaign", manifest, "--router", base, "--poll_s",
                                            "0.1", "--timeout_s", "120", "--json", "-q"])
            campaign_s = time.perf_counter() - t0
            view = json.loads(out.strip().splitlines()[-1])
            moved = tracing.counters_snapshot().get("service_jobs_done", 0) - done0
            cost, rollup = view.get("cost") or {}, view.get("rollup") or {}
            check(rc == 0 and view["state"] == "done"
                  and view["archives"]["done"] == len(paths) and moved == 0
                  and cost.get("cache_hits") == len(paths) and rollup.get("jobs") == len(paths)
                  and cost.get("jobs_costed") == len(paths),
                  f"campaign: rc {rc}, state {view.get('state')}, archives {view.get('archives')}, "
                  f"{moved:.0f} new completions, cost {cost}, rollup jobs {rollup.get('jobs')}")
            top = subprocess.run([sys.executable, os.path.join(
                os.path.dirname(os.path.abspath(__file__)), "tools_torch", "fleet_top.py"),
                "--router", base, "--json"], capture_output=True, text=True, timeout=120)
            check(top.returncode == 0 and json.loads(top.stdout)["router_id"] == router.router_id,
                  f"fleet_top: rc {top.returncode}\n{top.stderr[-2000:]}")
            log(f"  explain {exp_id}: rc 0, planes {sorted(report['planes'])}; trends: rc 0; "
                f"campaign of the same {len(paths)} archives: done in {campaign_s:.2f}s, "
                f"{cost['cache_hits']} fleet-cache hits, 0 new completions, QA roll-up of "
                f"{rollup['jobs']} jobs, cost row device_s {cost.get('device_s')} avoided "
                f"{cost.get('avoided_device_s')}; tools_torch/fleet_top.py --json: rc 0")
            totals = {"fused_fit_moments": fk.fused_fit_moments.launches,
                      "ordered_template": tp.build_template.launches}
    except BaseException:
        _kill_smokes(smokes)
        raise
    finally:
        if router is not None:
            router.stop()
        for s in svcs:
            s.stop()
        DispatchWorker._dispatch_sharded = real_dispatch
        if saved_max is None:
            os.environ.pop("ICT_FLEET_CACHE_MAX_BYTES")
        else:
            os.environ["ICT_FLEET_CACHE_MAX_BYTES"] = saved_max

    del svcs, svc_a, svc_b, router
    gc.collect()
    torch.cuda.synchronize()  # ict: backend-init-ok(phase 1 made CUDA live)
    mem1 = torch.cuda.memory_allocated()
    check(mem1 - mem0 <= FLEET_MEMORY_SLACK,
          f"device memory after the fleet stopped: {mem1} B, {mem0} B before the phase")
    log(f"  device memory allocated before the phase {mem0 / 2**20:.1f} MiB, after both replicas "
        f"stopped {mem1 / 2**20:.1f} MiB")
    paths_by = {}
    for kernel, counts in tally.items():
        check(sum(counts.values()) == totals[kernel],
              f"{kernel}: {sum(counts.values())} launches tallied by thread, the wrapper "
              f"counted {totals[kernel]}")
        fleet = sum(n for name, n in counts.items()
                    if name.startswith("ict-serve-dispatch-fleet-"))
        check(fleet > 0, f"{kernel} was launched no time on the replicas' dispatch threads")
        paths_by[kernel] = {"fleet": fleet}
        log(f"  {kernel} launches by thread: {dict(sorted(counts.items()))}")

    # (c) The three smokes, started with the phase.
    _finish_smokes(smokes, 300)
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    check(phase_s <= FLEET_PHASE_S, f"the fleet phase took {phase_s:.1f}s, over {FLEET_PHASE_S}s")
    return {"fleet": paths_by["fused_fit_moments"]["fleet"]}, {
        "fleet": paths_by["ordered_template"]["fleet"]}


#: The CLI-surface phase's small archive (nsub x nchan x nbin), 2-pol
#: Coherence, as the CLI-routes phase's.
CLI_SMALL = (32, 128, 256)


def _fake_psrchive():
    """``tests/fake_psrchive.py`` (numpy only) loaded by path as a module
    named ``psrchive``: the card's host has no PSRCHIVE bindings."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "fake_psrchive.py")
    spec = importlib.util.spec_from_file_location("psrchive", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, path


def _reset_counts() -> None:
    from iterative_cleaner_tpu_torch.ops import fused_kernels as fk
    from iterative_cleaner_tpu_torch.ops import template as tp

    fk.fused_fit_moments.launches = 0
    tp.build_template.launches = tp.build_template.launches_f64 = 0


def _counts() -> tuple[int, int, int]:
    """(fused_fit_moments, ordered_template, its float64 instantiation)."""
    from iterative_cleaner_tpu_torch.ops import fused_kernels as fk
    from iterative_cleaner_tpu_torch.ops import template as tp

    return (fk.fused_fit_moments.launches, tp.build_template.launches,
            tp.build_template.launches_f64)


def _surface_ar(ar, fake, tmp, ora) -> dict:
    """``.ar`` and ``-z`` through ``cli.main`` with the defaults on cuda."""
    import numpy as np

    from iterative_cleaner_tpu_torch import cli
    from iterative_cleaner_tpu_torch.io import psrchive_io

    path = os.path.join(tmp, "obs.ar")
    fake.write_fake_ar(path, data=ar.data, weights=ar.weights, freqs=ar.freqs,
                       centre_frequency=ar.centre_frequency, dm=ar.dm, period=ar.period,
                       source=ar.source, mjd_start=ar.mjd_start, mjd_end=ar.mjd_end,
                       state="Coherence", dedispersed=ar.dedispersed)
    calls = {"set_weight": 0, "get_Profile": 0}
    set_weight, get_profile = fake._Integration.set_weight, fake.FakeArchive.get_Profile

    def counted_set_weight(self, c, w):
        calls["set_weight"] += 1
        return set_weight(self, c, w)

    def counted_get_profile(self, *args):
        calls["get_Profile"] += 1
        return get_profile(self, *args)

    fake._Integration.set_weight = counted_set_weight
    fake.FakeArchive.get_Profile = counted_get_profile
    try:
        _reset_counts()
        t0 = time.perf_counter()
        rc = cli.main([path, "-q", "-l", "--dump_masks"])
        wall = time.perf_counter() - t0
        n_fit, n_t, n_64 = _counts()
    finally:
        fake._Integration.set_weight, fake.FakeArchive.get_Profile = set_weight, get_profile
    check(rc == 0, f"cli.main on the .ar returned {rc}")
    out = psrchive_io.PsrchiveIO().load(path + "_cleaned.ar")
    with np.load(path + "_cleaned.ar_masks.npz") as z:
        loops = int(z["loops"])
    check(np.array_equal(out.weights, ora.weights) and loops == ora.loops,
          "the .ar clean's mask or loops differ from the oracle's")
    check(out.npol == 2 and out.state == "Coherence" and out.data.tobytes() == ar.data.tobytes(),
          "the cleaned .ar changed its data, pol count or state")
    changed = int((ar.weights != out.weights).sum())
    check(calls == {"set_weight": changed, "get_Profile": 0},
          f"the save touched {calls}, not the {changed} zapped cells alone")
    check(n_fit > 0 and n_t > 0 and n_64 == 0, f"the .ar clean launched {n_fit}, {n_t}, {n_64}")
    log(f"CLI {os.path.basename(path)} {CLI_SMALL} 2-pol Coherence, defaults on cuda: rc 0 in "
        f"{wall:.2f}s, loops={loops}, mask == oracle, {changed} zapped cells rewritten by "
        f"set_weight and no profile; launches fused_fit_moments {n_fit}, ordered_template "
        f"{n_t} (the warm-up's included)")
    launches = {"cli_ar": (n_fit, n_t)}

    try:
        import matplotlib  # noqa: F401
        have = True
    except ImportError as exc:
        have, why = False, exc
    # The reference's name, <name>_<chanthresh>_<subintthresh>.png, with the
    # thresholds as the CLI's defaults print.
    defaults = cli.config_from_args(cli.build_parser().parse_args([path]))
    png = "%s_%s_%s.png" % (path, defaults.chanthresh, defaults.subintthresh)
    # The clean above wrote the archive: remove it, so that only the -z run
    # can show that it saved the archive before the plot.
    os.remove(path + "_cleaned.ar")
    _reset_counts()
    with _stderr_to(io.StringIO()) as err:
        rc = cli.main([path, "-q", "-l", "-z"])
    n_fit, n_t, _ = _counts()
    saved = os.path.exists(path + "_cleaned.ar")
    if have:
        check(rc == 0 and os.path.exists(png) and saved,
              f"-z: rc {rc}, no {os.path.basename(png)} or no archive saved")
        log(f"CLI -z: rc 0, {os.path.basename(png)} written ({os.path.getsize(png)} bytes)")
    else:
        said = err.getvalue()
        check(rc == 1 and "matplotlib" in said and not os.path.exists(png),
              f"-z without matplotlib: rc {rc}, stderr {said!r}")
        check(saved, "-z: the archive was not saved before the plot failed")
        log(f"CLI -z: matplotlib does not import here ({why}); the run failed as the JAX "
            f"driver's does: rc 1 after the save, stderr {said.strip()!r}")
    check(n_fit > 0 and n_t > 0, "the -z clean launched no kernel")
    launches["cli_print_zap"] = (n_fit, n_t)
    return launches


def _surface_x64_cli(ar, tmp, ora) -> dict:
    """``--x64`` through ``cli.main`` on a small NPZ, stepwise and chunked."""
    import numpy as np

    from iterative_cleaner_tpu_torch import cli
    from iterative_cleaner_tpu_torch.io.npz import NpzIO

    npz = os.path.join(tmp, "small.npz")
    NpzIO().save(ar, npz)
    launches = {}
    for name, flags in (("cli_x64", []), ("cli_x64_chunked", ["--chunk_block", "8"])):
        _reset_counts()
        with _stderr_to(io.StringIO()) as err:
            rc = cli.main([npz, "-q", "-l", "--dump_masks", "--x64", *flags])
        n_fit, n_t, n_64 = _counts()
        check(rc == 0, f"cli.main --x64 {flags} returned {rc}")
        served = NpzIO().load(npz + "_cleaned.npz").weights
        with np.load(npz + "_cleaned.npz_masks.npz") as z:
            loops, scores = int(z["loops"]), z["test_results"]
        check(np.array_equal(served, ora.weights) and loops == ora.loops,
              f"CLI --x64 {flags}: mask or loops != oracle")
        check(scores.dtype == np.float64, f"CLI --x64 {flags}: scores are {scores.dtype}")
        check(n_fit == 0 and n_t == 0 and n_64 > 0,
              f"CLI --x64 {flags}: launches {n_fit}, {n_t}, float64 {n_64}")
        if flags:
            check("x64: the template continues block by block" in err.getvalue(),
                  "the chunked --x64 route's announcement")
        log(f"CLI --x64 {' '.join(flags) or '(stepwise)'} on {CLI_SMALL}: loops={loops}, mask == "
            f"oracle, float64 scores; launches fused_fit_moments 0, ordered_template 0, its "
            f"float64 instantiation {n_64} (the warm-up's included)")
        launches[name] = n_64
    return launches


def _surface_x64_lofar(lofar) -> dict:
    """``--x64`` at LOFAR from phase 4's preprocessed cube: stepwise, fused
    and chunk_block=32 against the oracle, with the peak against the
    estimate in 8-byte elements."""
    import numpy as np
    import torch

    from iterative_cleaner_tpu_torch.config import CleanConfig
    from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
    from iterative_cleaner_tpu_torch.ingest.pipeline import stream_depth
    from iterative_cleaner_tpu_torch.parallel import autoshard, chunked

    D, w0, ora = lofar["D"], lofar["w0"], lofar["oracle"]
    nsub, nchan, nbin = LOFAR
    launches = {}
    for name, extra in (("lofar_x64_stepwise", {}), ("lofar_x64_fused", {"fused": True}),
                        ("lofar_x64_chunked", {"chunk_block": 32})):
        cfg = CleanConfig(backend="torch", x64=True, **extra)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()  # ict: backend-init-ok(phase 1 made CUDA live)
        base = torch.cuda.memory_allocated()
        _reset_counts()
        t0 = time.perf_counter()
        with _stderr_to(io.StringIO()), _recording(chunked, "ChunkedTorchCleaner") as made:
            res = clean_cube(D, w0, cfg, device="cuda")
        torch.cuda.synchronize()  # ict: backend-init-ok(phase 1 made CUDA live)
        wall = time.perf_counter() - t0
        n_fit, n_t, n_64 = _counts()
        peak = torch.cuda.max_memory_allocated() - base
        check(np.array_equal(res.weights, ora.weights) and res.loops == ora.loops
              and res.converged == ora.converged,
              f"{name}: mask, loops or converged differ from the oracle")
        check(res.test_results.dtype == np.float64, f"{name}: scores are {res.test_results.dtype}")
        check(n_fit == 0 and n_t == 0, f"{name}: fused_fit_moments {n_fit}, float32 template {n_t}")
        if made:
            blocks = -(-nsub // 32)
            passes = made[0].template_passes
            check(n_64 == blocks * passes, f"{name}: float64 template launches {n_64} != "
                  f"{blocks} blocks x {passes} dense passes")
            est = (stream_depth() * autoshard.working_set_bytes((32, nchan, nbin), 8, False)
                   + nsub * nchan * autoshard.PER_PROFILE_BYTES["plain"] * 2)
            dense = f"{passes} dense passes of {blocks} blocks"
        else:
            check(1 <= n_64 <= res.loops, f"{name}: float64 template launches {n_64} outside "
                  f"1..{res.loops} (one per dense build)")
            est = autoshard.clean_working_set_bytes(LOFAR, cfg, False)
            dense = f"{n_64} dense builds"
        check(peak <= est, f"{name}: peak {peak / 1e9:.3f} GB above the 8-byte estimate "
              f"{est / 1e9:.3f} GB")
        drift = _drift(res.test_results, ora.test_results)
        drift32 = _drift(res.test_results, lofar["scores"])
        log(f"{name}: {wall:.2f}s, loops={res.loops} converged={res.converged}, mask == oracle; "
            f"score drift vs the oracle {drift:.4e}, vs the float32 CLI route {drift32:.4e}; "
            f"peak {peak / 1e9:.3f} GB against the 8-byte estimate {est / 1e9:.3f} GB; "
            f"launches fused_fit_moments 0, float64 ordered_template {n_64} ({dense})")
        launches[name] = n_64
        del res
    return launches


def phase_cli_surface(lofar) -> tuple[dict, dict]:
    """The rest of the one-card CLI surface on the card: a 2-pol Coherence
    ``.ar`` through ``cli.main`` with the defaults (``tests/fake_psrchive.py``
    stands in for the bindings the host lacks, for this phase only), ``-z``
    on it, ``--x64`` through the CLI on a small NPZ (stepwise and
    ``--chunk_block 8``), then ``--x64`` at LOFAR from phase 4's cube.
    Returns (float32 launches by path, float64 template launches by path)."""
    from iterative_cleaner_tpu_torch.config import CleanConfig
    from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
    from iterative_cleaner_tpu_torch.io import psrchive_io
    from iterative_cleaner_tpu_torch.io.synthetic import make_archive
    from iterative_cleaner_tpu_torch.ops.preprocess import preprocess

    fake, fake_path = _fake_psrchive()
    log(f"PSRCHIVE bindings {'present' if psrchive_io.psrchive_available() else 'absent'} on "
        f"this host: the stand-in {os.path.relpath(fake_path)} (numpy only) is the psrchive "
        "module for this phase; the package never loads it itself")
    saved = sys.modules.get("psrchive"), psrchive_io._psr
    sys.modules["psrchive"], psrchive_io._psr = fake, fake
    nsub, nchan, nbin = CLI_SMALL
    ar = make_archive(nsub=nsub, nchan=nchan, nbin=nbin, npol=2, seed=17)
    ora = clean_cube(*preprocess(ar), CleanConfig(backend="numpy"))
    cwd = os.getcwd()
    try:
        with tempfile.TemporaryDirectory(prefix="ict_surface_") as tmp:
            os.chdir(tmp)
            launches = _surface_ar(ar, fake, tmp, ora)
            f64 = _surface_x64_cli(ar, tmp, ora)
    finally:
        os.chdir(cwd)
        if saved[0] is None:
            sys.modules.pop("psrchive", None)
        else:
            sys.modules["psrchive"] = saved[0]
        psrchive_io._psr = saved[1]
    f64.update(_surface_x64_lofar(lofar))
    return launches, f64


#: The contracts phase's limit (s), and the chunked route's block there at
#: LOFAR (8 blocks, as phase 7).
CONTRACTS_PHASE_S = 30
CONTRACTS_BLOCK = 32


def _contract_lines(label: str, runs) -> list:
    """Each run's line: its syncs on the card against the ledger's
    prediction (reads and uploads for the iterations it ran)."""
    from iterative_cleaner_tpu_torch.analysis import contracts

    findings = []
    for run in runs:
        t, want = run.trace, run.expected
        n = run.units.get("iteration", run.units.get("continuing iteration", 1))
        log(f"  {label} {run.route}/{run.name}: {len(t.syncs)} syncs in {n} iteration(s) "
            f"(ledger: {want['read']} reads + {want['upload']} uploads; seen {len(t.reads)} + "
            f"{len(t.uploads)}){'; syncs at ' + ', '.join(sorted(set(t.syncs))) if t.syncs else ''}")
        check(len(t.syncs) == want["read"] + want["upload"],
              f"{label} {run.route}/{run.name}: {len(t.syncs)} syncs {t.syncs}, the ledger "
              f"predicts {want}")
        findings.extend(contracts.check_run(run))
    return findings


def phase_contracts(lofar) -> tuple[int, int]:
    """The port's static analysis suite on the card: ``tools_torch/ict_lint.py
    --source --races`` in a process of its own (rc 0), then the route
    contracts on cuda — every entry point with the kernel route off and on,
    on the tiny cube and at LOFAR on phase 4's cube (the chunked route in
    32-subint blocks, the batch of 2 LOFAR cubes): each run's CUDA syncs
    (``torch.cuda.set_sync_debug_mode``) equal to the ledger's reads plus
    uploads for the iterations it ran, no finding, and
    ``sparse_template_candidate`` (``torch.nonzero_static``) at LOFAR without
    a sync.  Returns each kernel's launches over the phase."""
    import torch

    from iterative_cleaner_tpu_torch.analysis import contracts
    from iterative_cleaner_tpu_torch.backends.torch_backend import INCREMENTAL_TEMPLATE_BUDGET

    t0 = time.perf_counter()
    lint = subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools_torch",
                                      "ict_lint.py"), "--source", "--races"],
        capture_output=True, text=True, timeout=300)
    lint_s = time.perf_counter() - t0
    check(lint.returncode == 0, f"ict_lint --source --races: rc {lint.returncode}\n"
          f"{lint.stdout[-3000:]}\n{lint.stderr[-3000:]}")
    log(f"contracts: ict_lint --source --races rc 0 in {lint_s:.2f}s "
        f"({lint.stderr.strip().splitlines()[-1] if lint.stderr.strip() else ''})")
    _reset_counts()
    findings = []
    t1 = time.perf_counter()
    runs, failed = contracts.run_routes("cuda")
    findings += failed + _contract_lines(f"tiny {contracts.TINY_SHAPE}", runs)
    tiny_s = time.perf_counter() - t1
    D, w0 = lofar["D"], lofar["w0"]
    t1 = time.perf_counter()
    runs, failed = contracts.run_routes("cuda", cube=(D, w0), batch=[(D, w0), (D, w0)],
                                        block=CONTRACTS_BLOCK)
    findings += failed + _contract_lines(f"LOFAR {LOFAR}", runs)
    lofar_s = time.perf_counter() - t1
    check(not findings, "route contracts on cuda:\n" + "\n".join(f.render() for f in findings))
    sparse = [r for r in runs if r.label == "sparse_template_candidate"]
    check(len(sparse) == 2 and all(r.trace.syncs == [] for r in sparse),
          f"sparse_template_candidate at LOFAR synchronised: {[r.trace.syncs for r in sparse]}")
    log(f"  sparse_template_candidate at LOFAR width (torch.nonzero_static, budget "
        f"{INCREMENTAL_TEMPLATE_BUDGET}): 0 syncs, kernel route off and on")
    fit, template, _ = _counts()
    phase_s = time.perf_counter() - t0
    log(f"contracts: every route on cuda holds its ledger; tiny {tiny_s:.2f}s, LOFAR "
        f"{lofar_s:.2f}s, lint {lint_s:.2f}s, the phase {phase_s:.2f}s; launches "
        f"fused_fit_moments {fit}, ordered_template {template}")
    check(fit > 0 and template > 0, f"contracts: launches {fit}, {template}")
    check(phase_s <= CONTRACTS_PHASE_S,
          f"the contracts phase took {phase_s:.1f}s, over {CONTRACTS_PHASE_S}s")
    torch.cuda.empty_cache()
    return fit, template


#: The ranks phase's sharded cleans, by group of rank processes: (group
#: label, backend, ranks, the logical devices on cuda:0 each rank holds,
#: its runs).  A run: (path label, the rank's devices the mesh takes, dp,
#: sp, the batch phase's archives it cleans, whether rank 0 is held to the
#: route contract).  Ranks share cuda:0; NCCL refuses two ranks on one
#: device, so those run gloo, staging through the host.  The runs of ranks
#: that hold two devices share the sp=2 group's processes: a process start
#: costs more than a LOFAR clean.
RANK_RUNS = (
    ("sharded", "gloo", 2, 2, (("sharded_sp2", 1, 1, 2, (0,), True),
                               ("ranks2x2_sp4", 2, 1, 4, (0,), True),
                               ("ranks2x2_dp2_sp2", 2, 2, 2, (0, 1), False))),
    ("dp2_sp2", "gloo", 4, 1, (("dp2_sp2", 1, 2, 2, (0, 1), False),)),
    ("nccl_sp1", "nccl", 1, 1, (("nccl_sp1", 1, 1, 1, (0,), True),)),
)
#: Seconds a rank process may take; its group's collectives time out
#: sooner, so a rank that dies fails its peers instead of hanging them.
RANK_TIMEOUT_S = 180
RANK_GROUP_TIMEOUT_S = 120
RANKS_PHASE_S = 120

#: One rank of the ranks phase: joins the group holding ``devices`` (cuda:0
#: once or more) and, by its ``mode``, cleans memory-mapped cubes through
#: sharded_clean, one run after another (held to the route contract on
#: rank 0 when asked), runs the CLI over paths (the directory split, then
#: the same with --sharded_batch), or makes a first NCCL collective that
#: must be refused.  Writes rank<r>.json (and rank<r>_<run>.npz) to its
#: ``out`` directory.
RANK_CHILD = r"""
import contextlib, dataclasses, json, os, sys, time
t_start = time.perf_counter()
args = json.loads(sys.argv[1])
rank = int(os.environ["RANK"])
import numpy as np
import torch
import torch.distributed as dist
from iterative_cleaner_tpu_torch.parallel.mesh import (
    initialize_distributed, make_mesh, rank_devices)
t_import = time.perf_counter()
dev = initialize_distributed(backend=args["backend"], devices=args["devices"],
                             timeout_s=args["timeout"])
out = {"rank": rank, "device": str(dev), "devices": [str(d) for d in rank_devices()],
       "backend": dist.get_backend(), "import_s": t_import - t_start,
       "init_s": time.perf_counter() - t_import}
path = os.path.join(args["out"], f"rank{rank}.json")
if args["mode"] == "nccl_refused":
    try:
        x = torch.ones(1, device=dev)
        dist.all_reduce(x)
        torch.cuda.synchronize(dev)
        out["error"] = None
    except Exception as exc:
        out["error"] = f"{type(exc).__name__}: {exc}"
    with open(path, "w") as fh:
        json.dump(out, fh)
    sys.stdout.flush()
    os._exit(0)   # the group may be broken: no teardown that could wait on it
from iterative_cleaner_tpu_torch.ops import fused_kernels as fk
from iterative_cleaner_tpu_torch.ops import template as tp

def launches():
    return [fk.fused_fit_moments.launches, tp.build_template.launches]

if args["mode"] == "cli":
    from iterative_cleaner_tpu_torch import cli
    from iterative_cleaner_tpu_torch.parallel import batch
    from iterative_cleaner_tpu_torch.parallel.multihost import partition_paths
    meshes, real = [], batch.clean_directory_batch
    def spy(paths, cfg, mesh=None):
        meshes.append({"shape": mesh.shape, "devices": [str(d) for d in mesh.devices]})
        return real(paths, cfg, mesh=mesh)
    batch.clean_directory_batch = spy
    out["slice"] = partition_paths(args["paths"])
    for name, flags in (("split", []), ("sharded_batch", ["--sharded_batch"])):
        os.makedirs(os.path.join(args["out"], name), exist_ok=True)
        os.chdir(os.path.join(args["out"], name))
        before = launches()
        t0 = time.perf_counter()
        rc = cli.main(["-q", *flags, "--report", "r.json", *args["paths"]])
        out[name] = {"rc": rc, "wall_s": time.perf_counter() - t0,
                     "launches": [b - a for a, b in zip(before, launches())]}
        # Both runs write each archive's cleaned file beside it: keep each
        # run's under a name of its own.
        for rep in json.load(open(f"r.json.p{rank}")):
            if rep["out_path"]:
                os.replace(rep["out_path"], f"{rep['out_path']}.{name}")
    out["sharded_batch"]["meshes"] = meshes
else:
    from iterative_cleaner_tpu_torch.analysis import contracts
    from iterative_cleaner_tpu_torch.config import CleanConfig
    from iterative_cleaner_tpu_torch.parallel import collectives, sharded
    cfg = CleanConfig(backend="torch")
    max_iter = int(cfg.max_iter)
    out["runs"] = {}
    for run in args["runs"]:
        cubes = [np.load(args["cubes"][str(j)], mmap_mode="r") for j in run["archives"]]
        w0s = [np.load(args["weights"][str(j)]) for j in run["archives"]]
        mesh = make_mesh(dp=run["dp"], sp=run["sp"], tp=1, group=dist.group.WORLD,
                         devices=rank_devices()[:run["k"]])
        dp = mesh.shape["dp"]
        held = [(i, j) for i, _ in mesh.positions for j in range(i, len(cubes), dp)]
        said = {"coords": mesh.coords, "positions": mesh.positions, "k": len(mesh.devices),
                "blocks": sum(1 for i, _ in mesh.positions if i < len(cubes)),
                "archive_blocks": len(held), "ready_s": time.perf_counter() - t_start}
        collectives.traffic.reset()
        torch.cuda.synchronize(dev)
        dist.barrier()
        before = launches()
        t0 = time.perf_counter()
        test, w, loops, done = sharded.sharded_clean(cubes, w0s, cfg, mesh)
        said["wall_s"] = time.perf_counter() - t0
        said["launches"] = [b - a for a, b in zip(before, launches())]
        said["traffic"] = dataclasses.asdict(collectives.traffic)
        said["iterations"] = max((int(loops[j]) if done[j] else max_iter for _, j in held),
                                 default=0)
        np.savez(os.path.join(args["out"], f"rank{rank}_{run['label']}.npz"), test=test, w=w,
                 loops=loops, done=done)
        if run["trace"]:
            collectives.traffic.reset()
            trace = contracts.Trace(dev) if rank == 0 else contextlib.nullcontext()
            with trace:
                again = sharded.sharded_clean(cubes, w0s, cfg, mesh)
            assert np.array_equal(again[1], w)
            if rank == 0:
                route = "ranks" if len(mesh.devices) == 1 else "rank_devices"
                units = {"run": 1, "archive": len({j for _, j in held}),
                         "archive block": len(held),
                         "continuing iteration": min(said["iterations"], max_iter - 1),
                         "staged read": collectives.traffic.staged_reads,
                         "staged upload": collectives.traffic.staged_uploads}
                said["contract"] = {
                    "route": route, "syncs": len(trace.syncs), "sites": sorted(set(trace.syncs)),
                    "reads": len(trace.reads), "uploads": len(trace.uploads), "units": units,
                    "f64": sorted(trace.f64), "want": contracts.expected_counts(
                        contracts.ROUTE_HOST_READS[route]["sharded_clean"], units)}
        said["end_s"] = time.perf_counter() - t_start
        out["runs"][run["label"]] = said
out["end_s"] = time.perf_counter() - t_start
with open(path, "w") as fh:
    json.dump(out, fh)
dist.destroy_process_group()
"""


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_ranks(out_dir, n, args):
    """Start ``n`` rank processes of RANK_CHILD with ``args`` in one group
    (the ``env://`` variables set, a free port on 127.0.0.1); returns what
    :func:`_wait_ranks` takes."""
    repo = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(out_dir, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()), WORLD_SIZE=str(n),
               LOCAL_RANK="0", NCCL_DEBUG="WARN")
    payload = json.dumps({**args, "out": out_dir, "timeout": RANK_GROUP_TIMEOUT_S})
    procs, errs = [], []
    t0 = time.perf_counter()
    for r in range(n):
        errs.append(os.path.join(out_dir, f"rank{r}.err"))
        with open(errs[-1], "w") as fe, open(os.path.join(out_dir, f"rank{r}.out"), "w") as fo:
            procs.append(subprocess.Popen([sys.executable, "-c", RANK_CHILD, payload],
                                          env={**env, "RANK": str(r)}, cwd=out_dir,
                                          stdout=fo, stderr=fe))
    return out_dir, procs, errs, t0


def _wait_ranks(started, timeout_s=RANK_TIMEOUT_S) -> tuple[list, float]:
    """Wait for the ranks :func:`_start_ranks` started, each killed at
    ``timeout_s`` from its start.  Returns each rank's (returncode,
    rank<r>.json or None, the end of its stderr) and the seconds until the
    last one exited."""
    out_dir, procs, errs, t0 = started
    try:
        for p in procs:
            p.wait(timeout=max(1.0, timeout_s - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    got = []
    for r, p in enumerate(procs):
        path = os.path.join(out_dir, f"rank{r}.json")
        said = json.load(open(path)) if os.path.exists(path) else None
        with open(errs[r]) as fh:
            got.append((p.returncode, said, fh.read()[-3000:]))
    return got, wall


def _ranks_ok(label, got) -> list[dict]:
    """Every rank exited 0 and wrote its result; returns the results."""
    for r, (rc, said, err) in enumerate(got):
        check(rc == 0 and said is not None, f"{label} rank {r}: rc {rc}\n{err}")
    return [said for _rc, said, _err in got]


def _staged_want(said, backend, sp) -> tuple[int, int]:
    """The staged copies the collectives' order predicts for a rank's run:
    none under nccl or where its slice lies inside the rank; else each
    iteration 2 reads (the template sent on or broadcast, the maps
    gathered) and 1 + (r > 0) + (r < last) uploads for the rank's index
    ``r`` in its slice, and with several devices one more of each for the
    set-up's gather of the weights."""
    k, iters = said["k"], said["iterations"]
    if backend != "gloo" or sp <= k or not said["positions"]:
        return 0, 0
    r, last = said["positions"][0][1] // k, sp // k - 1
    return 2 * iters + (k > 1), ((r > 0) + (r < last) + 1) * iters + (k > 1)


def _rank_group(work, group, backend, n, k, runs, inputs) -> dict:
    """One group of ``n`` rank processes, each holding cuda:0 ``k`` times,
    making its sharded cleans one after another.  For each run: every
    rank's result read back (identical on every rank), each kernel's
    launches on every rank the rank's device blocks × its iterations,
    no peer copy (the devices are logical), the staged copies as the
    collectives' order predicts, rank 0's syncs held to the ledger when
    asked; the run's line printed.  Returns per run its result and its
    launches summed over the ranks."""
    import numpy as np

    out_dir = os.path.join(work, group)
    archives = sorted({j for run in runs for j in run[4]})
    got, wall = _wait_ranks(_start_ranks(out_dir, n, {
        "mode": "clean", "backend": backend, "devices": ["cuda:0"] * k,
        "runs": [{"label": label, "k": rk, "dp": dp, "sp": sp, "archives": list(arch),
                  "trace": trace} for label, rk, dp, sp, arch, trace in runs],
        "cubes": {j: inputs[j][0] for j in archives},
        "weights": {j: inputs[j][1] for j in archives}}))
    said = _ranks_ok(group, got)
    for r in range(n):
        check(said[r]["backend"] == backend and said[r]["devices"] == ["cuda:0"] * k,
              f"{group} rank {r}: {said[r]['backend']} on {said[r]['devices']}")
    out = {}
    for label, rk, dp, sp, _arch, trace in runs:
        runs_said = [s["runs"][label] for s in said]
        results = []
        for r in range(n):
            with np.load(os.path.join(out_dir, f"rank{r}_{label}.npz")) as z:
                results.append({key: z[key] for key in z.files})
            for key in ("test", "w", "loops", "done"):
                check(np.array_equal(results[r][key], results[0][key], equal_nan=True),
                      f"{label}: rank {r}'s {key} differs from rank 0's")
            rs = runs_said[r]
            want = [rs["blocks"] * rs["iterations"]] * 2
            check(rs["launches"] == want,
                  f"{label} rank {r}: launches {rs['launches']}, want {want} ({rs['blocks']} "
                  f"device blocks x {rs['iterations']} iterations)")
            t = rs["traffic"]
            check(t["peer_copies"] == 0, f"{label} rank {r}: {t['peer_copies']} peer copies")
            want = _staged_want(rs, backend, sp)
            check((t["staged_reads"], t["staged_uploads"]) == want,
                  f"{label} rank {r}: staged copies {t['staged_reads']}, {t['staged_uploads']} "
                  f"in {rs['iterations']} iterations, the collectives' order predicts {want}")
        if trace:
            c = runs_said[0]["contract"]
            check(c["syncs"] == c["reads"] + c["uploads"] == c["want"]["read"]
                  + c["want"]["upload"] and c["reads"] == c["want"]["read"] and not c["f64"],
                  f"{label} rank 0 against the ledger: {c}")
            log(f"  {label} rank 0 against the route contract: {c['syncs']} syncs = "
                f"{c['want']['read']} reads + {c['want']['upload']} uploads for {c['units']} "
                f"(ROUTE_HOST_READS['{c['route']}'])")
        walls = [rs["wall_s"] for rs in runs_said]
        per_iter = [(rs["traffic"]["chain_s"] / max(rs["iterations"], 1),
                     rs["traffic"]["gathered_bytes"] / max(rs["iterations"], 1),
                     rs["traffic"]["staged_bytes"] / max(rs["iterations"], 1))
                    for rs in runs_said]
        log(f"  {label}: backend {backend}, {n} rank(s) on cuda:0, each mesh position of a rank "
            f"on one of its {rk} logical device(s) (dp={dp}, sp={sp}; positions "
            f"{[rs['positions'] for rs in runs_said]}), clean wall {max(walls):.4f}s (ranks "
            + ", ".join(f"{w:.4f}" for w in walls) + f"), iterations "
            f"{[rs['iterations'] for rs in runs_said]}; per iteration and rank (the set-up's "
            "gathers included): template chain "
            + ", ".join(f"{c * 1e3:.3f}" for c, _, _ in per_iter) + " ms, handed and gathered "
            + ", ".join(f"{g / 1e6:.3f}" for _, g, _ in per_iter) + " MB, staged "
            + ", ".join(f"{s_ / 1e6:.3f}" for _, _, s_ in per_iter) + " MB; peer copies 0; "
            "launches " + str([rs["launches"] for rs in runs_said]) + " = device blocks x "
            "iterations")
        out[label] = {"result": results[0],
                      "launches": [sum(rs["launches"][i] for rs in runs_said) for i in (0, 1)]}
    log(f"  {group} processes {wall:.1f}s: rank 0's imports {said[0]['import_s']:.1f}s, group "
        f"join {said[0]['init_s']:.1f}s, first run ready (cubes mapped, mesh) at "
        f"{said[0]['runs'][runs[0][0]]['ready_s']:.1f}s, done at {said[0]['end_s']:.1f}s of "
        "its own clock")
    return out


def _ranks_refused(started) -> str:
    """Two nccl ranks on one card (started by :func:`_start_ranks`): the
    first collective must fail; returns NCCL's own error text."""
    got, wall = _wait_ranks(started, timeout_s=60)
    errors = [said.get("error") if said else None for _rc, said, _err in got]
    lines = [ln.strip() for _rc, _said, err in got for ln in err.splitlines()
             if "NCCL WARN" in ln or "Duplicate GPU" in ln]
    check(any(errors) or any(rc != 0 for rc, _s, _e in got),
          f"two nccl ranks on one card were not refused: {got}")
    tails = [err.strip().splitlines()[-1] for _rc, _said, err in got if err.strip()]
    text = (lines or [e for e in errors if e] or tails or ["no error text"])[0]
    log(f"  nccl, 2 ranks on cuda:0: refused as expected in {wall:.1f}s: {text[:400]}")
    return text


def _ranks_cli(work, lofar) -> dict:
    """Two gloo ranks, each holding cuda:0 twice, run cli.main over the
    service phase's three LOFAR .ictb archives twice: the directory split
    (slices [p0, p2] and [p1]), then the same with --sharded_batch, each
    rank batching its slice on its own in-process mesh over its two
    logical devices (dp=2).  Each run: r.json.p0 and r.json.p1 and no
    r.json, clean.log naming the whole invocation, each cleaned archive's
    weights, loops and converged those of the batch phase's one-process
    dispatch of the same cubes; with --sharded_batch each rank's launches
    its device blocks x iterations.  Returns each run's launches by path,
    summed over the ranks."""
    import numpy as np

    from iterative_cleaner_tpu_torch.config import CleanConfig

    out_dir = os.path.join(work, "cli_ranks")
    paths = list(lofar["service_paths"])
    refs = dict(zip(paths, lofar["service_refs"][1:]))
    got, wall = _wait_ranks(_start_ranks(out_dir, 2, {
        "mode": "cli", "backend": "gloo", "devices": ["cuda:0", "cuda:0"], "paths": paths}))
    said = _ranks_ok("cli_ranks", got)
    check([s["slice"] for s in said] == [paths[0::2], paths[1::2]],
          f"cli_ranks: slices {[s['slice'] for s in said]}")
    nsub, nchan = LOFAR[:2]
    launches = {}
    for name, label in (("split", "cli_ranks"), ("sharded_batch", "cli_ranks_sharded_batch")):
        run_dir = os.path.join(out_dir, name)
        check(all(s[name]["rc"] == 0 for s in said),
              f"{label}: rcs {[s[name]['rc'] for s in said]}")
        check(not os.path.exists(os.path.join(run_dir, "r.json")), f"{label}: r.json written")
        for r, s in enumerate(said):
            reps = json.load(open(os.path.join(run_dir, f"r.json.p{r}")))
            check([rep["path"] for rep in reps] == s["slice"], f"{label}: r.json.p{r} {reps}")
            for rep in reps:
                w, loops, done = refs[rep["path"]]
                served = f"{rep['out_path']}.{name}"
                check(rep["error"] is None and np.array_equal(
                    _ictb_weights(served, nsub, nchan), w)
                    and (rep["loops"], rep["converged"]) == (loops, done),
                    f"{label}: {rep['path']} differs from the one-process dispatch: {rep}")
                os.remove(served)
            fit, tmpl = s[name]["launches"]
            check(fit > 0 and tmpl > 0, f"{label} rank {r}: launches {s[name]['launches']}")
            if name == "sharded_batch":
                # dp=2 over the rank's two devices: one archive a slice.
                iters = max(refs[p][1] if refs[p][2] else CleanConfig().max_iter
                            for p in s["slice"])
                want = [min(len(s["slice"]), 2) * iters] * 2
                check(s[name]["launches"] == want and s[name]["meshes"] == [
                    {"shape": {"dp": 2, "sp": 1, "tp": 1}, "devices": ["cuda:0", "cuda:0"]}],
                    f"{label} rank {r}: meshes {s[name]['meshes']}, launches "
                    f"{s[name]['launches']}, want {want} (device blocks x iterations)")
        lines = open(os.path.join(run_dir, "clean.log")).read().strip().splitlines()
        check(len(lines) == len(paths) and all(all(p in ln for p in paths) for ln in lines),
              f"{label}: clean.log {lines}")
        launches[label] = [sum(s[name]["launches"][i] for s in said) for i in (0, 1)]
        log(f"  {label}: 2 gloo ranks on cuda:0, each holding it twice, each ran cli.main "
            f"{'--sharded_batch ' if name == 'sharded_batch' else ''}over {len(paths)} LOFAR "
            f".ictb archives: slices {[len(s['slice']) for s in said]}, r.json.p0 and "
            f"r.json.p1 (no r.json), masks, loops and converged the batch phase's, clean.log "
            f"the whole invocation" + (", each rank's batch on its own dp=2 mesh over its two "
                                       "logical devices" if name == "sharded_batch" else "")
            + "; CLI walls " + ", ".join(f"{s[name]['wall_s']:.2f}" for s in said)
            + f" s; launches {[s[name]['launches'] for s in said]}")
    log(f"  cli_ranks processes {wall:.1f}s")
    return launches


def phase_ranks(lofar) -> tuple[dict, dict]:
    """The multi-process tier on one card: ranks in child processes on
    cuda:0.  (a) two gloo ranks, ``sharded_clean_single`` of phase 4's
    cube over sp=2, one device a rank: the oracle's mask, loops and
    converged, the score drift within 5e-5, rank 0's syncs against the
    route contract; then the same two ranks holding cuda:0 twice each:
    (b) the cube over 2 ranks x 2 devices, sp=4 (the JAX package's global
    mesh over two processes), rank 0 against the ``rank_devices`` route
    contract; (c) the batch phase's seeds 42 and 101 over 2 x 2, dp=2 x
    sp=2, a whole slice on each rank; (d) four gloo ranks, dp=2 x sp=2,
    one device each; (e) one nccl rank, (a) at sp=1 through the
    device-tensor path; two nccl ranks on one card refused, NCCL's error
    printed; (f) the directory split through the CLI over 2 ranks holding
    cuda:0 twice, plain and with --sharded_batch.  Every run: the batch
    phase's masks, loops and converged and its scores bit for bit, archive
    0 the oracle's.  Returns each kernel's launches by path, summed over
    the ranks."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    work = os.path.join(os.path.dirname(lofar["path"]), "ranks")
    inputs = lofar["ranks_inputs"]
    ora = lofar["oracle"]
    refs = lofar["ranks_refs"]
    log(f"ranks: phase 4's cube and the batch phase's seed-101 cube as .npy, memory-mapped "
        f"by every rank (each uploads its device blocks only); ranks share cuda:0, a rank "
        f"holding two devices holds it twice (logical devices)")
    fit, tmpl = {}, {}
    for group, backend, n, k, runs in RANK_RUNS:
        got = _rank_group(work, group, backend, n, k, runs, inputs)
        for label, _rk, _dp, _sp, archives, _trace in runs:
            fit[label], tmpl[label] = got[label]["launches"]
            res = got[label]["result"]
            for j, src in enumerate(archives):
                want_t, want_w, want_loops, want_done = refs[src]
                check(np.array_equal(res["w"][j], want_w)
                      and (int(res["loops"][j]), bool(res["done"][j])) == (want_loops, want_done),
                      f"{label} archive {j}: mask/loops/converged differ from the batch phase's")
                diff = float(np.nanmax(np.abs(res["test"][j] - want_t)))
                check(np.array_equal(res["test"][j], want_t, equal_nan=True),
                      f"{label} archive {j}: scores differ from the one-card batched route "
                      f"by up to {diff:.3e}")
                log(f"  {label} archive {j}: max |score difference| against the one-card "
                    f"batched route {diff:.3e}")
            check(np.array_equal(res["w"][0], ora.weights)
                  and (int(res["loops"][0]), bool(res["done"][0])) == (ora.loops, ora.converged),
                  f"{label}: archive 0 differs from the oracle")
            drift = _drift(res["test"][0], ora.test_results)
            check(drift <= 5e-5, f"{label}: score drift {drift:.3e} against the oracle")
            log(f"  {label}: archive 0 the oracle's mask, loops and converged; score drift "
                f"{drift:.3e} (bound 5e-05)")
    # The refusal beside the CLI run: it fails at its first collective,
    # within seconds of its start, and the phase does not wait for it alone.
    refused = _start_ranks(os.path.join(work, "nccl_refused"), 2,
                           {"mode": "nccl_refused", "backend": "nccl", "devices": ["cuda:0"]})
    for label, (f, t) in _ranks_cli(work, lofar).items():
        fit[label], tmpl[label] = f, t
    lofar["nccl_refused"] = _ranks_refused(refused)
    for p in inputs.values():
        for f in p:
            os.remove(f)
    phase_s = time.perf_counter() - t0
    log(f"ranks: every run held; the phase {phase_s:.1f}s")
    check(phase_s <= RANKS_PHASE_S, f"the ranks phase took {phase_s:.1f}s, over {RANKS_PHASE_S}s")
    return fit, tmpl


#: The local mesh phase's budget on the one card: ``ICT_HBM_BYTES`` that
#: puts LOFAR's working set (2.5 GB on the kernel route) beyond one device
#: and chunks it in 3 blocks where the reroute declines.
LOCAL_MESH_BUDGET = 2 * 10**9
LOCAL_MESH_PHASE_S = 90


@contextlib.contextmanager
def _default_devices(devices):
    """``parallel/autoshard.default_devices`` giving ``devices`` for the
    ``with`` block: logical devices for clean_cube's reroute."""
    from iterative_cleaner_tpu_torch.parallel import autoshard

    orig = autoshard.default_devices
    autoshard.default_devices = lambda device="cuda": list(devices)
    try:
        yield
    finally:
        autoshard.default_devices = orig


def _local_run(label, fn, iterations_of, n_blocks):
    """Run ``fn()`` (a clean on an in-process mesh of logical devices on
    cuda:0) with the launch counts, the traffic and the peak reset before
    it: returns (its value, the launches, its line's numbers).  Each
    kernel launches once per device block and iteration."""
    import torch

    from iterative_cleaner_tpu_torch.parallel import collectives

    torch.cuda.synchronize()  # ict: backend-init-ok(phase 1 made CUDA live)
    torch.cuda.reset_peak_memory_stats()  # ict: backend-init-ok(phase 1 made CUDA live)
    _reset_counts()
    collectives.traffic.reset()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()  # ict: backend-init-ok(phase 1 made CUDA live)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()  # ict: backend-init-ok(phase 1 made CUDA live)
    fit, tmpl, _ = _counts()
    iters = iterations_of(out)
    t = collectives.traffic
    check(fit == tmpl == n_blocks * iters,
          f"{label}: launches {fit}, {tmpl}; {n_blocks} device blocks x {iters} iterations "
          f"predict {n_blocks * iters} each")
    check(t.peer_copies == 0 and t.staged_bytes == 0,
          f"{label}: {t.peer_copies} peer copies, {t.staged_bytes} staged bytes on one card")
    log(f"  {label}: clean wall {wall:.4f}s (the upload included), {iters} iterations, launches "
        f"fused_fit_moments {fit}, ordered_template {tmpl} ({n_blocks} device blocks x "
        f"{iters}); handed between devices {t.gathered_bytes} B in all, "
        f"{t.gathered_bytes / iters / 1e6:.4f} MB per iteration (the setup's weights and the "
        f"results' meeting included; 0 copies: the logical devices share cuda:0); peak "
        f"{peak / 1e9:.3f} GB on the one card (every logical device's blocks together: the "
        f"whole cube and its working set, not a device's share)")
    return out, (fit, tmpl)


def phase_local_mesh(lofar) -> tuple[dict, dict]:
    """The mesh over one process's devices, on the one card with logical
    devices: ``autoshard.default_devices`` replaced by ``[cuda:0, cuda:0]``
    for the reroute and ``make_mesh(devices=[cuda:0] * 4)`` for the batch.
    (a) phase 4's cube through ``clean_cube`` with its defaults on a 2 GB
    ``ICT_HBM_BYTES``: the announcement, ``sp=2``, the oracle's mask,
    loops and converged, the scores the one-card batched route's bit for
    bit, and the same clean's syncs against the route contract; (b) the
    batch phase's seeds 42 and 101 through ``clean_directory_batch`` on a
    ``dp=2 x sp=2`` mesh: the batch phase's masks, loops and converged and
    its scores bit for bit; (c) the same cube with ``--x64`` and with
    ``want_residual``: each declines to chunked; (d) ``make_mesh()`` with
    no devices: one device on this one-card host.  Returns each kernel's
    launches by path."""
    import numpy as np
    import torch

    from iterative_cleaner_tpu_torch.analysis import contracts
    from iterative_cleaner_tpu_torch.config import CleanConfig
    from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
    from iterative_cleaner_tpu_torch.parallel import autoshard, batch, sharded
    from iterative_cleaner_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    D, w0, ora = lofar["D"], lofar["w0"], lofar["oracle"]
    refs = lofar["ranks_refs"]
    cfg = CleanConfig(backend="torch")
    max_iter = int(cfg.max_iter)

    # (d) the default mesh on this host: one device, so every earlier
    # phase's route is unchanged.
    default = make_mesh()
    check(default.devices == (torch.device("cuda", 0),)
          and default.shape == {"dp": 1, "sp": 1, "tp": 1}
          and autoshard.default_devices("cuda") == [torch.device("cuda", 0)],
          f"make_mesh() on a one-card host: {default}")
    log(f"local mesh: make_mesh() with no devices= on this host: {len(default.devices)} device "
        f"({default.devices[0]}), extents {default.shape}; the earlier phases' routes are "
        f"unchanged.  Logical devices for this phase: autoshard.default_devices replaced by "
        f"[cuda:0, cuda:0] for clean_cube's reroute, make_mesh(devices=[cuda:0] * 4) for the "
        f"batch (no environment variable or flag); they share cuda:0's memory and stream, so "
        f"this phase shows placement and order, not speed")
    two = [torch.device("cuda", 0)] * 2
    fit, tmpl = {}, {}

    # (a) the reroute.
    def reroute():
        with _default_devices(two), _hbm_budget(LOCAL_MESH_BUDGET), \
                _stderr_to(io.StringIO()) as buf:
            return clean_cube(D, w0, cfg, device="cuda"), buf.getvalue()

    def iterations(res):
        return res.loops if res.converged else max_iter

    (res, said), (fit["local_sp2"], tmpl["local_sp2"]) = _local_run(
        "local_sp2 (clean_cube's reroute)", reroute, lambda o: iterations(o[0]), 2)
    check("auto-sharding cube (256, 1024, 1024)" in said and "over 2 devices (sp=2" in said
          and "chunked clean:" not in said, f"local_sp2: the reroute's announcement: {said!r}")
    check(res.history == [] and res.iterations == [], "local_sp2: not the sharded route")
    check(np.array_equal(res.weights, ora.weights)
          and (res.loops, res.converged) == (ora.loops, ora.converged),
          "local_sp2: mask/loops/converged differ from the oracle")
    want_t, want_w, want_loops, want_done = refs[0]
    check(_same_bits(torch.from_numpy(np.ascontiguousarray(res.test_results)),
                     torch.from_numpy(want_t)),
          "local_sp2: scores differ from the one-card batched route's")
    drift = _drift(res.test_results, ora.test_results)
    check(drift <= 5e-5, f"local_sp2: score drift {drift:.3e}")
    log(f"  local_sp2: the oracle's mask, loops {res.loops} and converged; scores bit for bit "
        f"the one-card batched route's (max |difference| 0); drift against the oracle "
        f"{drift:.3e} (bound 5e-05)")

    # The same clean's host traffic against the route contract.
    mesh = make_mesh(devices=two, dp=1, sp=2)
    trace = contracts.Trace("cuda:0")
    with trace:
        again = sharded.sharded_clean([D], [w0], cfg, mesh)
    check(np.array_equal(again[1][0], res.weights), "local_sp2 traced: mask differs")
    units = {"run": 1, "archive block": 2,
             "continuing iteration": min(iterations(res), max_iter - 1)}
    want = contracts.expected_counts(contracts.ROUTE_HOST_READS["local"]["sharded_clean"],
                                     units)
    check(len(trace.syncs) == len(trace.reads) + len(trace.uploads)
          == want["read"] + want["upload"] and len(trace.reads) == want["read"]
          and not trace.f64, f"local_sp2 against the ledger: syncs {trace.syncs}, reads "
          f"{trace.reads}, uploads {trace.uploads}, f64 {trace.f64}, the ledger {want}")
    log(f"  local_sp2 against the route contract: {len(trace.syncs)} syncs = {want['read']} "
        f"reads + {want['upload']} uploads for {units} (ROUTE_HOST_READS['local'])")

    # (b) the directory batch on dp=2 x sp=2.
    root = os.path.dirname(lofar["path"])
    paths = [os.path.join(root, "service", "lofar_seed42.ictb"), lofar["service_paths"][0]]
    check(all(os.path.exists(p) for p in paths), f"local mesh: {paths} missing")
    four = make_mesh(devices=[torch.device("cuda", 0)] * 4)
    check(four.shape == {"dp": 2, "sp": 2, "tp": 1}, f"four logical devices: {four.shape}")

    def run_batch():
        return batch.clean_directory_batch(paths, cfg, mesh=four)

    def batch_iterations(items):
        return max(it.loops if it.converged else max_iter for it in items)

    items, (fit["local_dp2_sp2"], tmpl["local_dp2_sp2"]) = _local_run(
        "local_dp2_sp2 (clean_directory_batch, the .ictb reads and native preprocess "
        "included)", run_batch, batch_iterations, 4)
    for j, item in enumerate(items):
        want_t, want_w, want_loops, want_done = refs[j]
        check(item.error is None and np.array_equal(item.weights, want_w)
              and (item.loops, item.converged) == (want_loops, want_done),
              f"local_dp2_sp2 archive {j}: mask/loops/converged differ from the batch phase's")
        check(_same_bits(torch.from_numpy(np.ascontiguousarray(item.test_results)),
                         torch.from_numpy(want_t)),
              f"local_dp2_sp2 archive {j}: scores differ from the one-card batched route's")
    check(np.array_equal(items[0].weights, ora.weights), "local_dp2_sp2: archive 0 != oracle")
    log(f"  local_dp2_sp2: seeds 42 and 101 ({[it.loops for it in items]} loops) the batch "
        f"phase's masks, loops and converged, scores bit for bit; archive 0 the oracle's")

    # (c) the declines: x64 and a residual go to chunked.
    for label, kw in (("x64", dict(cfg=cfg.replace(x64=True))),
                      ("residual", dict(cfg=cfg, want_residual=True))):
        _reset_counts()
        t1 = time.perf_counter()
        with _default_devices(two), _hbm_budget(LOCAL_MESH_BUDGET), \
                _stderr_to(io.StringIO()) as buf:
            got = clean_cube(D, w0, kw["cfg"], want_residual=kw.get("want_residual", False),
                             device="cuda")
        wall = time.perf_counter() - t1
        said = buf.getvalue()
        f32_fit, f32_t, f64_t = _counts()
        check("auto-sharding" not in said and "chunked clean:" in said,
              f"local mesh {label}: did not decline to chunked: {said!r}")
        check(np.array_equal(got.weights, ora.weights) and got.loops == ora.loops,
              f"local mesh {label}: the chunked route's mask differs from the oracle")
        check(label != "residual" or got.residual is not None, "no residual")
        log(f"  {label}: declined to the chunked route ({said.strip().splitlines()[0][:140]}), "
            f"the oracle's mask in {wall:.2f}s; launches fused_fit_moments {f32_fit}, "
            f"ordered_template {f32_t} (float64 {f64_t})")
    phase_s = time.perf_counter() - t0
    log(f"local mesh: every run held; the phase {phase_s:.1f}s")
    check(phase_s <= LOCAL_MESH_PHASE_S,
          f"the local mesh phase took {phase_s:.1f}s, over {LOCAL_MESH_PHASE_S}s")
    torch.cuda.empty_cache()
    return fit, tmpl


#: Seeds of the fuzz phase from 1000, float32 and --x64: each mode of
#: tools_torch/fuzz_sweep.py on each seed, within ~60 s side by side.
FUZZ_SEEDS, FUZZ_SEEDS_X64 = 16, 8


def _mode_line(out: str, mode: str) -> dict:
    """The fuzz tool's line for ``mode``: its seeds, those identical to the
    oracle, its drift and each kernel's launches."""
    lines = [ln for ln in out.splitlines() if ln.startswith(f"mode {mode}: ")]
    check(len(lines) == 1, f"fuzz: {len(lines)} lines for mode {mode}")
    m = re.match(r"mode \S+: (\d+) seeds, (\d+) identical to the oracle, max score drift vs "
                 r"the oracle (\S+), .*launches (.*)$", lines[0])
    check(m is not None, f"fuzz: unparsed mode line {lines[0]!r}")
    return {"seeds": int(m[1]), "identical": int(m[2]), "drift": float(m[3]),
            **{name: int(v) for name, v in (part.split() for part in m[4].split(", "))}}


def phase_fuzz() -> dict:
    """``tools_torch/fuzz_sweep.py`` on cuda in two processes side by side
    (float32 and ``--x64``): rc 0, every seed and mode identical to the
    oracle; the tool's per-mode drift and sparse-update lines; the float32
    process's ``sharded`` mode (each cube over 8 logical devices of the
    card) identical on every seed, with both kernels launched.  Then
    ``tools_torch/replay_repro.py`` on cuda on a bundle whose served mask
    has one flipped cell: cleared, the recorded mask not the oracle's,
    rc 0.  Returns each kernel's launches in the tool's processes, and in
    the sharded mode under ``f32_sharded``."""
    import numpy as np

    from iterative_cleaner_tpu_torch.config import CleanConfig
    from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
    from iterative_cleaner_tpu_torch.io.synthetic import make_archive
    from iterative_cleaner_tpu_torch.obs import audit
    from iterative_cleaner_tpu_torch.ops.preprocess import preprocess

    tools = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools_torch")
    runs = {"f32": [str(FUZZ_SEEDS), "1000"], "x64": [str(FUZZ_SEEDS_X64), "1000", "--x64"]}
    log(f"fuzz: {FUZZ_SEEDS} float32 seeds and {FUZZ_SEEDS_X64} --x64 seeds from 1000 on "
        "cuda, two processes side by side")
    launches = {}
    with tempfile.TemporaryDirectory(prefix="ict_fuzz_") as tmp:
        env = dict(os.environ, ICT_REPRO_DIR=os.path.join(tmp, "repro"))
        procs = {k: subprocess.Popen([sys.executable, os.path.join(tools, "fuzz_sweep.py"),
                                      *argv, "--device", "cuda"], env=env, text=True,
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE)
                 for k, argv in runs.items()}
        outs = {}
        try:
            for k, proc in procs.items():
                outs[k] = (*proc.communicate(timeout=300), proc.returncode)
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for k, (out, err, rc) in outs.items():
            n = int(runs[k][0])
            for line in out.splitlines():
                if line.startswith(("mode ", "launches", "fuzz sweep", "  ")) or "seeds" in line:
                    log(f"  fuzz {k}: {line.strip()}")
            check(rc == 0 and f"{n}/{n} seeds identical" in out,
                  f"fuzz {k}: rc {rc}\n{out[-3000:]}\n{err[-3000:]}")
            counts = [ln for ln in out.splitlines() if ln.startswith("launches:")]
            check(len(counts) == 1, f"fuzz {k}: no launch line")
            launches[k] = {name: int(v) for name, v in
                           (part.split() for part in counts[0][len("launches:"):].split(","))}
        sharded = _mode_line(outs["f32"][0], "sharded")
        check(sharded["seeds"] == sharded["identical"] == FUZZ_SEEDS,
              f"fuzz sharded mode: {sharded['identical']}/{sharded['seeds']} seeds identical")
        check(sharded["fused_fit_moments"] > 0 and sharded["ordered_template"] > 0,
              f"fuzz sharded mode launched a kernel no time: {sharded}")
        log(f"  fuzz f32 sharded (8 logical devices of cuda:0, dp=4 x sp=2): "
            f"{sharded['identical']}/{sharded['seeds']} seeds identical to the oracle, drift "
            f"{sharded['drift']:.4e}, launches fused_fit_moments {sharded['fused_fit_moments']}, "
            f"ordered_template {sharded['ordered_template']}")
        launches["f32_sharded"] = {k: sharded[k] for k in ("fused_fit_moments",
                                                           "ordered_template")}

        D, w0 = preprocess(make_archive(nsub=16, nchan=64, nbin=128, seed=23))
        cfg = CleanConfig(backend="torch")
        served = clean_cube(D, w0, cfg.replace(backend="numpy")).weights.copy()
        served[3, 5] = 0.0 if served[3, 5] else 1.0
        bundle = audit.write_repro_bundle(os.path.join(tmp, "flip"), D=D, w0=w0, cfg=cfg,
                                          reason="one served cell flipped",
                                          weights_served=served, route="stepwise")
        check(bundle is not None, "the repro bundle was not written")
        rp = subprocess.run([sys.executable, os.path.join(tools, "replay_repro.py"), bundle,
                             "--device", "cuda"], capture_output=True, text=True, timeout=120)
        verdict = json.loads(rp.stdout.strip().splitlines()[-1]) if rp.stdout.strip() else {}
        check(rp.returncode == 0 and verdict.get("repro") == "cleared"
              and verdict.get("recorded_mask_matches_oracle") is False
              and verdict.get("device") == "cuda",
              f"replay: rc {rp.returncode}, {rp.stdout[-2000:]} {rp.stderr[-2000:]}")
        log(f"replay_repro on cuda: rc 0, repro {verdict['repro']}, recorded mask matches the "
            f"oracle {verdict['recorded_mask_matches_oracle']} ({verdict['n_recorded_diffs']} "
            f"cell), live mask identical {verdict['live_mask_identical']}")
    check(np.all([launches["f32"]["fused_fit_moments"] > 0, launches["f32"]["ordered_template"] > 0,
                  launches["x64"]["ordered_template_f64"] > 0,
                  launches["x64"]["fused_fit_moments"] == 0]),
          f"fuzz launches {launches}")
    return launches


def _host_available_bytes() -> int:
    with open("/proc/meminfo") as fh:
        for line in fh:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def _north_star_parity(Dt, wt) -> float:
    """The kernel over the whole device cube against its plain version on
    slabs of it: the first subints, the subints across element 2^31 and the
    last ones (past 4e9 elements at full size).  The maths is per profile,
    so the plain version on a slab is exact for it.  The FFT diagnostic of
    the whole cube's centred output is held against that of each slab.
    Returns the largest |kernel - plain| over finite map entries."""
    import torch

    from iterative_cleaner_tpu_torch.ops import fused_kernels as fk
    from iterative_cleaner_tpu_torch.ops.stats import fft_diagnostic
    from iterative_cleaner_tpu_torch.ops.template import build_template

    nsub, nchan, nbin = Dt.shape
    valid = wt != 0
    t = build_template(Dt, wt)
    got = fk.fused_fit_moments(Dt, t, wt, valid)
    fft = fft_diagnostic(got[0])
    edge = (1 << 31) // (nchan * nbin)
    slabs = [(0, min(8, nsub))]
    if nsub > edge:
        slabs.append((edge - 4, min(nsub, edge + 4)))
    slabs.append((max(0, nsub - 24), nsub))
    max_err = 0.0
    for lo, hi in slabs:
        want = fk.fused_fit_moments_plain(Dt[lo:hi], t, wt[lo:hi], valid[lo:hi])
        for key, g, w in zip(FIT_TOL, got, want):
            rtol, atol = FIT_TOL[key]
            torch.testing.assert_close(
                g[lo:hi], w, rtol=rtol, atol=atol, equal_nan=True,
                msg=lambda m, k=key, a=lo, b=hi: f"north star [{a}:{b}]: {k}: {m}")
            fin = torch.isfinite(w)
            if fin.any():
                max_err = max(max_err, float((g[lo:hi][fin] - w[fin]).abs().max()))
        zapped = wt[lo:hi] == 0
        for key, g in zip(("centred", "mean", "std"), got):
            check(bool((g[lo:hi][zapped] == 0).all()),
                  f"north star [{lo}:{hi}]: {key} not exactly 0 at zapped profiles")
        fft_slab = fft_diagnostic(got[0][lo:hi])
        torch.testing.assert_close(fft[lo:hi], fft_slab, rtol=1e-5, atol=1e-5,
                                   msg=lambda m, a=lo, b=hi: f"north star fft [{a}:{b}]: {m}")
        log(f"  kernel over the whole cube vs plain on subints [{lo}:{hi}] (elements "
            f"{lo * nchan * nbin:.3e}..{hi * nchan * nbin:.3e}): ok, "
            f"{int(zapped.sum())} zapped profiles; FFT diagnostic of the whole cube vs the "
            f"slab: max |difference| {float((fft[lo:hi] - fft_slab).abs().max()):.3e}")
        del want, fft_slab
    log(f"  north-star kernel parity max_abs_err={max_err:.3e}")
    return max_err


def _north_star_template(Dt, wt, tentry) -> None:
    """The template over the whole cube (4.3e9 elements at full size) in one
    launch against the same sum continued over blocks of subints whose
    element offsets fit in 31 bits, bit for bit: the 64-bit offsets without
    the plain version's ~60 s over 4.2M profiles.  Timed, beside its bound
    and cuBLAS's matrix-vector product (the same sum in another order)."""
    import torch

    from iterative_cleaner_tpu_torch.ops.template import build_template

    nsub, nchan, nbin = Dt.shape
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    whole = build_template(Dt, wt)
    b.record()
    b.synchronize()
    ms = a.elapsed_time(b)
    blk = (1 << 31) // (nchan * nbin)
    acc = None
    for lo in range(0, nsub, blk):
        acc = build_template(Dt[lo:lo + blk], wt[lo:lo + blk], init=acc)
    check(_same_floats(whole, acc), "north star: the whole-cube template differs from its "
          "sum continued over 2^31-element blocks")
    bound_ms, bound_by, nbytes = _template_bound_ms((nsub, nchan, nbin))
    floor_ms, floor_by, _ = _template_bound_ms((nsub, nchan, nbin),
                                               t_add_ms=tentry["t_add_ns"] * 1e-6)
    library_ms = _time_ms(lambda: torch.matmul(wt.reshape(-1), Dt.reshape(-1, nbin)), runs=5)
    log(f"  ordered_template over the whole cube {tuple(Dt.shape)} in one launch: "
        f"{ms:.4f} ms (bound {bound_ms:.4f} ms, {nbytes / 1e9:.2f} GB, {bound_by}; with the "
        f"chain {floor_ms:.4f} ms, {floor_by}; cuBLAS's matrix-vector product "
        f"{library_ms:.4f} ms); == its sum continued over {-(-nsub // blk)} blocks of {blk} "
        "subints, bit for bit")
    tentry["north_star"] = {"shape": [nsub, nchan, nbin], "ms": ms,
                            "library_ms": library_ms,
                            "bound_ms": bound_ms, "bound_by": bound_by, "floor_ms": floor_ms,
                            "floor_by": floor_by}


def phase_north_star(entry, tentry) -> dict:
    """BASELINE.json config #5 on one card: the kernel over the whole cube
    against its plain version, then the automatic route on this card and on
    a 32 GB budget (chunked), from host memory."""
    import gc

    import numpy as np
    import torch

    from iterative_cleaner_tpu_torch.config import CleanConfig
    from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
    from iterative_cleaner_tpu_torch.io.synthetic import RFISpec, make_preprocessed_cube
    from iterative_cleaner_tpu_torch.ops import fused_kernels as fk
    from iterative_cleaner_tpu_torch.parallel import autoshard

    nsub, nchan, nbin = NORTH_STAR
    cube = nsub * nchan * nbin * 4
    # Host memory: the cube, the copy the in-memory upload may stage, and
    # headroom for the results.
    need = 2.5
    avail = _host_available_bytes()
    if avail < need * cube:
        cut = max(8, int(avail / need / (nchan * nbin * 4)) // 8 * 8)
        log(f"north star: host MemAvailable {avail / 1e9:.1f} GB cannot hold {need} cubes of "
            f"{cube / 1e9:.2f} GB; nsub cut from {nsub} to {cut}")
        nsub = cut
    else:
        log(f"north star: host MemAvailable {avail / 1e9:.1f} GB holds {need} cubes of "
            f"{cube / 1e9:.2f} GB; no cut")
    shape = (nsub, nchan, nbin)
    t0 = time.perf_counter()
    rfi = RFISpec(n_profile_spikes=256, n_dc_profiles=192, n_bad_channels=8,
                  n_bad_subints=4, n_prezapped=128)
    Dt, wt = make_preprocessed_cube(*shape, seed=5, rfi=rfi, device="cuda")
    log(f"  made the seeded preprocessed cube {shape} ({Dt.numel() * 4 / 1e9:.2f} GB) on "
        f"the card in {time.perf_counter() - t0:.2f}s")
    _north_star_template(Dt, wt, tentry)
    err = _north_star_parity(Dt, wt)
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    D, w0 = Dt.cpu().numpy(), wt.cpu().numpy()
    del Dt, wt
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  copied it to host memory in {time.perf_counter() - t0:.2f}s")

    cfg = CleanConfig(backend="torch")
    budget = 32 * 10**9   # a 32 GB card
    hbm = autoshard.device_memory_bytes("cuda")
    for card, mem in (("this card", hbm), ("a 32 GB card", budget)):
        for route, kernel in (("kernel", True), ("plain", False)):
            ws = autoshard.working_set_bytes(shape, 4, kernel)
            usable = mem * autoshard.HBM_USABLE_FRACTION
            blk = (None if ws <= usable
                   else autoshard.block_subints(shape, mem, use_kernel=kernel))
            log(f"  {card}, {route} route: working set {ws / 1e9:.2f} GB against "
                f"{usable / 1e9:.2f} GB usable -> "
                + ("in memory" if blk is None else f"chunked, {blk}-subint blocks"))
    results, launches = {}, {}
    for name, mem in (("auto", None), ("auto_32gb", budget)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()  # ict: backend-init-ok(phase 1 made CUDA live)
        fk.fused_fit_moments.launches = 0
        with _hbm_budget(mem) if mem is not None else contextlib.nullcontext():
            block = autoshard.chunk_block_subints(shape, cfg, "cuda")
            t0 = time.perf_counter()
            with _stderr_to(io.StringIO()) as errbuf:
                res = clean_cube(D, w0, cfg, device="cuda")
            wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches[name] = fk.fused_fit_moments.launches
        results[name] = res
        route = "in memory" if block is None else f"chunked, {block}-subint blocks"
        log(f"  {name} ({route}): loops={res.loops} converged={res.converged} "
            f"zapped={int((res.weights == 0).sum())} wall={wall:.2f}s "
            f"peak_device_mem={peak / 1e9:.2f} GB launches={launches[name]}; iterations "
            + ", ".join(f"{i.duration_s:.4f}" for i in res.iterations) + " s"
            + (" (a thread per template chain: 0.2377, 0.2741 s; cuBLAS's template: 0.078, "
               "0.115 s)" if name == "auto" else ""))
        check(("chunked clean:" in errbuf.getvalue()) == (block is not None),
              f"north star {name}: the route announcement does not match the route")
        check("auto-sharding" not in errbuf.getvalue(),
              f"north star {name}: rerouted over devices on a one-card host")
        check(launches[name] > 0, f"north star {name}: the kernel never launched")
        check(np.isfinite(res.test_results).any() and res.weights.shape == shape[:2],
              f"north star {name}: implausible result")
        check(0 < int((res.weights == 0).sum()) < res.weights.size,
              f"north star {name}: implausible zap count")
        if block is None:
            est = autoshard.working_set_bytes(shape, 4, True)
            check(peak <= est, f"north star {name}: peak {peak} B exceeds the estimate {est} B")
            check(launches[name] == len(res.iterations),
                  f"north star {name}: launches != iterations")
        else:
            limit = (mem or hbm) * autoshard.HBM_USABLE_FRACTION
            check(peak <= limit, f"north star {name}: peak {peak} B exceeds the "
                  f"{limit / 1e9:.2f} GB usable budget it was sized for")
            nblocks = -(-shape[0] // block)
            check(launches[name] == nblocks * len(res.iterations),
                  f"north star {name}: launches != {nblocks} blocks x iterations")
    a, c = results["auto"], results["auto_32gb"]
    check(np.array_equal(a.weights, c.weights) and a.loops == c.loops,
          "north star: the two routes' masks differ")
    log("  masks identical between the two routes")
    del D, w0, results, a, c
    gc.collect()
    return {"north_star_auto": launches["auto"], "north_star_32gb": launches["auto_32gb"]}


#: LOFAR-quiet: BASELINE.json config #2's shape and seed with every default
#: RFI load but the broadband burst, so its flips fit the sparse budget.
QUIET_RFI = {"n_bad_subints": 0}
#: The quiet north star: config #5 without its bad channel (which alone
#: flips 1024 profiles) or a burst.
QUIET_NORTH_STAR_RFI = {"n_bad_subints": 0, "n_bad_channels": 0}
#: The CLI routes of the sparse phase: (name, flags); each also runs with
#: ``--no_incremental_template``.
SPARSE_ROUTES = (("stepwise", []), ("fused", ["--fused"]),
                 ("chunked", ["--chunk_block", "32"]), ("no_kernel", ["--no_kernel"]),
                 ("x64", ["--x64"]))
SPARSE_BLOCK = 32
SPARSE_TIMING_RUNS = 10

_QUIET_CHILD = """
import json, sys, time
import numpy as np
from iterative_cleaner_tpu_torch.config import CleanConfig
from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
from iterative_cleaner_tpu_torch.io.base import get_io
from iterative_cleaner_tpu_torch.io.synthetic import RFISpec, make_archive
from iterative_cleaner_tpu_torch.obs import tracing
from iterative_cleaner_tpu_torch.ops.preprocess import preprocess
path, out, shape, rfi = sys.argv[1], sys.argv[2], json.loads(sys.argv[3]), json.loads(sys.argv[4])
t0 = time.perf_counter()
ar = make_archive(nsub=shape[0], nchan=shape[1], nbin=shape[2], seed=42, rfi=RFISpec(**rfi))
t1 = time.perf_counter()
get_io(path).save(ar, path)
t2 = time.perf_counter()
D, w0 = preprocess(ar)
t3 = time.perf_counter()
ora = clean_cube(D, w0, CleanConfig(backend="numpy"))
t4 = time.perf_counter()
np.savez(out, weights=ora.weights, test_results=ora.test_results,
         history=np.stack(ora.history), loops=ora.loops, converged=ora.converged,
         termination=ora.termination)
print(json.dumps({"make_s": t1 - t0, "write_s": t2 - t1, "preprocess_s": t3 - t2,
                  "oracle_s": t4 - t3,
                  "native": tracing.counters_snapshot().get("preprocess_native", 0) > 0}))
"""


@contextlib.contextmanager
def _quiet_references():
    """LOFAR-quiet's archive and its numpy oracle, from a process of its own
    started with the script: it writes the archive as ``.ictb`` (the sparse
    phase's CLI input), preprocesses it as the CLI does and runs the
    oracle, so the oracle's minute overlaps the phases before.  Yields
    (process, archive path, oracle path, log path); at the end of the
    ``with`` block the process is stopped and its directory removed."""
    with tempfile.TemporaryDirectory(prefix="ict_quiet_") as work:
        path, out = os.path.join(work, "lofar_quiet42.ictb"), os.path.join(work, "oracle.npz")
        said = os.path.join(work, "child.log")
        repo = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
        with open(said, "w") as fh:
            proc = subprocess.Popen([sys.executable, "-c", _QUIET_CHILD, path, out,
                                     json.dumps(LOFAR), json.dumps(QUIET_RFI)],
                                    stdout=fh, stderr=subprocess.STDOUT, text=True, env=env)
        try:
            yield proc, path, out, said
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.wait()


def _flips(history) -> list[int]:
    """Profiles flipped before iterations 2, 3, ... (row 0 holds the
    pre-loop weights)."""
    return [int((a != b).sum()) for a, b in zip(history[1:-1], history[:-2])]


def _sparse_rule(flips) -> tuple[int, int]:
    """(templates the sparse update advances, dense builds) of a clean
    whose iterations 2.. follow ``flips``: a dense build in iteration 1 and
    wherever more profiles flipped than the budget."""
    from iterative_cleaner_tpu_torch.backends.torch_backend import INCREMENTAL_TEMPLATE_BUDGET

    over = sum(f > INCREMENTAL_TEMPLATE_BUDGET for f in flips)
    return len(flips) - over, 1 + over


def _taken() -> int:
    from iterative_cleaner_tpu_torch.backends import torch_backend

    return torch_backend.sparse_template_candidate.taken


def _score_difference(a, b) -> tuple[float, float]:
    """(max |a - b|, max unit-floored relative difference) over the entries
    finite on both sides; the finite pattern must be the same."""
    import numpy as np

    fa, fb = np.isfinite(a), np.isfinite(b)
    check(np.array_equal(fa, fb), "the finite scores differ in place")
    d = np.abs(a[fa].astype(np.float64) - b[fa])
    return float(d.max()), float((d / np.maximum(np.abs(b[fa]), 1.0)).max())


def _sparse_cli(path, flags, ora, nblocks) -> dict:
    """One CLI clean of ``path`` with ``flags``: its mask, loops, converged
    and termination held against the oracle, its drift, and each count
    against what the flips before each iteration predict."""
    import numpy as np

    from iterative_cleaner_tpu_torch import cli
    from iterative_cleaner_tpu_torch.backends import torch_backend
    from iterative_cleaner_tpu_torch.backends.torch_backend import INCREMENTAL_TEMPLATE_BUDGET
    from iterative_cleaner_tpu_torch.obs.audit import AUDIT_DRIFT_BOUND
    from iterative_cleaner_tpu_torch.parallel import chunked

    name = " ".join(flags) or "defaults"
    report = path + ".report.json"
    sparse = "--no_incremental_template" not in flags
    chunk = "--chunk_block" in flags
    x64 = "--x64" in flags
    kernel = not x64 and "--no_kernel" not in flags
    _reset_counts()
    taken = _taken()
    t0 = time.perf_counter()
    with _stderr_to(io.StringIO()) as err, \
            _recording(torch_backend, "start_precompile") as warm, \
            _recording(chunked, "ChunkedTorchCleaner") as made:
        rc = cli.main([path, "-q", "-l", "--dump_masks", "--report", report, *flags])
    wall = time.perf_counter() - t0
    n_fit, n_t32, n_t64 = _counts()
    taken = _taken() - taken
    check(rc == 0, f"CLI {name}: rc {rc}")
    rep = json.load(open(report))[0]
    with np.load(rep["out_path"] + "_masks.npz") as z:
        history, scores = z["history"], z["test_results"]
    loops, termination = rep["loops"], rep["quality"]["termination"]
    flips = _flips(history)
    check(len(history) == loops + 1, f"CLI {name}: {len(history)} masks, loops {loops}")
    check(flips and all(0 < f <= INCREMENTAL_TEMPLATE_BUDGET for f in flips),
          f"CLI {name}: flips before iterations 2.. {flips}, want 1..{INCREMENTAL_TEMPLATE_BUDGET}")
    n_diff = int((history[-1] != ora["weights"]).sum())
    if n_diff:
        s, c = np.argwhere(history[-1] != ora["weights"])[0]
        check(False, f"CLI {name}: {n_diff} mask entries differ from the oracle, the first "
              f"at (subint, channel) ({s}, {c})")
    check(np.array_equal(history, ora["history"]), f"CLI {name}: a mask of an iteration "
          "differs from the oracle's")
    check((loops, rep["converged"], termination)
          == (int(ora["loops"]), bool(ora["converged"]), str(ora["termination"])),
          f"CLI {name}: loops, converged or termination differ from the oracle's")
    check(scores.dtype == (np.float64 if x64 else np.float32), f"CLI {name}: {scores.dtype}")
    drift = _drift(scores, ora["test_results"])
    check(drift <= AUDIT_DRIFT_BOUND, f"CLI {name}: score drift {drift:.4e} beyond "
          f"{AUDIT_DRIFT_BOUND:g}")
    want_sparse, want_dense = _sparse_rule(flips) if sparse else (0, loops)
    w = warm[0] if warm else None
    if chunk:
        check(w is None, f"CLI {name}: the chunked route started a warm-up")
        check(f"streaming {SPARSE_BLOCK}-subint blocks" in err.getvalue(),
              f"CLI {name}: the chunked route was not announced")
        check(len(made) == 1 and made[0].template_passes == want_dense,
              f"CLI {name}: template passes {[m.template_passes for m in made]}, want "
              f"{want_dense}")
        warm_fit = warm_t = warm_sparse = 0
    else:
        check(w is not None and w.error is None, f"CLI {name}: the warm-up {w!r} failed")
        warm_fit, warm_t, warm_sparse = w.launches, w.template_launches, w.sparse_steps
        check((warm_fit, warm_t) == (int(kernel), 1),
              f"CLI {name}: the warm-up launched {warm_fit} fits, {warm_t} templates")
        check(not made, f"CLI {name}: an in-memory route made a chunked cleaner")
    blocks = nblocks if chunk else 1
    n_t = (n_t64 if x64 else n_t32) - warm_t
    check((n_t32 if x64 else n_t64) == 0, f"CLI {name}: launched the other template type")
    check(n_t == want_dense * blocks, f"CLI {name}: ordered_template launches {n_t} != "
          f"{want_dense} dense builds x {blocks} blocks")
    check(taken - warm_sparse == want_sparse,
          f"CLI {name}: sparse updates {taken - warm_sparse} != {want_sparse}")
    n_fit -= warm_fit
    check(n_fit == (loops * blocks if kernel else 0),
          f"CLI {name}: fused_fit_moments launches {n_fit}, loops {loops} x {blocks} blocks")
    log(f"  CLI {name}: {wall:.2f}s, loops={loops} converged={rep['converged']} "
        f"termination={termination}; flips before iterations 2..: {flips}; sparse updates "
        f"{taken - warm_sparse} (+ the warm-up's {warm_sparse}); dense builds {want_dense}"
        + (f" (template passes of {blocks} blocks)" if chunk else "")
        + f"; launches fused_fit_moments {n_fit}, ordered_template{'_f64' if x64 else ''} "
        f"{n_t} (+ the warm-up's {warm_fit}, {warm_t}); every iteration's mask the oracle's; "
        f"drift {drift:.4e}")
    return {"scores": scores, "wall": wall, "fit": n_fit, "template": n_t,
            "taken": taken - warm_sparse, "drift": drift, "loops": loops, "flips": flips}


@contextlib.contextmanager
def _pass_backends():
    """Replace ``parallel/chunked.ChunkedTorchCleaner`` for the ``with``
    block by a subclass that keeps the weights each step is given (so a
    provisional pass's flips can be read); yields the cleaners made."""
    import numpy as np

    from iterative_cleaner_tpu_torch.parallel import chunked

    orig = chunked.ChunkedTorchCleaner
    made = []

    class Seen(orig):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.seen = []
            made.append(self)

        def step(self, w_prev):
            self.seen.append(np.array(w_prev, copy=True))
            return super().step(w_prev)

    chunked.ChunkedTorchCleaner = Seen
    try:
        yield made
    finally:
        chunked.ChunkedTorchCleaner = orig


def _sparse_follow(ar, ora) -> dict:
    """An OnlineSession on LOFAR-quiet in 8 blocks of 32 subints and one
    with the incremental template off, sharing the host inputs: each pass's
    flips, sparse updates and dense passes against the budget rule, the
    alerts identical, the finalizes the oracle's mask."""
    import numpy as np

    from iterative_cleaner_tpu_torch.backends import torch_backend
    from iterative_cleaner_tpu_torch.backends.torch_backend import INCREMENTAL_TEMPLATE_BUDGET
    from iterative_cleaner_tpu_torch.config import CleanConfig
    from iterative_cleaner_tpu_torch.obs.audit import AUDIT_DRIFT_BOUND
    from iterative_cleaner_tpu_torch.online import OnlineSession, SessionMeta

    meta = SessionMeta.from_archive(ar)
    sess = OnlineSession(meta, CleanConfig(backend="torch"), alert_iters=2, device="cuda")
    dense = OnlineSession(meta, CleanConfig(backend="torch", incremental_template=False),
                          alert_iters=2, device="cuda")
    shared = []
    inputs = sess.state.provisional_inputs

    def keep_inputs():
        shared[:] = [inputs()]
        return shared[0]

    sess.state.provisional_inputs = keep_inputs
    dense.state.provisional_inputs = lambda: shared[0]
    later, rows = 0, []
    for b in range(ar.nsub // SPARSE_BLOCK):
        lo = b * SPARSE_BLOCK
        data, weights = ar.data[lo:lo + SPARSE_BLOCK], ar.weights[lo:lo + SPARSE_BLOCK]
        _reset_counts()
        taken = _taken()
        with _pass_backends() as made:
            alert = sess.ingest(data, weights)
        taken = _taken() - taken
        n_fit, n_t, _ = _counts()
        check(len(made) == 1, f"follow block {b}: {len(made)} pass cleaners")
        seen = made[0].seen
        flips = [int((a != p).sum()) for a, p in zip(seen[1:], seen[:-1])]
        want_sparse, want_dense = _sparse_rule(flips)
        slabs = alert.nsub_total // SPARSE_BLOCK
        check(len(seen) == alert.pass_iterations, f"follow block {b}: {len(seen)} steps")
        check(all(0 < f <= INCREMENTAL_TEMPLATE_BUDGET for f in flips),
              f"follow block {b}: flips {flips}")
        check(taken == want_sparse and made[0].template_passes == want_dense,
              f"follow block {b}: sparse updates {taken}, dense passes "
              f"{made[0].template_passes}, want {want_sparse} and {want_dense}")
        check(n_fit == slabs * alert.pass_iterations and n_t == slabs * want_dense,
              f"follow block {b}: launches {n_fit} and {n_t}")
        if b:
            later += taken
        before = _taken()
        off = dense.ingest(data, weights)
        check(_taken() == before, f"follow block {b}: the dense session took a sparse update")
        check(_alert_key(off) == _alert_key(alert),
              f"follow block {b}: the alerts differ between the sparse and dense sessions")
        rows.append((alert, flips, taken, n_fit, n_t))
    del sess.state.provisional_inputs, dense.state.provisional_inputs
    for alert, flips, taken, n_fit, n_t in rows:
        log(f"  follow block {alert.block_index} (subints {alert.subint_lo}:"
            f"{alert.subint_hi}): {alert.latency_s:.4f}s, {alert.n_new_zaps} new zaps, "
            f"{alert.pass_iterations} iterations; flips before iteration 2: {flips}; sparse "
            f"updates {taken}; launches fused_fit_moments {n_fit}, ordered_template {n_t}")
    check(later >= 1, "follow: no provisional pass past the first took the sparse update")
    fits = {"sparse_follow_passes": sum(row[3] for row in rows)}
    templates = {"sparse_follow_passes": sum(row[4] for row in rows)}
    results = {}
    for label, s in (("sparse", sess), ("dense", dense)):
        _reset_counts()
        taken = _taken()
        with _recording(torch_backend, "start_precompile") as warm:
            fin = s.finalize()
        res = fin.result
        taken = _taken() - taken - (warm[0].sparse_steps if warm and warm[0] else 0)
        hist = np.stack(res.history)
        check(np.array_equal(hist, ora["history"])
              and (res.loops, res.converged, res.termination)
              == (int(ora["loops"]), bool(ora["converged"]), str(ora["termination"])),
              f"follow finalize ({label}): mask, loops, converged or termination differ "
              "from the oracle's")
        drift = _drift(res.test_results, ora["test_results"])
        check(drift <= AUDIT_DRIFT_BOUND, f"follow finalize ({label}): drift {drift:.4e}")
        want = _sparse_rule(_flips(hist))[0] if label == "sparse" else 0
        check(taken == want, f"follow finalize ({label}): sparse updates {taken} != {want}")
        n_fit, n_t, _ = _counts()
        check(n_fit == res.loops + 1, f"follow finalize ({label}): launches {n_fit}")
        results[label] = res
        log(f"  follow finalize ({label} template): the oracle's masks, loops={res.loops} "
            f"termination={res.termination}, drift {drift:.4e}, sparse updates {taken}, "
            f"fused_fit_moments launches {n_fit} (loops + the warm-up's 1)")
        if label == "sparse":
            fits["sparse_follow_finalize"], templates["sparse_follow_finalize"] = n_fit, n_t
    diff, rel = _score_difference(results["sparse"].test_results,
                                  results["dense"].test_results)
    log(f"  follow: alerts identical between the sparse and dense sessions; sparse updates "
        f"in the passes past the first {later}; finalize scores sparse - dense: max "
        f"|difference| {diff:.4e}, relative {rel:.4e}")
    return fits, templates


def _sparse_step_times(Dt, w_prev, new_w, label) -> dict:
    """``sparse_template_candidate`` (gather, product, finite check) from
    ``w_prev`` to ``new_w`` against the dense ``build_template`` it
    replaces: CUDA events around a call, median of 10 (``ms``), and device
    time of calls back to back (``device_ms``); its ``torch.nonzero_static``
    alone; the candidate held against the dense template; the bound of the
    step's bytes."""
    import torch

    from iterative_cleaner_tpu_torch.backends.torch_backend import (
        INCREMENTAL_TEMPLATE_BUDGET,
        sparse_template_candidate,
    )
    from iterative_cleaner_tpu_torch.ops.template import build_template

    nsub, nchan, nbin = Dt.shape
    T_prev = build_template(Dt, w_prev)
    cand, ok = sparse_template_candidate(Dt, T_prev, w_prev, new_w)
    want = build_template(Dt, new_w)
    check(bool(ok), f"{label}: the sparse candidate may not stand")
    flips = int((new_w != w_prev).sum())
    err = float((cand - want).abs().max() / want.abs().max())
    step = lambda: sparse_template_candidate(Dt, T_prev, w_prev, new_w)  # noqa: E731
    dense = lambda: build_template(Dt, new_w)  # noqa: E731
    changed = (new_w - w_prev).reshape(-1) != 0
    t = {"sparse_ms": _time_ms(step, SPARSE_TIMING_RUNS),
         "sparse_device_ms": _device_ms(step, SPARSE_TIMING_RUNS),
         "nonzero_static_ms": _time_ms(lambda: torch.nonzero_static(
             changed, size=INCREMENTAL_TEMPLATE_BUDGET, fill_value=0), SPARSE_TIMING_RUNS),
         "dense_ms": _time_ms(dense, SPARSE_TIMING_RUNS),
         "dense_device_ms": _device_ms(dense, SPARSE_TIMING_RUNS)}
    itemsize = Dt.element_size()
    # Both weight maps read, the flipped profiles gathered, the template in
    # and out; two operations a gathered element.
    nbytes = (2 * nsub * nchan + (flips + 2) * nbin) * itemsize
    times = {"bytes": nbytes / PEAK_BYTES_PER_S * 1e3,
             "operations": 2 * flips * nbin / PEAK_F32_FLOPS * 1e3}
    by = max(times, key=times.get)
    log(f"  {label}: {flips} flipped profiles; sparse_template_candidate {t['sparse_ms']:.4f} "
        f"ms a call, {t['sparse_device_ms']:.4f} ms device (its nonzero_static "
        f"{t['nonzero_static_ms']:.4f} ms a call; bound {times[by]:.6f} ms by {by}, "
        f"{nbytes / 1e6:.3f} MB) against the dense build_template {t['dense_ms']:.4f} ms a "
        f"call, {t['dense_device_ms']:.4f} ms device (CUDA events, median of "
        f"{SPARSE_TIMING_RUNS}; back to back); |candidate - dense template| at most "
        f"{err:.4e} of the template's largest bin")
    return {"shape": [nsub, nchan, nbin], "flips": flips, **t, "bound_ms": times[by],
            "bound_by": by, "max_difference_of_peak": err}


def _sparse_north_star() -> dict:
    """The quiet north star (config #5 with no bad channel or burst), made
    on the card: its iteration-1 flips, the sparse step against the dense
    build; then from host memory in memory and on a 32 GB budget, each with
    and without the incremental template: masks identical, loops equal,
    the score differences printed.  No oracle at this size."""
    import gc

    import numpy as np
    import torch

    from iterative_cleaner_tpu_torch.backends.torch_backend import step_from_template
    from iterative_cleaner_tpu_torch.config import CleanConfig
    from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
    from iterative_cleaner_tpu_torch.io.synthetic import RFISpec, make_preprocessed_cube
    from iterative_cleaner_tpu_torch.ops.template import build_template

    nsub, nchan, nbin = NORTH_STAR
    avail = _host_available_bytes()
    cube = nsub * nchan * nbin * 4
    if avail < 2.5 * cube:
        nsub = max(8, int(avail / 2.5 / (nchan * nbin * 4)) // 8 * 8)
        log(f"quiet north star: host MemAvailable {avail / 1e9:.1f} GB; nsub cut to {nsub}")
    shape = (nsub, nchan, nbin)
    cfg = CleanConfig(backend="torch")
    Dt, wt = make_preprocessed_cube(*shape, seed=5, rfi=RFISpec(**QUIET_NORTH_STAR_RFI),
                                    device="cuda")
    _test, new_w, _r = step_from_template(
        Dt, wt, wt != 0, build_template(Dt, wt), float(cfg.chanthresh),
        float(cfg.subintthresh), pulse_region=tuple(cfg.pulse_region), use_kernel=True)
    out = {"times": _sparse_step_times(Dt, wt, new_w, f"quiet north star {shape}, "
                                                      "iteration 1 -> 2")}
    del _test, _r, new_w
    D, w0 = Dt.cpu().numpy(), wt.cpu().numpy()
    del Dt, wt
    gc.collect()
    torch.cuda.empty_cache()
    results, fits, templates = {}, {}, {}
    for mem, budget in (("in memory", None), ("32 GB", 32 * 10**9)):
        for label, inc in (("sparse", True), ("dense", False)):
            gc.collect()
            torch.cuda.empty_cache()
            _reset_counts()
            taken = _taken()
            t0 = time.perf_counter()
            with _hbm_budget(budget) if budget else contextlib.nullcontext(), \
                    _stderr_to(io.StringIO()) as err:
                res = clean_cube(D, w0, cfg.replace(incremental_template=inc), device="cuda")
            wall = time.perf_counter() - t0
            taken = _taken() - taken
            flips = _flips(np.stack(res.history))
            want = _sparse_rule(flips)[0] if inc else 0
            check(("chunked clean:" in err.getvalue()) == (budget is not None),
                  f"quiet north star {mem}: the route announcement does not match")
            check(flips and taken == want and (not inc or taken >= 1),
                  f"quiet north star {mem} ({label}): flips {flips}, sparse updates {taken}")
            results[mem, label] = res
            key = f"north_star_quiet_{'32gb' if budget else 'auto'}_{label}"
            fits[key], templates[key], _ = _counts()
            log(f"  quiet north star {mem} ({label} template): loops={res.loops} "
                f"termination={res.termination} zapped={int((res.weights == 0).sum())}, "
                f"flips before iterations 2..: {flips}, sparse updates {taken}, wall "
                f"{wall:.2f}s")
    ref = results["in memory", "sparse"]
    for key, res in results.items():
        check(np.array_equal(res.weights, ref.weights)
              and (res.loops, res.termination) == (ref.loops, ref.termination),
              f"quiet north star {key}: the mask or loops differ")
    for mem in ("in memory", "32 GB"):
        diff, rel = _score_difference(results[mem, "sparse"].test_results,
                                      results[mem, "dense"].test_results)
        log(f"  quiet north star {mem}: sparse and dense masks identical; scores sparse - "
            f"dense: max |difference| {diff:.4e}, relative {rel:.4e} (the numpy oracle does "
            "not run at this size within the script's limit)")
        out[f"{mem} difference"] = rel
    out["launches"] = fits, templates
    del D, w0, results, ref
    gc.collect()
    return out


def phase_sparse_template(quiet, tentry) -> dict:
    """The sparse template update at full width: LOFAR-quiet through the
    CLI's stepwise (the main path), fused, chunked, kernel-off and
    ``--x64`` routes and a follow session, each against the oracle and
    against itself with the incremental template off; the step's time
    against the dense build; the quiet north star.  Returns the launches by
    path of ``fused_fit_moments``, ``ordered_template`` and its float64
    instantiation; records the step's times in ``tentry``."""
    import gc

    import numpy as np
    import torch

    from iterative_cleaner_tpu_torch.io.base import get_io
    from iterative_cleaner_tpu_torch.ops.preprocess import preprocess

    proc, path, ora_path, child_log = quiet
    rc = proc.wait(timeout=600)
    with open(child_log) as fh:
        out_s = fh.read()
    check(rc == 0, f"LOFAR-quiet's reference process: rc {rc}\n{out_s[-3000:]}")
    said = json.loads(out_s.strip().splitlines()[-1])
    with np.load(ora_path) as z:
        ora = {k: z[k] for k in z.files}
    nsub = LOFAR[0]
    log(f"LOFAR-quiet {LOFAR}, make_archive(seed=42, rfi=RFISpec({QUIET_RFI})): made "
        f"{said['make_s']:.1f}s, written as .ictb {said['write_s']:.1f}s, preprocessed "
        f"({'native' if said['native'] else 'numpy'}) {said['preprocess_s']:.1f}s, numpy "
        f"oracle {said['oracle_s']:.1f}s, in a process started with the script; oracle "
        f"loops={int(ora['loops'])} termination={ora['termination']}, flips before "
        f"iterations 2..: {_flips(ora['history'])}")
    fits, templates, f64 = {}, {}, {}
    runs = {}
    for name, flags in SPARSE_ROUTES:
        for inc in (True, False):
            got = _sparse_cli(path, flags + ([] if inc else ["--no_incremental_template"]),
                              ora, -(-nsub // SPARSE_BLOCK))
            runs[name, inc] = got
        check(runs[name, True]["taken"] >= 1, f"CLI {name}: the sparse update was not taken")
        diff, rel = _score_difference(runs[name, True]["scores"], runs[name, False]["scores"])
        log(f"  CLI {name}: masks identical with --no_incremental_template; scores sparse - "
            f"dense: max |difference| {diff:.4e}, relative {rel:.4e}")
        key = f"sparse_{name}_cli"
        fits[key] = runs[name, True]["fit"]
        (f64 if name == "x64" else templates)[key] = runs[name, True]["template"]
    ar = get_io(path).load(path)
    follow_fits, follow_templates = _sparse_follow(ar, ora)
    fits.update(follow_fits)
    templates.update(follow_templates)
    D, w0 = preprocess(ar)
    del ar
    Dt = torch.from_numpy(D).to("cuda")
    h = torch.from_numpy(ora["history"]).to("cuda")
    times = {"lofar_quiet": _sparse_step_times(Dt, h[0], h[1], f"LOFAR-quiet {LOFAR}, "
                                                                "iteration 1 -> 2")}
    wall = runs["stepwise", True]["wall"]
    log(f"  LOFAR-quiet CLI wall-clock (defaults, .ictb in and out): {wall:.2f}s")
    del Dt, h, D, w0
    gc.collect()
    torch.cuda.empty_cache()
    north = _sparse_north_star()
    fits.update(north["launches"][0])
    templates.update(north["launches"][1])
    times["north_star_quiet"] = north["times"]
    tentry["sparse_template"] = {
        **times, "cli_wall_s": wall,
        "drift": {name: runs[name, True]["drift"] for name, _ in SPARSE_ROUTES}}
    return fits, templates, f64


def main() -> int:
    card = phase_environment()
    import torch

    from iterative_cleaner_tpu_torch.ops import preprocess as pp
    from iterative_cleaner_tpu_torch.ops import template as tp

    preprocess_by_path = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        before = pp.preprocess_plane.launches
        out = fn(*args)
        if pp.preprocess_plane.launches != before:
            preprocess_by_path[name.replace(" ", "_")] = pp.preprocess_plane.launches - before
        log(f"phase {name}: {time.perf_counter() - t0:.1f}s")
        return out

    def timed_counted(name, fn, *args):
        """A phase whose paths all build templates on the card: the
        template kernel's launches over the phase, which must not be 0."""
        tp.build_template.launches = 0
        out = timed(name, fn, *args)
        n = template_by_path[name.replace(" ", "_")] = tp.build_template.launches
        check(n > 0, f"phase {name}: ordered_template was launched no time")
        return out

    with tempfile.TemporaryDirectory(prefix="ict_smoke_") as work, \
            ThreadPoolExecutor(2) as prep, _quiet_references() as quiet:
        lofar_prep = prep.submit(_lofar_archive, work, prep)
        timed("build", phase_build)
        entries = {"fused_fit_moments": timed("kernel parity", phase_kernel_parity)}
        entries["ordered_template"] = timed("template parity", phase_template_parity)
        entries["ordered_template_f64"] = timed("template parity (float64)",
                                                phase_template_f64)
        entries["preprocess"] = timed("preprocess", phase_preprocess, lofar_prep,
                                      entries["ordered_template_f64"]["t_add_ns"])
        entry = entries["fused_fit_moments"]
        lofar = timed("main path", phase_main_path, entries, lofar_prep)
        # The CLI's clean preprocesses on the card.
        check(preprocess_by_path.get("main_path") == 1,
              f"the main path's CLI launched the device preprocess "
              f"{preprocess_by_path.get('main_path', 0)} times")
        by_path = {"stepwise_cli": entry["launches"], "cli_warm_up": lofar["warm_launches"]}
        template_by_path = {"stepwise_cli": entries["ordered_template"]["launches"],
                            "cli_warm_up": lofar["warm_template_launches"]}
        with _fd_stderr(os.path.join(work, "obs_stderr.txt")) as said:
            obs_launches, busy = timed("obs", phase_obs, lofar, entries)
        kineto = [line for line in said if "External init callback" in line]
        check(not kineto, f"the obs phase's stderr: {kineto}")
        log(f"obs: {len(said)} stderr lines at the file-descriptor level, none from Kineto's "
            "set-up on another thread")
        by_path["obs_cli"] = obs_launches["obs_cli"]
        by_path["obs_capture"] = obs_launches["obs_capture"]
        template_by_path["obs_cli"] = obs_launches["obs_cli_template"]
        by_path["fused"] = timed_counted("fused", phase_fused, lofar)
        by_path["chunked"] = timed_counted("chunked", phase_chunked, lofar)
        by_path.update(timed_counted("CLI routes", phase_cli_routes))
        timed_counted("peak model", phase_peak_model, lofar)
        timed("warm-up", phase_warmup, lofar)
        by_path.update(timed_counted("batch", phase_batch, lofar))
        by_path.update(timed_counted("sweep", phase_sweep, lofar))
        by_path.update(timed_counted("follow", phase_follow, lofar))
        fit_service, template_service = timed_counted("service", phase_service, lofar, card)
        by_path.update(fit_service)
        template_by_path.update(template_service)
        fit_fleet, template_fleet = timed("fleet", phase_fleet, lofar, card)
        by_path.update(fit_fleet)
        template_by_path.update(template_fleet)
        surface, f64_by_path = timed("CLI surface", phase_cli_surface, lofar)
        for name, (n_fit, n_t) in surface.items():
            by_path[name], template_by_path[name] = n_fit, n_t
        by_path["contracts"], template_by_path["contracts"] = timed(
            "contracts", phase_contracts, lofar)
        fit_ranks, template_ranks = timed("ranks", phase_ranks, lofar)
        by_path.update(fit_ranks)
        template_by_path.update(template_ranks)
        fit_local, template_local = timed("local mesh", phase_local_mesh, lofar)
        by_path.update(fit_local)
        template_by_path.update(template_local)
        fuzz = timed("fuzz", phase_fuzz)
        by_path["fuzz"] = fuzz["f32"]["fused_fit_moments"]
        template_by_path["fuzz"] = fuzz["f32"]["ordered_template"]
        f64_by_path["fuzz_x64"] = fuzz["x64"]["ordered_template_f64"]
        by_path["fuzz_sharded"] = fuzz["f32_sharded"]["fused_fit_moments"]
        template_by_path["fuzz_sharded"] = fuzz["f32_sharded"]["ordered_template"]
        fit_sparse, template_sparse, f64_sparse = timed(
            "sparse template", phase_sparse_template, quiet, entries["ordered_template"])
        by_path.update(fit_sparse)
        template_by_path.update(template_sparse)
        f64_by_path.update(f64_sparse)
        del lofar
    by_path.update(timed_counted("north star", phase_north_star, entry,
                                 entries["ordered_template"]))
    entry["launches_by_path"] = by_path
    entries["ordered_template"]["launches_by_path"] = template_by_path
    entries["ordered_template_f64"]["launches"] = f64_by_path["lofar_x64_stepwise"]
    entries["ordered_template_f64"]["launches_by_path"] = f64_by_path
    entries["preprocess"]["launches"] = preprocess_by_path["main_path"]
    entries["preprocess"]["launches_by_path"] = preprocess_by_path
    entry["busy"] = busy
    print(json.dumps({"kernels": list(entries.values())}), flush=True)
    log(f"all phases passed in {time.perf_counter() - T_START:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),  # ict: backend-init-ok(phase 1 made CUDA live)
        "count": torch.cuda.device_count()}}), flush=True)  # ict: backend-init-ok(phase 1 made CUDA live)
    return 0


if __name__ == "__main__":
    sys.exit(main())
