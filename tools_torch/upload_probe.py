#!/usr/bin/env python3
"""Measure the host-to-card copy of a host cube on one CUDA card.

    python3 tools_torch/upload_probe.py [--json PATH] [--gib 1.0] [--reps 5]

On the card's host and card, for a float32 host array of ``--gib`` GiB:

1. the host: its cores (``os.cpu_count``, ``os.sched_getaffinity``) and its
   host memcpy rate (``np.copyto``, which releases the interpreter lock) with
   1, 2, 4, ... threads, each copying its share of the array into reused
   pinned pieces (no copy to the card), and into one pageable array;
2. the cost of allocating pinned memory (``torch.empty(..., pin_memory=True)``);
3. the card's copy alone: one pinned buffer of the whole array to the card,
   timed with CUDA events;
4. the uploads a caller gets: ``torch.from_numpy(a).to(card)`` (pageable),
   ``backends/torch_backend.to_device`` on the contiguous array and on the
   strided pol-0 plane of a 4-pol cube, ``ingest/staging.StagingPool.fill``
   with 4, 6 and 8 threads and pieces of 8, 16 and 32 MiB, and ``upload``
   (its counters), each a host clock around a call that returns with the
   bytes on the card;
5. which calls ``torch.cuda.set_sync_debug_mode("warn")`` reports as a
   synchronisation: ``Event.synchronize``, ``Event.query``,
   ``Stream.synchronize``, a blocking
   copy from pinned memory, a non-blocking one.

Prints the card's name and power limit first and one JSON object last (also
written to ``--json``).  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from iterative_cleaner_tpu_torch.backends import torch_backend as tb  # noqa: E402
from iterative_cleaner_tpu_torch.ingest import staging  # noqa: E402
from iterative_cleaner_tpu_torch.obs import tracing  # noqa: E402

PIECE_BYTES = 32 << 20


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


def median_s(fn, reps: int) -> list[float]:
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return out


def host_memcpy(src: np.ndarray, threads: int, reps: int, pinned: bool) -> dict:
    """GB/s of copying ``src`` with ``threads`` threads: into reused pinned
    pieces (two a thread) or into one pageable array of its size."""
    flat = src.reshape(-1)
    piece = PIECE_BYTES // flat.itemsize
    if pinned:
        bufs = [torch.empty(piece, dtype=torch.float32, pin_memory=True).numpy()
                for _ in range(2 * threads)]
    else:
        dst = np.empty_like(flat)
        dst[...] = 0.0
    starts = list(range(0, flat.size, piece))
    shares = [starts[t::threads] for t in range(threads)]

    def work(t):
        for k, lo in enumerate(shares[t]):
            hi = min(lo + piece, flat.size)
            out = bufs[2 * t + k % 2][: hi - lo] if pinned else dst[lo:hi]
            np.copyto(out, flat[lo:hi])

    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(work, range(threads)))   # warm: pages faulted, threads up
        times = median_s(lambda: list(pool.map(work, range(threads))), reps)
    return {"threads": threads, "GBps": flat.nbytes / statistics.median(times) / 1e9,
            "s": times}


def sync_kinds(dev) -> dict:
    """Warnings that the sync debug mode gives for each call."""
    host = torch.empty(1 << 20, dtype=torch.float32, pin_memory=True)
    d = torch.empty(1 << 20, dtype=torch.float32, device=dev)
    ev, st = torch.cuda.Event(), torch.cuda.Stream(dev)
    calls = {
        "Event.synchronize": lambda: (ev.record(st), ev.synchronize()),
        "Event.query": lambda: (ev.record(st), ev.query()),
        "Stream.synchronize": lambda: st.synchronize(),
        "copy_ from pinned, blocking": lambda: d.copy_(host),
        "copy_ from pinned, non_blocking": lambda: d.copy_(host, non_blocking=True),
        "copy_ from a pageable from_numpy": lambda: d.copy_(torch.from_numpy(np.ones(1 << 20, np.float32))),
    }
    out = {}
    torch.cuda.synchronize(dev)  # ict: backend-init-ok(the tensors above are on the card: CUDA is live)
    for name, fn in calls.items():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")  # ict: backend-init-ok(CUDA is live)
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)  # ict: backend-init-ok(CUDA is live)
        out[name] = sum("called a synchronizing" in str(w.message) for w in caught)
        torch.cuda.synchronize(dev)  # ict: backend-init-ok(CUDA is live)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None)
    ap.add_argument("--gib", type=float, default=1.0)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card: this probe measures the card's host and the card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_line()
    print("card:", card, flush=True)
    cores = len(os.sched_getaffinity(0))
    res = {"card": card, "cpu_count": os.cpu_count(), "affinity": cores,
           "torch": torch.__version__, "gib": args.gib}
    n = int(args.gib * (1 << 30)) // 4
    src = np.random.default_rng(0).standard_normal(n, dtype=np.float32)

    ladder = sorted({t for t in (1, 2, 4, 6, 8, 12, 16, cores) if t <= max(cores, 1)})
    res["memcpy_pinned"] = [host_memcpy(src, t, args.reps, True) for t in ladder]
    res["memcpy_pageable"] = [host_memcpy(src, t, args.reps, False) for t in (1, cores)]
    for row in res["memcpy_pinned"]:
        print(f"host memcpy into pinned pieces, {row['threads']} threads: "
              f"{row['GBps']:.2f} GB/s", flush=True)

    allocs = {}
    for mib in (256, 512):
        t0 = time.perf_counter()
        buf = torch.empty(mib << 20, dtype=torch.uint8, pin_memory=True)
        allocs[mib] = time.perf_counter() - t0
        del buf
    res["pin_alloc_s"] = allocs

    pinned = torch.empty(n, dtype=torch.float32, pin_memory=True)
    pinned.numpy()[...] = src
    d = torch.empty(n, dtype=torch.float32, device=dev)
    dma = []
    for _ in range(args.reps + 1):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        d.copy_(pinned, non_blocking=True)
        b.record()
        b.synchronize()
        dma.append(a.elapsed_time(b) / 1e3)
    res["dma_pinned_GBps"] = src.nbytes / statistics.median(dma[1:]) / 1e9
    del pinned, d

    def timed(fn):
        def run():
            out = fn()
            torch.cuda.synchronize(dev)  # ict: backend-init-ok(times device work: CUDA is live)
            return out
        run()
        times = median_s(run, args.reps)
        return {"GBps": src.nbytes / statistics.median(times) / 1e9, "s": times}

    cube = src.reshape(256, -1, 1024) if n % (256 * 1024) == 0 else src.reshape(1, 1, -1)
    res["pageable_to"] = timed(lambda: torch.from_numpy(cube).to(dev))
    res["to_device"] = timed(lambda: tb.to_device(cube, dev))
    four = np.empty((cube.shape[0], 4, *cube.shape[1:]), np.float32)
    four[:, 0] = cube
    res["to_device_pol0"] = timed(lambda: tb.to_device(four[:, 0], dev))
    assert torch.equal(tb.to_device(four[:, 0], dev).cpu(), torch.from_numpy(cube))
    del four
    res["staged_variants"] = []
    for threads in sorted({t for t in (4, 6, 8, cores) if t <= cores}):
        for mib in (8, 16, 32):
            t0 = time.perf_counter()
            pool = staging.StagingPool(dev, threads=threads, piece_bytes=mib << 20)
            made = time.perf_counter() - t0
            dst = torch.empty(cube.shape, dtype=torch.float32, device=dev)
            row = timed(lambda: pool.fill(dst, cube))
            row.update(threads=threads, piece_mib=mib, make_s=made)
            res["staged_variants"].append(row)
            print(f"staged fill, {threads} threads, {mib} MiB pieces: {row['GBps']:.2f} GB/s",
                  flush=True)
            pool.close()
            del pool, dst
    snap = tracing.snapshot()
    res["upload"] = timed(lambda: tb.upload(dev, torch.float32, cube))
    res["upload_counters"] = {k: tracing.delta(snap, k) for k in (
        "clean_upload_bytes", "clean_upload_s", "clean_upload_n", "clean_upload_staged")}
    res["gauges"] = tracing.gauges_snapshot()[0]
    res["sync_warnings"] = sync_kinds(dev)
    for key in ("dma_pinned_GBps",):
        print(f"{key}: {res[key]:.2f}")
    for key in ("pageable_to", "to_device", "to_device_pol0", "upload"):
        print(f"{key}: {res[key]['GBps']:.2f} GB/s")
    line = json.dumps(res)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
