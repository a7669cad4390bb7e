#!/usr/bin/env python3
"""Time the host preprocess pass, step by step, on the card's host.

    python3 tools_torch/host_preprocess_probe.py [--json PATH] [--reps 5]
        [--nsub 256] [--npol 1] [--nchan 1024] [--nbin 1024]

On a LOFAR-shaped raw archive (256 × 1 × 1024 × 1024 float32 by default,
DM 12.455, period 0.714 s, 149 MHz centre, 78.125 MHz band, about 5 % zero
weights), the median of ``--reps`` runs after a warm one, each into a fresh
output as the program allocates one:

1. the shared pass ``ict_preprocess`` of ``native/ict_native.cc`` whole, and
   a copy of it with timers between its steps (roll, total, window,
   subtract; ``tools_torch/host_preprocess_probe.cc``'s ``probe_old``);
2. three reworked passes, each step timed: ``fused`` (a thread a range of
   bins rolls its slice of every profile and adds it to its own totals),
   ``split`` (a row-parallel roll of two contiguous copies, then the total
   by bins over the output) and ``deferred`` (the total by bins read
   straight from the source rows, then one row-parallel pass that rolls,
   takes the window mean and writes the output); each output checked byte
   for byte against ``ict_preprocess``, and each timed again into one
   reused, touched output;
3. a fresh output's first touch (one write a page, on every thread);
4. the memory floor: a 1 GiB ``np.copyto`` between touched arrays with 1
   thread and with the host's threads;
5. where the package's library has it, the program's own pass (the deferred
   form with no division a row in its total and stores that bypass the
   cache, ``iterative_cleaner_tpu_torch/csrc/host_preprocess.cc``):
   ``ict_host_preprocess`` into a fresh and into a touched output, and
   ``native.host_pass`` on the archive (into its reused output), each
   output's bytes against ``ict_preprocess``, with the threads it ran on.

The variants are built from the ``.cc`` beside this file with the flags of
``native.CXXFLAGS`` into the package's ``_build/``.  Needs ``g++``, not a
card; prints the card's name and power limit where there is one and one
JSON object last (also written to ``--json``).  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from iterative_cleaner_tpu_torch import native  # noqa: E402
from iterative_cleaner_tpu_torch.io.base import Archive  # noqa: E402
from iterative_cleaner_tpu_torch.ops import cuda_build  # noqa: E402
from iterative_cleaner_tpu_torch.ops.preprocess import archive_shifts, baseline_width  # noqa: E402

PROBE_SOURCE = Path(__file__).resolve().with_suffix(".cc")
VARIANTS = {"old": ("roll", "total", "window", "subtract"),
            "fused": ("roll_and_total", None, "window", "subtract"),
            "split": ("roll", "total", "window", "subtract"),
            "deferred": (None, "total", "window", "roll_and_subtract")}


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


def build_probe() -> ctypes.CDLL:
    out = cuda_build.keyed_library("host_preprocess_probe", PROBE_SOURCE.read_bytes(),
                                   native.CXXFLAGS, native.BUILD_DIR)
    if not out.exists():
        cmd = ["g++", *native.CXXFLAGS, str(PROBE_SOURCE)]
        proc = cuda_build.compile_shared(cmd, out, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    p, u32 = ctypes.c_void_p, ctypes.c_uint32
    for name in (f"probe_{v}" for v in VARIANTS):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, u32, u32, u32, u32, u32, u32, p, p]
        fn.restype = ctypes.c_int
    lib.probe_touch.argtypes = [p, ctypes.c_size_t]
    lib.probe_touch.restype = ctypes.c_int
    lib.probe_set_prefetch.argtypes = [ctypes.c_int]
    lib.probe_set_prefetch.restype = None
    return lib


MADV_HUGEPAGE, MADV_POPULATE_WRITE = 14, 23


def _madvise(a: np.ndarray, advice: int, lo: int = 0, hi: int | None = None) -> int:
    """madvise over the whole pages of bytes [lo, hi) of ``a``; 0 or errno."""
    libc = ctypes.CDLL(None, use_errno=True)
    page = os.sysconf("SC_PAGE_SIZE")
    start = a.ctypes.data + lo
    end = a.ctypes.data + (a.nbytes if hi is None else hi)
    first, last = -(-start // page) * page, end // page * page
    if last <= first:
        return 0
    rc = libc.madvise(ctypes.c_void_p(first), ctypes.c_size_t(last - first), advice)
    return 0 if rc == 0 else ctypes.get_errno()


def touch_options(shape, probe, threads: int, reps: int) -> dict:
    """Seconds to make a fresh float32 array of ``shape`` ready to write, by
    route, median of ``reps`` after a warm one."""
    nbytes = int(np.prod(shape)) * 4

    def empty_touch():
        out = np.empty(shape, np.float32)
        probe.probe_touch(out.ctypes.data, out.size)

    def huge_touch():
        out = np.empty(shape, np.float32)
        _madvise(out, MADV_HUGEPAGE)
        probe.probe_touch(out.ctypes.data, out.size)

    def mmap_populate():
        import mmap
        buf = mmap.mmap(-1, nbytes, flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS
                        | getattr(mmap, "MAP_POPULATE", 0x8000))
        np.frombuffer(buf, np.float32).reshape(shape)

    def populate_write(nthreads):
        def run():
            out = np.empty(shape, np.float32)
            edges = np.linspace(0, out.nbytes, nthreads + 1).astype(np.int64)
            with ThreadPoolExecutor(nthreads) as pool:
                errs = list(pool.map(lambda t: _madvise(out, MADV_POPULATE_WRITE,
                                                        int(edges[t]), int(edges[t + 1])),
                                     range(nthreads)))
            if any(errs):
                raise OSError(errs[0], "madvise(MADV_POPULATE_WRITE)")
        return run

    routes = {"np.empty + touch": empty_touch, "np.empty + MADV_HUGEPAGE + touch": huge_touch,
              "mmap MAP_POPULATE": mmap_populate,
              "np.empty + MADV_POPULATE_WRITE, 1 thread": populate_write(1),
              f"np.empty + MADV_POPULATE_WRITE, {threads} threads": populate_write(threads)}
    out = {}
    for name, fn in routes.items():
        try:
            times = []
            for _ in range(reps + 1):
                t0 = time.perf_counter()
                fn()
                times.append(time.perf_counter() - t0)
            out[name] = statistics.median(times[1:])
        except OSError as exc:
            out[name] = f"failed: {exc}"
    return out


def make_archive(nsub: int, npol: int, nchan: int, nbin: int) -> Archive:
    rng = np.random.default_rng(12455)
    data = rng.standard_normal((nsub, npol, nchan, nbin), dtype=np.float32)
    weights = (rng.random((nsub, nchan)) >= 0.05).astype(np.float32)
    freqs = 149.0 + 78.125 * (np.arange(nchan) / nchan - 0.5)
    return Archive(data=data, weights=weights, freqs=freqs, centre_frequency=149.0,
                   dm=12.455, period=0.714, state="Intensity" if npol == 1 else "Coherence")


def floor_copy(src: np.ndarray, dst: np.ndarray, threads: int, reps: int) -> dict:
    """GB/s of ``np.copyto`` of ``src`` into the touched ``dst``, each of
    ``threads`` threads copying one slice."""
    a, b = src.reshape(-1), dst.reshape(-1)
    edges = np.linspace(0, a.size, threads + 1).astype(np.int64)

    def work(t):
        np.copyto(b[edges[t]:edges[t + 1]], a[edges[t]:edges[t + 1]])

    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(work, range(threads)))
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            list(pool.map(work, range(threads)))
            times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    return {"threads": threads, "s": med, "GBps": a.nbytes / med / 1e9, "runs": times}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--nsub", type=int, default=256)
    ap.add_argument("--npol", type=int, default=1)
    ap.add_argument("--nchan", type=int, default=1024)
    ap.add_argument("--nbin", type=int, default=1024)
    args = ap.parse_args(argv)
    lib = native.get_lib()
    if lib is None:
        print(f"the native library did not build:\n{native.build_log()}", file=sys.stderr)
        return 2
    probe = build_probe()
    card = card_line()
    print("card:", card, flush=True)
    ar = make_archive(args.nsub, args.npol, args.nchan, args.nbin)
    nsub, npol, nchan, nbin = ar.data.shape
    shifts = archive_shifts(ar)
    width = baseline_width(nbin)
    state = native.STATE_TO_ENUM[ar.state]
    cores = len(os.sched_getaffinity(0))
    res = {"card": card, "cpu_count": os.cpu_count(), "affinity": cores,
           "omp_num_threads": os.environ.get("OMP_NUM_THREADS"),
           "shape": [nsub, npol, nchan, nbin], "state": ar.state, "width": width,
           "reps": args.reps}
    ptr = lambda a: a.ctypes.data  # noqa: E731
    ops = (ptr(ar.data), ptr(ar.weights), ptr(shifts), nsub, npol, nchan, nbin, state, width)

    def shared():
        out = np.empty((nsub, nchan, nbin), np.float32)
        t0 = time.perf_counter()
        rc = lib.ict_preprocess(
            native._fptr(ar.data), native._fptr(ar.weights),
            shifts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            nsub, npol, nchan, nbin, state, width, native._fptr(out))
        assert rc == 0
        return time.perf_counter() - t0, out

    runs = [shared() for _ in range(args.reps + 1)][1:]
    want = runs[-1][1]
    res["ict_preprocess_s"] = statistics.median(r[0] for r in runs)
    print(f"ict_preprocess whole: {res['ict_preprocess_s']:.4f} s", flush=True)
    del runs

    res["variants"], res["variants_touched"] = {}, {}
    touched = np.zeros((nsub, nchan, nbin), np.float32)
    for name, labels in VARIANTS.items():
        fn = getattr(probe, f"probe_{name}")
        for key, fresh in (("variants", True), ("variants_touched", False)):
            walls, steps, same, threads = [], [], True, 0
            for _ in range(args.reps + 1):
                out = np.empty((nsub, nchan, nbin), np.float32) if fresh else touched
                st = np.zeros(4, np.float64)
                t0 = time.perf_counter()
                threads = fn(*ops, ptr(out), ptr(st))
                walls.append(time.perf_counter() - t0)
                steps.append(st)
                same = same and out.tobytes() == want.tobytes()
                del out
            row = {"s": statistics.median(walls[1:]), "runs": walls[1:], "threads": threads,
                   "identical": same}
            for k, label in enumerate(labels):
                if label:
                    row[label] = statistics.median(float(st[k]) for st in steps[1:])
            res[key][name] = row
            print(f"{name}{'' if fresh else ' (touched output)'}: {row['s']:.4f} s, "
                  f"identical {same}, "
                  + ", ".join(f"{k} {row[k]:.4f}" for k in labels if k), flush=True)

    res["deferred_by_prefetch"] = {}
    for rows in (0, 2, 4, 8, 16, 32):
        probe.probe_set_prefetch(rows)
        walls, totals, rolls = [], [], []
        for k in range(args.reps + 1):
            out = touched if rows == 0 and k % 2 else np.empty((nsub, nchan, nbin), np.float32)
            st = np.zeros(4, np.float64)
            t0 = time.perf_counter()
            probe.probe_deferred(*ops, ptr(out), ptr(st))
            walls.append(time.perf_counter() - t0)
            totals.append(st[1])
            rolls.append((st[3], out is touched))
            del out
        res["deferred_by_prefetch"][rows] = {
            "s": statistics.median(walls[1:]), "total": statistics.median(totals[1:]),
            "roll_and_subtract_fresh": statistics.median(
                [r for r, t in rolls[1:] if not t] or [float("nan")]),
            "roll_and_subtract_touched": statistics.median(
                [r for r, t in rolls[1:] if t] or [float("nan")])}
        print(f"deferred, prefetch {rows} rows: {res['deferred_by_prefetch'][rows]}", flush=True)
    probe.probe_set_prefetch(0)
    del touched

    res["fresh_output"] = touch_options((nsub, nchan, nbin), probe, cores, args.reps)
    res["first_touch_s"] = res["fresh_output"]["np.empty + touch"]
    for name, v in res["fresh_output"].items():
        print(f"fresh output, {name}: {v}", flush=True)

    src = ar.data.reshape(-1)[: (1 << 30) // 4] if ar.data.nbytes >= 1 << 30 else ar.data
    dst = np.empty_like(src)
    dst[...] = 0.0
    res["floor_copy"] = [floor_copy(src, dst, t, args.reps) for t in sorted({1, cores})]
    for row in res["floor_copy"]:
        print(f"np.copyto {src.nbytes / 2**30:.2f} GiB, {row['threads']} threads: "
              f"{row['s']:.4f} s, {row['GBps']:.2f} GB/s", flush=True)
    del dst

    if hasattr(lib, "ict_host_preprocess"):
        res["program"] = {}
        touched = np.zeros((nsub, nchan, nbin), np.float32)
        for key, fresh in (("fresh_output", True), ("touched_output", False)):
            walls, same, threads = [], True, 0
            for _ in range(args.reps + 1):
                out = np.empty((nsub, nchan, nbin), np.float32) if fresh else touched
                t0 = time.perf_counter()
                threads = lib.ict_host_preprocess(
                    native._fptr(ar.data), native._fptr(ar.weights),
                    shifts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                    nsub, npol, nchan, nbin, state, width, native._fptr(out))
                walls.append(time.perf_counter() - t0)
                same = same and out.tobytes() == want.tobytes()
                del out
            res["program"][key] = {"s": statistics.median(walls[1:]), "runs": walls[1:],
                                   "identical": same, "threads": threads}
        del touched
        walls, same = [], True
        for _ in range(args.reps + 1):
            t0 = time.perf_counter()
            D, _w0, threads = native.host_pass(ar)
            walls.append(time.perf_counter() - t0)
            same = same and D.tobytes() == want.tobytes()
            del D
        res["program"]["host_pass"] = {"s": statistics.median(walls[1:]), "runs": walls[1:],
                                       "identical": same, "threads": threads}
        for key, row in res["program"].items():
            print(f"program pass, {key}: {row['s']:.4f} s, identical {row['identical']}, "
                  f"threads {row['threads']}", flush=True)
    line = json.dumps(res)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
