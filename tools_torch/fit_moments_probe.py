#!/usr/bin/env python3
"""Measure the design choices of the fit/moments kernel on one CUDA card.

    python3 tools_torch/fit_moments_probe.py [--json PATH] [--runs N] [--rounds N] [--sass PATH]

Builds ``csrc/fused_fit_moments.cu`` as it ships and with its other copy
path, 16-byte ``cp.async`` copies from the producer warp in place of the
TMA bulk copy (``-DICT_FIT_COPY=1``), one nvcc each, started together,
into the package's ``_build/``.  The ring's stages and rows and the grid
are launch arguments, so the other variants are launch plans
(``ops/fused_kernels.launch_plan`` with a choice overridden): stages, rows
per stage, blocks per SM, the 4-byte path on an aligned cube, and the
schedule closest to the first design's — one stage of one row per consumer
warp (one row in flight per warp) and one block per tile.  Then, on the
card:

1. every variant against ``fused_fit_moments_plain`` at small ragged
   shapes (phase 3's tolerances; zapped profiles exactly 0), each also at
   a base 4 bytes off 16 (the unaligned path);
2. every variant timed at 256 x 1024 x 1024 (BASELINE.json config #2), on
   the online slab 32 x 1024 x 1024, over a batch of 8 LOFAR cubes in one
   launch and on a chunk slab of the north star 1024 x 4096 x 1024 as the
   chunked route cuts it on a 32 GB card — device time of launches back to
   back, in rounds that alternate the variants' order, the median of the
   rounds — each bit-identical to the shipped plan, beside the byte bound
   (``chip_smoke._kernel_bound_ms``).

3. with ``--against DIR`` (a checkout of another commit of this repo, the
   parent for one): ``fused_fit_moments`` as a caller meets it — a call
   with the host's launch in it (``per_call_ms``, what ``chip_smoke.py``
   reports as ``ms``), device time of calls back to back (``device_ms``),
   one call queued behind a spin of the card (``spun_ms``: its device time
   alone, the host's launch hidden) and the host's time to return from a
   call (``host_ms``) —
   at 256 x 1024 x 1024, on the online slab, over the batch of 8 and on
   the north-star chunk, each tree in a process of its own that builds its
   own kernel, in the order DIR, this tree, this tree, DIR.

Prints the card's name and power limit first and one JSON object last
(also written to ``--json``).  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import ctypes  # noqa: E402

import torch  # noqa: E402

from chip_smoke import LOFAR, NORTH_STAR, ONLINE_SLAB, _kernel_bound_ms  # noqa: E402
from iterative_cleaner_tpu_torch.ops import cuda_build  # noqa: E402
from iterative_cleaner_tpu_torch.ops import fused_kernels as fk  # noqa: E402
from iterative_cleaner_tpu_torch.ops.template import build_template, build_templates  # noqa: E402
from iterative_cleaner_tpu_torch.parallel import autoshard  # noqa: E402

#: Build variants: name -> -D definitions ("shipped" is the package's build).
BUILDS = {"shipped": (), "cp_async16": ("ICT_FIT_COPY=1",)}
#: Launch variants: name -> (build, plan overrides); "one_block_per_tile"
#: sets blocks to the tile count.
VARIANTS = {
    "shipped": ("shipped", {}),
    "first_design_schedule": ("shipped", {"stages": 1, "rows": fk.KERNEL_CONSUMER_WARPS,
                                          "one_block_per_tile": True}),
    "stages2": ("shipped", {"stages": 2}),
    "stages3": ("shipped", {"stages": 3}),
    "stages6": ("shipped", {"stages": 6}),
    "rows2_stages8": ("shipped", {"stages": 8, "rows": 2}),
    "rows8_stages2": ("shipped", {"stages": 2, "rows": 8}),
    "rows8_stages3": ("shipped", {"stages": 3, "rows": 8}),
    "rows8_stages4": ("shipped", {"stages": 4, "rows": 8}),
    "rows8_stages2_blocks_per_sm3": ("shipped", {"stages": 2, "rows": 8, "blocks_per_sm": 3}),
    "blocks_per_sm1": ("shipped", {"blocks_per_sm": 1}),
    "blocks_per_sm2": ("shipped", {"blocks_per_sm": 2}),
    "blocks_per_sm2_stages6": ("shipped", {"blocks_per_sm": 2, "stages": 6}),
    "blocks_per_sm4_stages2": ("shipped", {"blocks_per_sm": 4, "stages": 2}),
    "unaligned_path": ("shipped", {"path": "unaligned"}),
    "cp_async16": ("cp_async16", {}),
}
SMALL = ((5, 33, 100), (8, 64, 257), (3, 7, 31), (2, 3, 8), (8, 128, 96), (16, 32, 4096),
         (2, 8, 9685))
TOL = {"centred": (1e-5, 1e-5), "mean": (1e-5, 1e-6), "std": (1e-5, 1e-6),
       "ptp": (1e-5, 1e-5)}


def build(name: str):
    defines = BUILDS[name]
    path = cuda_build.build("fused_fit_moments", defines)
    lib = ctypes.CDLL(str(path))
    consts = fk.bind(lib)
    return lib, consts, cuda_build.build_log("fused_fit_moments", defines)


def plan(D, name: str):
    """The variant's plan for ``D``, or None where its ring does not fit a
    block at this nbin."""
    over = dict(VARIANTS[name][1])
    try:
        if over.pop("one_block_per_tile", False):
            over["blocks"] = fk.plan_for(D, stages=over["stages"], rows=over["rows"]).tiles
        return fk.plan_for(D, **over)
    except ValueError:
        return None


def run(libs, name, D, t, w, v):
    return fk.launch(plan(D, name), D, t, w, v, lib=libs[VARIANTS[name][0]][0])


#: Run by ``--against`` in each tree: its wrapper's times, as JSON.
USER_TIMES = """
import json, time, torch
from iterative_cleaner_tpu_torch.ops import fused_kernels as fk
from iterative_cleaner_tpu_torch.ops.template import build_template, build_templates

def per_call(fn, runs):
    fn(); torch.cuda.synchronize(); ts = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record(); fn(); b.record(); b.synchronize(); ts.append(a.elapsed_time(b))
    return sorted(ts)[len(ts) // 2]

def device(fn, runs):
    fn(); torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2_000_000 * runs); a.record()
    for _ in range(runs):
        fn()
    b.record(); b.synchronize()
    return a.elapsed_time(b) / runs

def spun(fn, runs):
    fn(); torch.cuda.synchronize(); ts = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000); a.record(); fn(); b.record(); b.synchronize()
        ts.append(a.elapsed_time(b))
    return sorted(ts)[len(ts) // 2]

def host(fn, runs):
    fn(); torch.cuda.synchronize(); ts = []
    for _ in range(runs):
        t0 = time.perf_counter(); fn(); ts.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return sorted(ts)[len(ts) // 2]

gen = torch.Generator(device="cuda"); gen.manual_seed(7); out = {}
for name, shape in (("lofar", (256, 1024, 1024)), ("online_slab", (32, 1024, 1024)),
                    ("batch8", (8, 256, 1024, 1024)), ("north_star_chunk", (366, 4096, 1024))):
    D = torch.randn(shape, generator=gen, device="cuda")
    w = 0.8 + 0.4 * torch.rand(shape[:-1], generator=gen, device="cuda"); v = w != 0
    t = build_templates(D, w) if len(shape) == 4 else build_template(D, w)
    fn = lambda: fk.fused_fit_moments(D, t, w, v)
    out[name] = {"per_call_ms": per_call(fn, 20), "device_ms": device(fn, 10),
                 "spun_ms": spun(fn, 20), "host_ms": host(fn, 20)}
    del D, w, v, t
    torch.cuda.empty_cache()
print(json.dumps(out))
"""


def user_times(root: str) -> dict:
    """USER_TIMES in a process of its own on the tree at ``root``."""
    proc = subprocess.run([sys.executable, "-c", USER_TIMES], cwd=root, capture_output=True,
                          text=True, env={**os.environ, "PYTHONPATH": root}, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"the user timing in {root} failed:\n{proc.stdout}{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def time_ms(fn, runs: int) -> float:
    """Device milliseconds a call: ``runs`` calls back to back, queued
    behind a spin of the card long enough for the host to enqueue them all,
    between two CUDA events (the host's time to launch is not in it)."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2_000_000 * runs)
    a.record()
    for _ in range(runs):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / runs


def same_bits(a, b) -> bool:
    return a.shape == b.shape and bool((a.view(torch.int32) == b.view(torch.int32)).all())


def inputs(shape, gen, offset=0):
    nbin = shape[-1]
    n = 1
    for d in shape:
        n *= d
    D = torch.randn(n + offset, generator=gen, device="cuda")[offset:].view(shape)
    lead = shape[:-1]
    w = 0.8 + 0.4 * torch.rand(lead, generator=gen, device="cuda")
    w[torch.rand(lead, generator=gen, device="cuda") < 0.02] = 0.0
    t = build_templates(D, w) if len(shape) == 4 else build_template(D, w).reshape(nbin)
    return D, t.contiguous(), w, w != 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None)
    ap.add_argument("--runs", type=int, default=5, help="launches timed a round")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--sass", default=None, help="write the shipped build's SASS here")
    ap.add_argument("--against", default=None,
                    help="a checkout of another commit to time the wrapper against")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    with ThreadPoolExecutor(len(BUILDS)) as pool:
        libs = dict(zip(BUILDS, pool.map(build, BUILDS)))
    result = {"card": card, "builds": {}, "shapes": {}}
    for name, (_, consts, log) in libs.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"build {name}: constants {consts}; " + " | ".join(regs), flush=True)
        result["builds"][name] = {"constants": consts, "ptxas": regs}

    if args.sass:
        cuobjdump = os.path.join(os.path.dirname(cuda_build.find_nvcc()), "cuobjdump")
        with open(args.sass, "w") as fh:
            fh.write(subprocess.run([cuobjdump, "-sass", str(cuda_build.build(
                "fused_fit_moments"))], capture_output=True, text=True).stdout)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(707)
    for shape in SMALL:
        for offset in (0, 1):
            D, t, w, v = inputs(shape, gen, offset)
            want = fk.fused_fit_moments_plain(D, t, w, v)
            for name in VARIANTS:
                if plan(D, name) is None:
                    continue
                got = run(libs, name, D, t, w, v)
                torch.cuda.synchronize()
                for key, g, x in zip(TOL, got, want):
                    torch.testing.assert_close(
                        g, x, rtol=TOL[key][0], atol=TOL[key][1], equal_nan=True,
                        msg=lambda m, k=key, n=name, s=shape: f"{n} at {s}: {k}: {m}")
                zapped = w == 0
                if not all(bool((g[zapped] == 0).all()) for g in got[:3]):
                    raise AssertionError(f"{name} at {shape}: zapped profiles not 0")
            del D, t, w, v, want
    print(f"small shapes {SMALL}, each also at a base 4 bytes off 16 (the unaligned path): "
          "every variant whose ring fits == plain within phase 3's tolerances, zapped "
          "profiles exactly 0", flush=True)

    block = autoshard.block_subints(NORTH_STAR, 32 * 10**9, use_kernel=True)
    cases = {"lofar": (1, LOFAR), "online_slab": (1, ONLINE_SLAB), "batch8": (8, LOFAR),
             "north_star_chunk": (1, (block, *NORTH_STAR[1:]))}
    for case, (narch, shape) in cases.items():
        D, t, w, v = inputs((narch, *shape) if narch > 1 else shape, gen)
        ref = run(libs, "shipped", D, t, w, v)
        bound_ms, bound_by, nbytes = _kernel_bound_ms(narch, shape)
        rows = {name: {"ms": []} for name in VARIANTS}
        for name in VARIANTS:
            got = run(libs, name, D, t, w, v)
            if not all(same_bits(g, r) for g, r in zip(got, ref)):
                raise AssertionError(f"{name} on {case}: not bit-identical to shipped")
            del got
        # Rounds in alternating order, a few launches each: a drift of the
        # card's clock over the call falls on every variant alike.
        order = list(VARIANTS)
        for rnd in range(args.rounds):
            for name in order if rnd % 2 == 0 else order[::-1]:
                rows[name]["ms"].append(time_ms(lambda: run(libs, name, D, t, w, v), args.runs))
        for row in rows.values():
            row["median_ms"] = sorted(row["ms"])[len(row["ms"]) // 2]
        first = rows["first_design_schedule"]["median_ms"]
        print(f"{case} {narch} x {shape}: byte bound {bound_ms:.4f} ms ({nbytes / 1e9:.3f} GB, "
              f"{bound_by})", flush=True)
        for name, row in rows.items():
            p = plan(D, name)
            row.update(plan={"path": p.path, "stages": p.stages, "rows": p.rows_per_stage,
                             "blocks": p.blocks, "smem_bytes": p.smem_bytes},
                       share=bound_ms / row["median_ms"],
                       tb_s=nbytes / (row["median_ms"] * 1e-3) / 1e12)
            print(f"  {name:26s} {row['median_ms']:.4f} ms (rounds {min(row['ms']):.4f}-"
                  f"{max(row['ms']):.4f})  {row['share']:6.1%} of the bound, "
                  f"{row['tb_s']:.3f} TB/s, {row['median_ms'] / first:.3f}x the first design's "
                  f"schedule  (stages {p.stages}, rows {p.rows_per_stage}, blocks {p.blocks}, "
                  f"{p.path})", flush=True)
        result["shapes"][case] = {"shape": [narch, *shape], "bound_ms": bound_ms,
                                  "bound_by": bound_by, "bytes": nbytes, "variants": rows}
        del D, t, w, v, ref
        torch.cuda.empty_cache()
    if args.against:
        against = os.path.abspath(args.against)
        runs = [(root, user_times(root)) for root in (against, ROOT, ROOT, against)]
        result["against"] = {"dir": args.against, "runs": [
            {"tree": "against" if root == against else "this", **times} for root, times in runs]}
        for case in runs[0][1]:
            for key in ("per_call_ms", "device_ms", "spun_ms", "host_ms"):
                line = ", ".join(f"{'against' if root == against else 'this'} "
                                 f"{times[case][key]:.4f}" for root, times in runs)
                print(f"--against {args.against}: {case} {key}: {line}", flush=True)
    print(json.dumps(result), flush=True)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(result, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
