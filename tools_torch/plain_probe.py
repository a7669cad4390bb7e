#!/usr/bin/env python3
"""Time the kernels' plain PyTorch versions on one CUDA card at the shapes
where ``chip_smoke.py`` times only the kernel.

    python3 tools_torch/plain_probe.py [--json PATH]

``ordered_template``'s plain version (``ops/template.build_template_plain``:
the oracle's order, one row at a time) on the online slab (32 x 1024 x
1024), over a batch of 8 LOFAR cubes (256 x 1024 x 1024 each, a call per
archive), over the sweep's 9 weight pairs on one LOFAR cube (a call per
pair) and on the 1024 x 4096 x 1024 north-star cube;
``fused_fit_moments``'s (``ops/fused_kernels.fused_fit_moments_plain``) on
the north-star slab the chunked route cuts on a 32 GB card.  The inputs are
seeded random cubes made on the card, as ``chip_smoke.py`` makes them.  A
template call takes seconds and is timed once on the host clock between two
synchronisations; the fit, a call of tens of milliseconds, is the median of
5 CUDA-event timings after a warm-up.  Builds no kernel.

Prints the card's name and power limit first and one JSON object last (also
written to ``--json``).  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from iterative_cleaner_tpu_torch.ops import fused_kernels as fk  # noqa: E402
from iterative_cleaner_tpu_torch.ops import template as tp  # noqa: E402
from iterative_cleaner_tpu_torch.parallel import autoshard  # noqa: E402

LOFAR = (256, 1024, 1024)
ONLINE_SLAB = (32, 1024, 1024)
NORTH_STAR = (1024, 4096, 1024)


def _cube(shape, gen, prezap=0.01):
    """A random cube on the card and its weights with a share ``prezap``
    zapped (``chip_smoke._inputs`` without the template)."""
    nsub, nchan, _nbin = shape
    D = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32)
    w = 0.8 + 0.4 * torch.rand((nsub, nchan), generator=gen, device="cuda")
    w[torch.rand((nsub, nchan), generator=gen, device="cuda") < prezap] = 0.0
    return D, w


def _host_ms(fn) -> float:
    torch.cuda.synchronize()  # ict: backend-init-ok(times device work: CUDA is live)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()  # ict: backend-init-ok(times device work: CUDA is live)
    return (time.perf_counter() - t0) * 1e3


def _event_ms(fn, runs: int = 5) -> float:
    fn()
    torch.cuda.synchronize()  # ict: backend-init-ok(times device work: CUDA is live)
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[runs // 2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: none",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(9)
    out = {"device": torch.cuda.get_device_name(0), "template_plain_ms": {}}  # ict: backend-init-ok(the generator above made CUDA live)

    D, w = _cube(ONLINE_SLAB, gen)
    out["template_plain_ms"]["online_slab"] = _host_ms(lambda: tp.build_template_plain(D, w))
    del D, w
    cubes = [_cube(LOFAR, gen) for _ in range(8)]
    out["template_plain_ms"]["batch8"] = _host_ms(
        lambda: [tp.build_template_plain(D, w) for D, w in cubes])
    D = cubes[0][0]
    pairs = [cubes[k][1] for k in range(8)] + [cubes[0][1] * 0.5]
    out["template_plain_ms"]["sweep9"] = _host_ms(
        lambda: [tp.build_template_plain(D, w) for w in pairs])
    del cubes, D, pairs
    torch.cuda.empty_cache()
    D, w = _cube(NORTH_STAR, gen)
    out["template_plain_ms"]["north_star"] = _host_ms(lambda: tp.build_template_plain(D, w))
    del D, w
    torch.cuda.empty_cache()
    print(f"template plain, ms: {out['template_plain_ms']}", flush=True)

    block = autoshard.block_subints(NORTH_STAR, 32 * 10**9, use_kernel=True)
    shape = (block, *NORTH_STAR[1:])
    D, w = _cube(shape, gen)
    t = (w.reshape(-1) @ D.reshape(-1, shape[-1])).contiguous()
    valid = w != 0
    out["fit_plain_north_star_chunk"] = {
        "shape": list(shape),
        "ms": _event_ms(lambda: fk.fused_fit_moments_plain(D, t, w, valid))}
    print(f"fused_fit_moments plain at {shape}: "
          f"{out['fit_plain_north_star_chunk']['ms']:.3f} ms", flush=True)
    line = json.dumps(out)
    if args.json:
        with open(args.json, "w") as fh:
            fh.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
