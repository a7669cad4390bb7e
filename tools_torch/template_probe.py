#!/usr/bin/env python3
"""Measure the design choices of the ordered-template kernel on one CUDA card.

    python3 tools_torch/template_probe.py [--json PATH] [--sass PATH]

Builds ``csrc/ordered_template.cu`` as it ships and in variants with other
bins per block, rows per stage and stage counts (``-DICT_TEMPLATE_BINS``,
``-DICT_TEMPLATE_ROWS``, ``-DICT_TEMPLATE_STAGES``), and one whose producers
copy only the weights (``-DICT_TEMPLATE_SKIP_COPIES``: the chain warp and
the ring's handshake without the loads), one nvcc each, all started
together, into the package's ``_build/``.  Then, on the card:

1. every variant and both load paths against ``build_template_plain`` bit
   for bit at small ragged shapes (the unaligned path takes any input);
2. the chain probe: one warp's time per dependent float32 add;
3. each variant's time on both paths at 256 x 1024 x 1024 (BASELINE.json
   config #2), over a contiguous batch of 8 such cubes and over the sweep's
   9 pairs of one cube (archive stride 0), each bit-identical to the
   shipped build's aligned path (the package's own launch too), beside the
   byte bound and the chain floor, with the SM cycles per row;
4. the float64 build (``--x64``) with its ring at 128 rows a stage (as it
   ships: a stage of the float32 build's bytes) and at 256
   (``-DICT_TEMPLATE_ROWS64``: twice the shared memory), at 256 x 1024 x
   1024 in float64, bit for bit the float64 plain version, beside the
   float64 chain floor and the byte bound.

Prints the card's name and power limit first and one JSON object last
(also written to ``--json``).  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from iterative_cleaner_tpu_torch.ops import cuda_build  # noqa: E402
from iterative_cleaner_tpu_torch.ops import template as tp  # noqa: E402

PEAK_BYTES_PER_S = 3.35e12
LOFAR = (256, 1024, 1024)
SHIPPED = (tp.TEMPLATE_BINS_PER_BLOCK, tp.TEMPLATE_STAGES, tp.TEMPLATE_ROWS_PER_STAGE)
#: (bins per block, stages, rows per stage, producers skip the rows' copies);
#: the first is the shipped build.  The last builds the shipped constants
#: with producers that copy only the weights: the chain warp and the ring's
#: handshake without the loads (its sums are not the template's).
VARIANTS = tuple(dict.fromkeys((
    (*SHIPPED, False), (16, 6, 256, False), (16, 4, 256, False), (16, 3, 256, False),
    (16, 6, 128, False), (32, 4, 128, False), (32, 3, 256, False), (8, 6, 256, False),
    (*SHIPPED, True))))
SMALL = ((5, 33, 100), (3, 7, 31), (8, 64, 257), (2, 3, 8), (1, 1, 1024))
#: Rows per stage of the float64 build; the first ships.
ROWS64 = (tp.TEMPLATE_ROWS_PER_STAGE_F64, 256)


def load_variant(defines: tuple[str, ...]):
    out = cuda_build.build("ordered_template", defines)
    lib = ctypes.CDLL(str(out))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for entry in ("ordered_template_launch", "ordered_template_launch_f64"):
        getattr(lib, entry).argtypes = [p] * 4 + [i64, i32, i32, i64, i64, i32, p]
        getattr(lib, entry).restype = i32
    lib.ordered_template_error_string.argtypes = [i32]
    lib.ordered_template_error_string.restype = ctypes.c_char_p
    lib.ordered_template_constants.argtypes = [p]
    consts = (ctypes.c_int * 7)()
    lib.ordered_template_constants(consts)
    return lib, tuple(consts), cuda_build.build_log("ordered_template", defines)


def build_variant(bins: int, stages: int, rows: int, skip: bool):
    return load_variant((f"ICT_TEMPLATE_BINS={bins}", f"ICT_TEMPLATE_STAGES={stages}",
                         f"ICT_TEMPLATE_ROWS={rows}",
                         *(("ICT_TEMPLATE_SKIP_COPIES",) if skip else ())))


def name(v) -> str:
    return f"bins{v[0]}_stages{v[1]}_rows{v[2]}" + ("_skip_copies" if v[3] else "")


def run(lib, D, w, path: int, narch: int):
    """The kernel over ``narch`` archives of ``D`` / ``w`` as they are laid
    out (their archive strides, 0 where broadcast)."""
    nbin = D.shape[-1]
    nprof = (D[0] if D.dim() == 4 else D).numel() // nbin
    wv = w.reshape(narch, nprof)
    out = torch.empty((narch, nbin), dtype=D.dtype, device=D.device)
    entry = tp.ENTRIES[D.dtype][0]
    err = getattr(lib, entry)(
        D.data_ptr(), wv.data_ptr(), None, out.data_ptr(), nprof, nbin, narch,
        D.stride(0) if D.dim() == 4 else nprof * nbin, wv.stride(0), path,
        torch.cuda.current_stream().cuda_stream)  # ict: backend-init-ok(the operands are on the card: CUDA is live)
    if err:
        raise RuntimeError(f"launch failed: {lib.ordered_template_error_string(err).decode()}")
    return out


def time_ms(fn, runs=10) -> float:
    fn()
    torch.cuda.synchronize()  # ict: backend-init-ok(times device work: CUDA is live)
    ts = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return sorted(ts)[len(ts) // 2]


def same(a, b) -> bool:
    nan = torch.isnan(a)
    bits = torch.int64 if a.dtype == torch.float64 else torch.int32
    return bool((nan == torch.isnan(b)).all()) and bool(
        ((a.view(bits) == b.view(bits)) | nan).all())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None)
    ap.add_argument("--sass", default=None, help="write the shipped build's SASS here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    with ThreadPoolExecutor(len(VARIANTS) + len(ROWS64)) as pool:
        built64 = [pool.submit(load_variant, (f"ICT_TEMPLATE_ROWS64={r}",)) for r in ROWS64]
        built = dict(zip(VARIANTS, pool.map(lambda v: build_variant(*v), VARIANTS)))
        built64 = dict(zip(ROWS64, (f.result() for f in built64)))
    for v, (_, consts, log) in built.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"variant {name(v)}: constants {consts}; " + " | ".join(regs), flush=True)
    result = {"card": smi.stdout.strip(), "variants": {}}
    if args.sass:
        lib_path = cuda_build.build("ordered_template")
        with open(args.sass, "w") as fh:
            fh.write(subprocess.run([os.path.join(os.path.dirname(cuda_build.find_nvcc()),
                                                  "cuobjdump"), "-sass", str(lib_path)],
                                    capture_output=True, text=True).stdout)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(606)
    for shape in SMALL:
        D = torch.randn(shape, generator=gen, device="cuda") * 3
        w = torch.rand(shape[:2], generator=gen, device="cuda")
        w[torch.rand(shape[:2], generator=gen, device="cuda") < 0.2] = 0.0
        want = tp.build_template_plain(D, w)
        for v, (lib, _, _) in built.items():
            if v[3]:
                continue
            for path in (0, 1) if shape[-1] % 4 == 0 else (1,):
                got = run(lib, D, w, path, 1)[0]
                torch.cuda.synchronize()  # ict: backend-init-ok(times device work: CUDA is live)
                if not same(got, want):
                    raise AssertionError(f"variant {v} path {path} at {shape}: kernel != plain")
    print(f"small shapes {SMALL}: every variant and path == plain bit for bit", flush=True)

    n_adds = 1 << 24
    ms, cycles = tp.chain_probe(n_adds)
    ms, cycles = tp.chain_probe(n_adds)
    t_add_ms = ms / n_adds
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip()
    print(f"chain probe: {n_adds} dependent adds in {ms:.4f} ms, {cycles / n_adds:.3f} "
          f"cycles and {t_add_ms * 1e6:.4f} ns per add (SM clock read after: {clock})",
          flush=True)
    result["chain"] = {"ms_per_add": t_add_ms, "cycles_per_add": cycles / n_adds,
                       "sm_clock": clock}
    clock_hz = cycles / (ms * 1e-3)   # the SM clock the probe ran at

    nsub, nchan, nbin = LOFAR
    D = torch.randn(LOFAR, generator=gen, device="cuda")
    w = 0.8 + 0.4 * torch.rand((nsub, nchan), generator=gen, device="cuda")
    cases = {
        "lofar": (D, w, 1),
        "batch8": (torch.stack([D] * 8), torch.stack([w] * 8), 8),
        "sweep9": (D.expand(9, *LOFAR), torch.rand((9, nsub, nchan), generator=gen,
                                                   device="cuda"), 9),
    }
    ref = {k: run(built[VARIANTS[0]][0], *c[:2], 0, c[2]) for k, c in cases.items()}
    check = tp.build_template(D, w)   # the package's own launch equals the shipped build
    if not same(check, ref["lofar"][0]):
        raise AssertionError("ops/template.build_template != the shipped build at LOFAR")
    torch.cuda.synchronize()  # ict: backend-init-ok(times device work: CUDA is live)
    for case, (Dc, wc, narch) in cases.items():
        nprof = nsub * nchan
        bytes_moved = 4 * (narch if case != "sweep9" else 1) * nprof * nbin
        bytes_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
        chain_ms = nprof * t_add_ms
        print(f"{case}: byte bound {bytes_ms:.4f} ms, chain floor {chain_ms:.4f} ms", flush=True)
        for v, (lib, _, _) in built.items():
            row = result["variants"].setdefault(name(v), {})
            for path in (0, 1):
                ms = time_ms(lambda: run(lib, Dc, wc, path, narch))
                if not v[3] and not same(run(lib, Dc, wc, path, narch), ref[case]):
                    raise AssertionError(f"variant {v} path {path} on {case} differs")
                row[f"{case}_{tp.PATHS[path]}_ms"] = ms
                print(f"  {name(v):32s} {tp.PATHS[path]:9s}: {ms:.4f} ms, "
                      f"{ms * 1e-3 * clock_hz / nprof:.2f} SM cycles a row "
                      f"({bytes_moved / (ms * 1e-3) / 1e9:.1f} GB/s)", flush=True)
        result[case] = {"bytes_ms": bytes_ms, "chain_ms": chain_ms}
    del cases, ref

    # The float64 build at LOFAR: its chain, its rows per stage.
    ms, cycles = tp.chain_probe(n_adds, dtype=torch.float64)
    ms, cycles = tp.chain_probe(n_adds, dtype=torch.float64)
    t_add64 = ms / n_adds
    D64, w64 = D.double(), w.double()
    want = tp.build_template_plain(D64, w64)
    nprof = nsub * nchan
    bytes_ms = 8 * nprof * nbin / PEAK_BYTES_PER_S * 1e3
    print(f"float64: chain probe {t_add64 * 1e6:.4f} ns, {cycles / n_adds:.3f} cycles per "
          f"dependent add; at {LOFAR} byte bound {bytes_ms:.4f} ms, chain floor "
          f"{nprof * t_add64:.4f} ms", flush=True)
    result["float64"] = {"ms_per_add": t_add64, "cycles_per_add": cycles / n_adds,
                         "bytes_ms": bytes_ms, "chain_ms": nprof * t_add64, "rows": {}}
    for rows, (lib, consts, log) in built64.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"float64 rows{rows}: constants {consts}; " + " | ".join(regs), flush=True)
        row = result["float64"]["rows"][rows] = {}
        for path in (0, 1):
            if not same(run(lib, D64, w64, path, 1)[0], want):
                raise AssertionError(f"float64 rows {rows} path {path} != plain")
            row[tp.PATHS[path]] = ms = time_ms(lambda: run(lib, D64, w64, path, 1))
            print(f"  float64 rows{rows} {tp.PATHS[path]:9s}: {ms:.4f} ms, "
                  f"{ms * 1e-3 * clock_hz / nprof:.2f} SM cycles a row", flush=True)
    print(json.dumps(result), flush=True)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(result, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
