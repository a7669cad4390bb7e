#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py      # needs one CUDA card; about 200 s on an H100

Phases, in order; any failure raises and the script exits non-zero:

1. environment — torch / CUDA versions and the card's name and power limit
   (``nvidia-smi``); no CUDA device is a failure;
2. build — every CUDA kernel of the main path, from the checkout's sources;
3. kernel vs plain — each kernel's wrapper against its plain PyTorch version
   on the card, at the main path's shape (256 x 1024 x 1024, BASELINE.json
   config #2) and at ragged small shapes, with fills, a pulse region, a zero
   template and pre-zapped profiles; times the kernel, its plain version and
   the least time the card could take (bytes or operations over its
   published peak);
4. main path — writes the seed-42 synthetic 256 x 1024 x 1024 archive,
   cleans it through ``iterative_cleaner_tpu_torch.cli.main`` with the
   defaults (torch backend, cuda, auto kernel, incremental template),
   checks that the kernel ran once per loop, and that the final mask is
   identical to the port's numpy oracle and to its kernel-off route on the
   same preprocessed cube; times each device layer of one iteration;
5. one JSON line of the kernels, then ``{"ok": true, "device": ...}`` last.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bandwidth and
# float32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

LOFAR = (256, 1024, 1024)     # BASELINE.json config #2: nsub x nchan x nbin
T_START = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T_START:7.1f}s] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


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
    log(f"device 0: {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} visible")
    return card


def phase_build():
    from iterative_cleaner_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    path = cuda_build.build("fused_fit_moments")
    log(f"built {path.name} in {time.perf_counter() - t0:.2f}s")
    for line in cuda_build.build_log("fused_fit_moments").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"  ptxas: {line.strip()}")


def _inputs(shape, gen, *, prezap=0.01, zero_template=False):
    import torch

    from iterative_cleaner_tpu_torch.ops.template import build_template

    nsub, nchan, nbin = shape
    D = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32)
    w0 = 0.8 + 0.4 * torch.rand((nsub, nchan), generator=gen, device="cuda")
    w0[torch.rand((nsub, nchan), generator=gen, device="cuda") < prezap] = 0.0
    t = (torch.zeros(nbin, device="cuda") if zero_template
         else build_template(D, w0).contiguous())
    return D, t, w0


def _time_ms(fn, runs: int) -> float:
    """Median of ``runs`` CUDA-event timings after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
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


def phase_kernel_parity():
    """fused_fit_moments (CUDA) vs fused_fit_moments_plain on the card."""
    import torch

    from iterative_cleaner_tpu_torch.ops import fused_kernels as fk

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    region = (0.25, 40.0, 90.0)
    cases = [
        ("lofar, valid", LOFAR, True, (0.0, 0.0, 1.0), {}),
        ("lofar, raw maps", LOFAR, False, (0.0, 0.0, 1.0), {}),
        ("5x33x100, raw maps", (5, 33, 100), False, (0.0, 0.0, 1.0), {}),
        ("5x33x100, valid", (5, 33, 100), True, (0.0, 0.0, 1.0), {}),
        ("8x128x96, valid, pulse region", (8, 128, 96), True, region, {}),
        ("8x64x256, pulse region", (8, 64, 256), False, region, {}),
        ("16x32x4096, valid", (16, 32, 4096), True, (0.0, 0.0, 1.0), {}),
        ("8x64x256, zero template", (8, 64, 256), True, (0.0, 0.0, 1.0),
         {"zero_template": True}),
        ("8x64x257, pre-zapped 20%", (8, 64, 257), False, (0.0, 0.0, 1.0),
         {"prezap": 0.2}),
    ]
    tol = {"centred": (1e-5, 1e-5), "mean": (1e-5, 1e-6),
           "std": (1e-5, 1e-6), "ptp": (1e-5, 1e-5)}
    max_err = 0.0
    fk.fused_fit_moments.launches = 0
    for name, shape, with_valid, pr, kw in cases:
        D, t, w0 = _inputs(shape, gen, **kw)
        valid = (w0 != 0) if with_valid else None
        got = fk.fused_fit_moments(D, t, w0, valid, pulse_region=pr)
        torch.cuda.synchronize()
        want = fk.fused_fit_moments_plain(D, t, w0, valid, pulse_region=pr)
        for key, g, w in zip(("centred", "mean", "std", "ptp"), got, want):
            rtol, atol = tol[key]
            torch.testing.assert_close(g, w, rtol=rtol, atol=atol, equal_nan=True,
                                       msg=lambda m, k=key, n=name: f"{n}: {k}: {m}")
            fin = torch.isfinite(w)
            if fin.any():
                max_err = max(max_err, float((g[fin] - w[fin]).abs().max()))
        zapped = w0 == 0
        for key, g in zip(("centred", "mean", "std"), got):
            sel = g[zapped] if key != "centred" else g[zapped].reshape(-1)
            check(bool((sel == 0).all()), f"{name}: {key} not exactly 0 at zapped profiles")
        log(f"  {name}: ok ({int(zapped.sum())} zapped profiles)")
        del D, t, w0, got, want
    check(fk.fused_fit_moments.launches == len(cases), "parity launches were not counted")
    torch.cuda.empty_cache()

    # Timing at the main path's shape and inputs (fills on, as the step runs it).
    D, t, w0 = _inputs(LOFAR, gen)
    valid = w0 != 0
    kernel_ms = _time_ms(lambda: fk.fused_fit_moments(D, t, w0, valid), runs=20)
    plain_ms = _time_ms(lambda: fk.fused_fit_moments_plain(D, t, w0, valid), runs=10)
    n, p, nbin = D.numel(), w0.numel(), LOFAR[2]
    # Each input read once, each output written once: D and centred (4 B per
    # element each), w0 + the three maps (4 B per profile each), valid (1 B
    # per profile), the template and bin scale, <t,t>.
    bytes_moved = 8 * n + 16 * p + p + 8 * nbin + 4
    # Per element: tp (mul, add), wr (mul, sub, mul, mul), sum/max/min,
    # centre, square and add: 12 f32 operations.
    ops = 12 * n
    bytes_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_F32_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"fused_fit_moments at {LOFAR}: kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={bound_ms:.4f} ({bytes_moved / 1e9:.3f} GB; "
        f"{bytes_moved / (kernel_ms * 1e-3) / 1e12:.3f} TB/s achieved); "
        f"max_abs_err={max_err:.3e}")
    del D, t, w0, valid
    torch.cuda.empty_cache()
    return {
        "name": "fused_fit_moments",
        "route": "cuda",
        "source": "iterative_cleaner_tpu_torch/csrc/fused_fit_moments.cu",
        "replaces": "iterative_cleaner_tpu/ops/pallas_kernels.py:201",
        "launches": None,
        "max_abs_err": max_err,
        "parity": "ok",
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }


def phase_main_path(entry):
    import numpy as np
    import torch

    from iterative_cleaner_tpu_torch import cli
    from iterative_cleaner_tpu_torch.config import CleanConfig
    from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
    from iterative_cleaner_tpu_torch.io.npz import NpzIO
    from iterative_cleaner_tpu_torch.io.synthetic import make_archive
    from iterative_cleaner_tpu_torch.ops import fused_kernels as fk
    from iterative_cleaner_tpu_torch.ops.preprocess import preprocess

    nsub, nchan, nbin = LOFAR
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="ict_smoke_") as tmp:
        t0 = time.perf_counter()
        ar = make_archive(nsub=nsub, nchan=nchan, nbin=nbin, seed=42)
        path = os.path.join(tmp, "lofar_seed42.npz")
        NpzIO().save(ar, path)
        log(f"wrote {path} ({os.path.getsize(path) / 1e9:.2f} GB) in "
            f"{time.perf_counter() - t0:.1f}s")

        report_path = os.path.join(tmp, "report.json")
        os.chdir(tmp)   # clean.log goes to the working directory
        try:
            torch.cuda.reset_peak_memory_stats()
            fk.fused_fit_moments.launches = 0
            t0 = time.perf_counter()
            rc = cli.main([path, "-q", "--dump_masks", "--report", report_path])
            wall = time.perf_counter() - t0
            launches = fk.fused_fit_moments.launches
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
        check(launches > 0, "the main path never launched the kernel")
        check(launches == len(iters) == loops,
              f"kernel launches {launches} != iterations {len(iters)} / loops {loops}")
        t0 = time.perf_counter()
        served = NpzIO().load(out_path).weights
        load_s = time.perf_counter() - t0
        log(f"  reading the cleaned archive back took {load_s:.1f}s (the CLI's own "
            f"load of the same-size input costs about as much); "
            f"{sum(iters):.3f}s of the CLI wall-clock was the cleaning loop")
        with np.load(out_path + "_masks.npz") as z:
            check(np.array_equal(z["history"][-1], served), "mask dump != cleaned weights")
            scores = z["test_results"]
        check(scores.shape == (nsub, nchan), f"scores shape {scores.shape}")
        n_zapped = int((served == 0).sum())
        log(f"  zapped {n_zapped} / {served.size} profiles "
            f"({int(np.isfinite(scores).sum())} finite scores)")
        check(0 < n_zapped < served.size, "implausible zap count")

        t0 = time.perf_counter()
        D, w0 = preprocess(ar)
        del ar
        log(f"preprocessed the same archive for the references in "
            f"{time.perf_counter() - t0:.1f}s")

        t0 = time.perf_counter()
        off = clean_cube(D, w0, CleanConfig(backend="torch", kernel=False), device="cuda")
        log(f"kernel-off route (plain PyTorch on the card): loops={off.loops} "
            f"in {time.perf_counter() - t0:.2f}s")
        check(fk.fused_fit_moments.launches == launches, "the kernel-off route launched it")
        check(np.array_equal(off.weights, served), "mask differs from the kernel-off route")
        check(off.loops == loops, "loops differ from the kernel-off route")

        layer_times(D, w0, served)

        t0 = time.perf_counter()
        ora = clean_cube(D, w0, CleanConfig(backend="numpy"))
        log(f"numpy oracle at full size {LOFAR}: loops={ora.loops} "
            f"in {time.perf_counter() - t0:.1f}s")
        n_diff = int((ora.weights != served).sum())
        check(n_diff == 0, f"{n_diff} mask entries differ from the numpy oracle")
        check(ora.loops == loops and ora.converged == rep["converged"],
              "loops/converged differ from the numpy oracle")
        fin = np.isfinite(ora.test_results) & np.isfinite(scores)
        drift = float(np.max(np.abs(scores[fin] - ora.test_results[fin])
                             / np.maximum(np.abs(ora.test_results[fin]), 1.0)))
        log(f"  mask identical to the oracle and the kernel-off route; "
            f"max score drift vs oracle {drift:.3e}")
    entry["launches"] = launches


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
    for name, fn in parts.items():
        log(f"  layer {name}: {_time_ms(fn, runs=10):.4f} ms")
    del Dt, wt, vt, new_w, t, c, m, s, p, f
    torch.cuda.empty_cache()


def main() -> int:
    phase_environment()
    import torch

    phase_build()
    entry = phase_kernel_parity()
    phase_main_path(entry)
    print(json.dumps({"kernels": [entry]}), flush=True)
    log(f"all phases passed in {time.perf_counter() - T_START:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
