#!/usr/bin/env python3
"""Score drift against the numpy oracle at the LOFAR shape, on the CPU.

    JAX_PLATFORMS=cpu python tools_torch/drift_envelope.py [--nsub 256 --nchan 1024 --nbin 1024]

Cleans ``io/synthetic.make_archive(seed=42)``, preprocessed, through

- the numpy oracle (the JAX package's ``backend="numpy"``);
- the JAX package on the CPU: ``backend="jax"``, stepwise, Pallas off (the
  XLA route its CPU tests run);
- the PyTorch port on the CPU: ``backend="torch"``, ``device="cpu"`` (the
  plain versions of its kernels);

and prints, for each route, the unit-floored relative drift of the last
iteration's scores against the oracle's — ``|a - b| / max(|b|, 1)``, the
measure of ``obs/audit.run_audit`` and its 5e-5 bound — with where the
largest drift sits, and the count of mask entries that differ.  Then the
port's last step again with one layer at a time taken from elsewhere (the
template: the port's, the oracle's, a matrix-vector product's; each of the
four raw diagnostics: the oracle's), to show which layer carries the
drift.  The full shape takes about 10 GB of host memory and a few minutes.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from iterative_cleaner_tpu.config import CleanConfig as JaxConfig  # noqa: E402
from iterative_cleaner_tpu.core.cleaner import clean_cube as jax_clean_cube  # noqa: E402
from iterative_cleaner_tpu.io.synthetic import make_archive as jax_make_archive  # noqa: E402
from iterative_cleaner_tpu.ops.preprocess import preprocess as jax_preprocess  # noqa: E402
from iterative_cleaner_tpu_torch.config import CleanConfig  # noqa: E402
from iterative_cleaner_tpu_torch.core.cleaner import clean_cube  # noqa: E402
from iterative_cleaner_tpu_torch.io.synthetic import make_archive  # noqa: E402
from iterative_cleaner_tpu_torch.ops.preprocess import preprocess  # noqa: E402

AUDIT_DRIFT_BOUND = 5e-5


def drift(scores, oracle) -> tuple[float, tuple[int, int], float]:
    """(max unit-floored drift, its (subint, channel), the oracle's score
    there) over the entries finite on both sides."""
    a = np.asarray(scores, np.float64)
    b = np.asarray(oracle, np.float64)
    fin = np.isfinite(a) & np.isfinite(b)
    d = np.where(fin, np.abs(a - b) / np.maximum(np.abs(b), 1.0), 0.0)
    at = np.unravel_index(int(np.argmax(d)), d.shape)
    return float(d[at]), (int(at[0]), int(at[1])), float(b[at])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nsub", type=int, default=256)
    p.add_argument("--nchan", type=int, default=1024)
    p.add_argument("--nbin", type=int, default=1024)
    args = p.parse_args(argv)
    shape = (args.nsub, args.nchan, args.nbin)

    t0 = time.perf_counter()
    D, w0 = jax_preprocess(jax_make_archive(*shape, seed=42), prefer_native=False)
    Dp, w0p = preprocess(make_archive(*shape, seed=42))
    same = np.array_equal(D, Dp) and np.array_equal(w0, w0p)
    del Dp, w0p
    print(f"cube {shape}, seed 42, preprocessed in {time.perf_counter() - t0:.1f}s; "
          f"the port's cube identical to the JAX package's: {same}", flush=True)

    t0 = time.perf_counter()
    ora = jax_clean_cube(D, w0, JaxConfig(backend="numpy"))
    print(f"numpy oracle: loops={ora.loops} in {time.perf_counter() - t0:.1f}s", flush=True)

    routes = [
        ("JAX package, CPU, stepwise, Pallas off",
         lambda: jax_clean_cube(D, w0, JaxConfig(backend="jax", pallas=False))),
        ("PyTorch port, CPU, stepwise (plain versions)",
         lambda: clean_cube(D, w0, CleanConfig(backend="torch"), device="cpu")),
    ]
    for name, run in routes:
        t0 = time.perf_counter()
        res = run()
        d, at, b = drift(res.test_results, ora.test_results)
        n_diff = int(np.sum(np.asarray(res.weights) != ora.weights))
        print(f"{name}: loops={res.loops}, {n_diff} mask entries differ, max score drift "
              f"{d:.4e} at (subint, channel) {at} where the oracle's score is {b:.6g}; "
              f"{'within' if d <= AUDIT_DRIFT_BOUND else 'beyond'} the {AUDIT_DRIFT_BOUND:g} "
              f"bound ({time.perf_counter() - t0:.1f}s)", flush=True)
        del res
    port_layers(D, w0, ora)
    return 0


def port_layers(D, w0, ora) -> None:
    """The port's last step on the CPU with one layer at a time taken from
    the oracle: which layer carries the drift."""
    import torch

    from iterative_cleaner_tpu_torch.backends import numpy_backend as nb
    from iterative_cleaner_tpu_torch.backends.torch_backend import TorchCleaner, step_from_template
    from iterative_cleaner_tpu_torch.core.cleaner import LoopState
    from iterative_cleaner_tpu_torch.ops.stats import MA_FILL, diagnostics, scale_and_combine
    from iterative_cleaner_tpu_torch.ops.template import build_template, fit_and_subtract

    cfg = CleanConfig(backend="torch")
    be = TorchCleaner(D, w0, cfg, device="cpu")
    loop = LoopState.start(w0)
    loop.run(be, cfg.max_iter)
    w_prev = loop.history[-2]
    Dt, wt = torch.from_numpy(D), torch.from_numpy(w0)
    valid = wt != 0
    wp = torch.from_numpy(w_prev)
    T = {"the port's (incremental)": be._tmpl,
         "the port's dense": build_template(Dt, wp),
         "the oracle's": torch.from_numpy(nb.build_template(D, w_prev)),
         "a matrix-vector product (summed in another order)":
             torch.matmul(wp.reshape(-1), Dt.reshape(-1, D.shape[-1]))}
    pr = cfg.pulse_region

    def report(name, test):
        d, at, b = drift(test.numpy(), ora.test_results)
        print(f"  layers: {name}: max score drift {d:.4e} at {at}", flush=True)

    for name, t in T.items():
        report(f"template {name}", step_from_template(Dt, wt, valid, t, 5.0, 5.0,
                                                      pulse_region=pr)[0])
    # The four raw diagnostics, the port's and the oracle's, on the port's template.
    _amp, resid = fit_and_subtract(Dt, T["the port's (incremental)"], pr)
    port_diag = diagnostics(resid * wt[..., None], valid)
    _amp, resid_np = nb.fit_template(D, T["the port's (incremental)"].numpy(), pr)
    data_ma = np.ma.masked_array(resid_np * w0[..., None],
                                 mask=np.repeat(~w0.astype(bool)[..., None], D.shape[-1], 2))
    centred = data_ma - np.expand_dims(data_ma.mean(axis=2), axis=2)
    fills = (0.0, 0.0, MA_FILL)
    ora_diag = [torch.from_numpy(np.where(w0 != 0, np.ma.getdata(x), f).astype(np.float32))
                for x, f in zip((np.ma.std(data_ma, axis=2), np.ma.mean(data_ma, axis=2),
                                 np.ma.ptp(data_ma, axis=2)), fills)]
    ora_diag.append(torch.from_numpy(
        np.max(np.abs(np.fft.rfft(centred, axis=2)), axis=2).astype(np.float32)))
    names = ("std", "mean", "ptp", "fft")
    for k, name in enumerate(names):
        mixed = list(port_diag)
        mixed[k] = ora_diag[k]
        rel = float(((port_diag[k] - ora_diag[k]).abs()
                     / ora_diag[k].abs().clamp_min(1e-30))[valid].max())
        report(f"the oracle's {name} diagnostic (max relative difference of the raw "
               f"diagnostic {rel:.3e})", scale_and_combine(*mixed, valid, 5.0, 5.0))
    report("all four of the oracle's diagnostics", scale_and_combine(*ora_diag, valid, 5.0, 5.0))


if __name__ == "__main__":
    sys.exit(main())
