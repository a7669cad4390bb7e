#!/usr/bin/env python3
"""Backend-equivalence fuzz sweep of the PyTorch port on one device.

    python3 tools_torch/fuzz_sweep.py [n_seeds] [start] [--x64] [--device cuda]

The counterpart of ``tools/fuzz_sweep.py``, importing nothing of JAX, so it
runs on the card.  Each seed draws a random configuration (shapes down to 3
bins, thresholds, RFI mixes, pre-zapped and dead profiles, pulse regions)
with :func:`draw_case`, a copy of ``tests/test_fuzz_equivalence.draw_case``
that gives the same archive and keyword arguments bit for bit, and demands
the port's numpy oracle's final mask, loop count and convergence from every
mode of the port on ``--device`` (default ``cuda``):

- ``stepwise`` and ``stepwise_dense`` (the incremental template, and the
  dense rebuild every iteration);
- ``fused`` and ``fused_dense``;
- ``chunked(b)``, ``chunked_serial(b)`` (``ICT_INGEST_DEPTH=1``) and
  ``chunked_dense(b)``, the block ``b`` drawn from the seed;
- ``kernel``: the fused loop with the CUDA fit/moments kernel forced on
  (float32 only; on the CPU its plain version), in place of the JAX tool's
  ``pallas`` mode;
- ``online``: seed-random blocks through an ``OnlineSession``, then the
  canonical finalize (:func:`run_online_case`, a copy of the test's);
- ``sharded``: the cube through ``parallel/sharded.sharded_clean_single``
  on ``make_mesh(8, devices=[device] * 8)``, eight logical devices of the
  one device (``dp=4 x sp=2``: its subints in two blocks, each launching
  the kernels on its own), as the JAX tool's 8-device mode (float32 only:
  the batched route declines x64);
- ``coalesced(k=3)``: three same-shape cubes of mixed seeds through the
  port's batched dispatch (``parallel/sharded.sharded_clean``; float32 only,
  as the batch has no x64 handling), each against its own oracle.

``--x64`` runs the float64 modes (stepwise, fused, chunked, online), as
``JAX_ENABLE_X64=1`` does for the JAX tool.

A mismatch writes a repro bundle (``obs/audit.write_repro_bundle`` under
``ICT_REPRO_DIR``, default ``./ict_repro``; replay it with
``tools_torch/replay_repro.py``) and the tool exits 1.  Per mode it prints
the seeds identical to the oracle, the largest last-iteration score drift
against the oracle (unit-floored relative, as ``obs/audit`` measures it),
the number of seeds whose template advanced by the sparse update at least
once and the kernels' launches in that mode; drift and launches are
reported, not gated.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def draw_case(seed: int):
    """One random configuration draw (deterministic per seed): the same
    archive and keyword arguments as ``tests/test_fuzz_equivalence.py``'s,
    from the port's synthetic generator."""
    from iterative_cleaner_tpu_torch.io.synthetic import RFISpec, make_archive

    rng = np.random.default_rng(seed)
    nsub = int(rng.integers(3, 13))
    nchan = int(rng.integers(8, 40))
    nbin = int(rng.choice([3, 4, 8, 16, 32, 64, 100, 128]))
    rfi = RFISpec(
        n_profile_spikes=int(rng.integers(0, 6)),
        n_dc_profiles=int(rng.integers(0, 4)),
        n_bad_channels=int(rng.integers(0, 3)),
        n_bad_subints=int(rng.integers(0, 3)),
        n_prezapped=int(rng.integers(0, 5)),
        amplitude=float(rng.uniform(10.0, 80.0)),
    )
    archive = make_archive(
        nsub=nsub, nchan=nchan, nbin=nbin, seed=seed + 10_000,
        snr=float(rng.uniform(5.0, 60.0)), rfi=rfi,
        dispersed=bool(rng.random() < 0.8),
    )
    D = archive.data
    if rng.random() < 0.25:
        # Dead hardware: an exactly-constant channel (and sometimes subint).
        D[:, :, int(rng.integers(0, nchan)), :] = float(rng.uniform(-3, 3))
    if rng.random() < 0.15:
        D[int(rng.integers(0, nsub))] = float(rng.uniform(-3, 3))
    if rng.random() < 0.3:
        pulse_region = (float(rng.uniform(0.0, 2.0)),
                        float(rng.integers(0, nbin // 2)),
                        float(rng.integers(nbin // 2, nbin)))
    else:
        pulse_region = (0.0, 0.0, 1.0)
    cfg = dict(
        chanthresh=float(rng.uniform(2.0, 9.0)),
        subintthresh=float(rng.uniform(2.0, 9.0)),
        max_iter=int(rng.integers(1, 7)),
        pulse_region=pulse_region,
    )
    return archive, cfg


def run_online_case(archive, kw, seed, x64=False, device="cuda"):
    """Feed an archive through an ``OnlineSession`` in seed-random blocks and
    finalize, as ``tests/test_fuzz_equivalence.run_online_case`` does.
    Returns the finalize CleanResult."""
    from iterative_cleaner_tpu_torch.config import CleanConfig
    from iterative_cleaner_tpu_torch.online import OnlineSession, SessionMeta

    rng = np.random.default_rng(seed + 77)
    sess = OnlineSession(
        SessionMeta.from_archive(archive),
        CleanConfig(backend="torch", x64=x64, **kw),
        alert_iters=int(rng.integers(1, 3)), device=device)
    lo, nsub = 0, archive.nsub
    while lo < nsub:
        bs = int(rng.integers(1, nsub - lo + 1))
        sess.ingest(archive.data[lo: lo + bs], archive.weights[lo: lo + bs])
        lo += bs
    return sess.finalize().result


def score_drift(scores, oracle) -> float:
    """Unit-floored relative drift over the entries finite on both sides
    (0 where there are none)."""
    scores, oracle = np.asarray(scores, np.float64), np.asarray(oracle, np.float64)
    fin = np.isfinite(scores) & np.isfinite(oracle)
    if not fin.any():
        return 0.0
    return float(np.max(np.abs(scores[fin] - oracle[fin]) / np.maximum(np.abs(oracle[fin]), 1.0)))


def _mode_list(kw, block: int, x64: bool):
    from iterative_cleaner_tpu_torch.config import CleanConfig

    def cfg(**extra):
        return CleanConfig(backend="torch", x64=x64, **kw, **extra)

    modes = [
        ("stepwise", cfg()),
        ("stepwise_dense", cfg(incremental_template=False)),
        ("fused", cfg(fused=True)),
        ("fused_dense", cfg(fused=True, incremental_template=False)),
        (f"chunked(b={block})", cfg(chunk_block=block)),
        (f"chunked_serial(b={block})", cfg(chunk_block=block)),
        (f"chunked_dense(b={block})", cfg(chunk_block=block, incremental_template=False)),
    ]
    if not x64:
        # The fit/moments kernel is float32 only: config refuses it with x64.
        modes.append(("kernel", cfg(fused=True, kernel=True)))
    return modes


#: The kernels' launch counters a mode's record reads.
KERNELS = ("fused_fit_moments", "ordered_template", "ordered_template_f64")


def counts() -> dict:
    """The sparse updates taken and each kernel's launches so far."""
    from iterative_cleaner_tpu_torch.backends.torch_backend import sparse_template_candidate
    from iterative_cleaner_tpu_torch.ops.fused_kernels import fused_fit_moments
    from iterative_cleaner_tpu_torch.ops.template import build_template

    return {"sparse": sparse_template_candidate.taken,
            "fused_fit_moments": fused_fit_moments.launches,
            "ordered_template": build_template.launches,
            "ordered_template_f64": build_template.launches_f64}


def run_seed(seed: int, x64: bool, device: str, stats: dict) -> tuple[list[str], dict, tuple]:
    """Every mode on one seed.  Returns (the modes that differ from the
    oracle, each mode's (weights, loops, converged, cfg), the inputs and the
    oracle's result)."""
    from iterative_cleaner_tpu_torch.config import CleanConfig
    from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
    from iterative_cleaner_tpu_torch.ops.preprocess import preprocess

    archive, kw = draw_case(seed)
    D, w0 = preprocess(archive)
    res_np = clean_cube(D, w0, CleanConfig(backend="numpy", **kw))
    block = int(np.random.default_rng(seed).integers(1, D.shape[0] + 1))
    results = {}

    def record(name, cfg, weights, loops, converged, scores, before):
        results[name] = (np.asarray(weights), int(loops), bool(converged), cfg)
        key = name if name.startswith("coalesced") else name.split("(")[0]
        st = stats.setdefault(key, {"drift": 0.0, "sparse_seeds": 0, "seeds": 0,
                                    "identical": 0, **dict.fromkeys(KERNELS, 0)})
        st["seeds"] += 1
        st["identical"] += bool(np.array_equal(weights, res_np.weights)
                                and loops == res_np.loops and converged == res_np.converged)
        if loops == res_np.loops and np.shape(scores) == np.shape(res_np.test_results):
            st["drift"] = max(st["drift"], score_drift(scores, res_np.test_results))
        now = counts()
        if now["sparse"] > before["sparse"]:
            st["sparse_seeds"] += 1
        for k in KERNELS:
            st[k] += now[k] - before[k]

    for name, cfg in _mode_list(kw, block, x64):
        serial = name.startswith("chunked_serial")
        prior = os.environ.get("ICT_INGEST_DEPTH")
        if serial:
            os.environ["ICT_INGEST_DEPTH"] = "1"
        before = counts()
        try:
            r = clean_cube(D, w0, cfg, device=device)
        finally:
            if serial:
                if prior is None:
                    os.environ.pop("ICT_INGEST_DEPTH", None)
                else:
                    os.environ["ICT_INGEST_DEPTH"] = prior
        record(name, cfg, r.weights, r.loops, r.converged, r.test_results, before)

    before = counts()
    r_on = run_online_case(archive, kw, seed, x64=x64, device=device)
    record("online", CleanConfig(backend="torch", x64=x64, **kw), r_on.weights, r_on.loops,
           r_on.converged, r_on.test_results, before)

    if not x64:
        from iterative_cleaner_tpu_torch.backends.torch_backend import resolve_device
        from iterative_cleaner_tpu_torch.io.synthetic import make_archive
        from iterative_cleaner_tpu_torch.parallel.mesh import make_mesh
        from iterative_cleaner_tpu_torch.parallel.sharded import (
            sharded_clean,
            sharded_clean_single,
        )

        cfg_sh = CleanConfig(backend="torch", **kw)
        before = counts()
        t_sh, w_sh, loops_sh, done_sh = sharded_clean_single(
            D, w0, cfg_sh, make_mesh(8, devices=[resolve_device(device)] * 8))
        record("sharded", cfg_sh, w_sh, loops_sh, done_sh, t_sh, before)

        # Three same-shape cubes of mixed seeds in one batched dispatch, each
        # against its own oracle: no result may bleed across the batch axis.
        extras = []
        for j in (1, 2):
            Dj, w0j = preprocess(make_archive(nsub=D.shape[0], nchan=D.shape[1],
                                              nbin=D.shape[2], seed=seed * 7 + j))
            extras.append((Dj, w0j, clean_cube(Dj, w0j, CleanConfig(backend="numpy", **kw))))
        cfg_co = CleanConfig(backend="torch", **kw)
        before = counts()
        tb, wb, loops_b, done_b = sharded_clean(
            np.stack([D] + [e[0] for e in extras]), np.stack([w0] + [e[1] for e in extras]),
            cfg_co, make_mesh(devices=[resolve_device(device)]))
        oracles = [res_np] + [e[2] for e in extras]
        ok = all(np.array_equal(wb[j], oracles[j].weights) and int(loops_b[j]) == oracles[j].loops
                 and bool(done_b[j]) == oracles[j].converged for j in range(3))
        # The lead archive (the seed's own cube) carries the bundle's inputs.
        record("coalesced(k=3)", cfg_co, wb[0] if ok else np.full_like(wb[0], -1.0),
               loops_b[0], done_b[0], tb[0], before)

    bad = [name for name, (w, loops, conv, _cfg) in results.items()
           if not (np.array_equal(w, res_np.weights) and loops == res_np.loops
                   and conv == res_np.converged)]
    return bad, results, (D, w0, res_np)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_seeds", nargs="?", type=int, default=100)
    ap.add_argument("start", nargs="?", type=int, default=1000)
    ap.add_argument("--x64", action="store_true", help="run the float64 modes")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    from iterative_cleaner_tpu_torch.backends.torch_backend import resolve_device
    from iterative_cleaner_tpu_torch.obs import audit

    device = resolve_device(args.device)
    print(f"fuzz sweep on {device}{' (x64)' if args.x64 else ''}: seeds {args.start}.."
          f"{args.start + args.n_seeds - 1}"
          f"{'' if args.x64 else '; the sharded mode on 8 logical devices of ' + str(device)}",
          flush=True)
    stats: dict = {}
    failures = []
    for seed in range(args.start, args.start + args.n_seeds):
        bad, results, (D, w0, res_np) = run_seed(seed, args.x64, str(device), stats)
        for name in bad:
            w, _loops, _conv, cfg = results[name]
            bundle = audit.write_repro_bundle(
                audit.default_repro_dir(), D=D, w0=w0, cfg=cfg,
                reason=f"fuzz_sweep seed {seed} mode {name}: mask/loop mismatch vs "
                       "the numpy oracle",
                weights_served=w, weights_oracle=res_np.weights, route=name)
            first = np.argwhere(w != res_np.weights)
            print(f"  seed {seed} mode {name}: first differing element "
                  f"{first[0].tolist() if len(first) else 'none (loops/converged)'}; "
                  f"repro bundle at {bundle or 'WRITE FAILED'}", flush=True)
        if bad:
            failures.append((seed, bad))
        print(f"seed {seed}: cube {D.shape} loops={res_np.loops} "
              f"zap={int((res_np.weights == 0).sum())} "
              f"{'FAIL ' + ','.join(bad) if bad else 'ok'}", flush=True)
    for name, st in stats.items():
        print(f"mode {name}: {st['seeds']} seeds, {st['identical']} identical to the oracle, "
              f"max score drift vs the oracle {st['drift']:.3e}, sparse template update on "
              f"{st['sparse_seeds']} seeds, launches "
              + ", ".join(f"{k} {st[k]}" for k in KERNELS), flush=True)
    total = counts()
    print("launches: " + ", ".join(f"{k} {total[k]}" for k in KERNELS), flush=True)
    n = args.n_seeds
    print(f"\n{n - len(failures)}/{n} seeds identical to the oracle across all modes")
    for seed, bad in failures:
        print(f"  FAIL seed={seed}: {bad}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
