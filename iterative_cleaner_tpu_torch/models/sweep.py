"""Threshold sweeps: the whole tuning grid in one device dispatch.

Port of ``iterative_cleaner_tpu/models/sweep.py``.  Users tune
``-c/--chanthresh`` and ``-s/--subintthresh`` by rerunning the whole clean
per setting.  Here the thresholds are per-archive tensors of the batched
device loop (``ops/stats.true_divide``), so a sweep is
:func:`..parallel.sharded.batched_fused_clean` over a pair axis: the one
cube broadcast to every pair without a copy (``expand``), one upload, every
pair's convergence loop running batched on the card.  As in the JAX package
(which vmaps its fused loop with ``use_pallas`` left False) the sweep runs
the plain route with a dense template every iteration; a stopped pair stays
frozen; one host read per iteration.  It sweeps in the compute type
(float64 under ``--x64``, as ``iterative_cleaner_tpu/models/sweep.py:68-69``
does), so each pair predicts the solo clean it guides.

The per-pair outputs (final mask, rfi_frac, loops, converged) are exactly
what a scientist scans to pick thresholds; ``--sweep`` prints the table and
saves all masks for offline comparison.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np
import torch

from iterative_cleaner_tpu_torch.config import CleanConfig
from iterative_cleaner_tpu_torch.obs import tracing

# Chunking decisions already announced on stderr (once per distinct one).
_announced_chunkings: set = set()


@dataclass
class SweepPoint:
    chanthresh: float
    subintthresh: float
    rfi_frac: float
    loops: int
    converged: bool
    weights: np.ndarray | None = None  # final mask for this pair


def sweep_thresholds(
    D: np.ndarray,
    w0: np.ndarray,
    cfg: CleanConfig,
    pairs: list[tuple[float, float]],
    device="cuda",
) -> list[SweepPoint]:
    """Clean one preprocessed cube under every (chanthresh, subintthresh)
    pair on ``device`` (default the card; raises when there is none) — one
    batched dispatch, or several when the grid does not fit the device.
    Each pair runs the full convergence loop with the same semantics as a
    solo clean with those thresholds."""
    if not pairs:
        return []
    if cfg.backend != "torch":
        raise ValueError("sweep_thresholds runs the batched device loop "
                         "and requires backend='torch'")
    if cfg.kernel:
        raise ValueError("sweep_thresholds does not support kernel=True "
                         "(the sweep runs the plain route, as the JAX "
                         "package's does); drop one")
    from iterative_cleaner_tpu_torch.backends.torch_backend import (
        compute_dtype,
        device_for,
        upload,
    )
    from iterative_cleaner_tpu_torch.parallel.autoshard import (
        HBM_USABLE_FRACTION,
        batch_working_set_bytes,
        device_memory_bytes,
        itemsize_of,
    )
    from iterative_cleaner_tpu_torch.parallel.sharded import batched_fused_clean

    dev = device_for(device)
    dtype = compute_dtype(cfg)
    dtype_name = str(dtype).removeprefix("torch.")
    # The batch's cube-sized intermediates are per pair, so peak device
    # memory is ~n_pairs x one pair's working set: chunk the grid to what
    # the device holds.  Sized on host shapes before any upload: a cube too
    # big for even one pair reroutes through solo cleans instead.
    shape = tuple(np.shape(D))
    chunk = len(pairs)
    hbm = device_memory_bytes(dev)
    if hbm is not None:
        # Counts the cube once per pair, though the pairs share it.
        per_pair = batch_working_set_bytes(shape, cfg, False, 1, itemsize_of(cfg))
        budget = int(hbm * HBM_USABLE_FRACTION)
        if per_pair > budget:
            # Each pair is exactly a solo clean with its thresholds, and
            # clean_cube's chunked route takes cubes beyond the card.
            key = (shape, dtype_name, "solo", len(pairs))
            if key not in _announced_chunkings:
                _announced_chunkings.add(key)
                print(
                    f"sweep: cube {shape} exceeds device memory even for a "
                    f"single pair; running {len(pairs)} pairs as solo "
                    "cleans through the >HBM sharded/chunked chain",
                    file=sys.stderr)
            return _sweep_via_solo_cleans(D, w0, cfg, pairs, device)
        chunk = max(1, min(chunk, budget // per_pair))
        key = (shape, dtype_name, chunk, len(pairs))
        if chunk < len(pairs) and key not in _announced_chunkings:
            _announced_chunkings.add(key)
            print(
                f"sweep: running {len(pairs)} pairs in chunks of {chunk} "
                "(full grid would exceed device memory)", file=sys.stderr)

    Dt, w0t = upload(dev, dtype, D, w0)
    valid = w0t != 0
    nsub, nchan = w0t.shape
    points: list[SweepPoint] = []
    for start in range(0, len(pairs), chunk):
        part = pairs[start:start + chunk]
        a = len(part)
        cts = torch.tensor([float(c) for c, _ in part], dtype=dtype, device=dev)
        sts = torch.tensor([float(s) for _, s in part], dtype=dtype, device=dev)
        with tracing.phase("clean_loop"):
            _test, w_final, loops, done, _x, _r, _hist = batched_fused_clean(
                Dt.expand(a, *Dt.shape), w0t.expand(a, nsub, nchan),
                valid.expand(a, nsub, nchan), cts, sts,
                max_iter=int(cfg.max_iter), pulse_region=tuple(cfg.pulse_region),
                use_kernel=False)
            del _test, _hist
            # One fetch: loops and done are small integers, exact in the type.
            packed = torch.cat((w_final.reshape(-1), loops.to(w_final.dtype),
                                done.to(w_final.dtype))).cpu().numpy()
        with tracing.phase("clean_finalize"):
            n = a * nsub * nchan
            masks = packed[:n].reshape(a, nsub, nchan)
            points.extend(
                SweepPoint(
                    chanthresh=float(c),
                    subintthresh=float(s),
                    rfi_frac=float((masks[k] == 0).mean()),
                    loops=int(packed[n + k]),
                    converged=bool(packed[n + a + k]),
                    weights=masks[k].copy(),
                )
                for k, (c, s) in enumerate(part)
            )
    return points


def _sweep_via_solo_cleans(
    D: np.ndarray,
    w0: np.ndarray,
    cfg: CleanConfig,
    pairs: list[tuple[float, float]],
    device="cuda",
) -> list[SweepPoint]:
    """Beyond the card: one solo clean per pair through ``clean_cube``,
    which routes an oversized cube through the chunked cleaner.  The same
    points as the batched loop (a sweep pair is a solo clean with those
    thresholds); only the dispatch shape differs."""
    from iterative_cleaner_tpu_torch.core.cleaner import clean_cube

    points: list[SweepPoint] = []
    for c, s in pairs:
        res = clean_cube(
            D, w0, cfg.replace(chanthresh=float(c), subintthresh=float(s)),
            device=device)
        points.append(
            SweepPoint(
                chanthresh=float(c),
                subintthresh=float(s),
                rfi_frac=float((res.weights == 0).mean()),
                loops=res.loops,
                converged=res.converged,
                weights=res.weights,
            ))
    return points


def grid(chanthreshs, subintthreshs) -> list[tuple[float, float]]:
    """Full Cartesian grid, channel-major (the order the table prints in)."""
    return [(float(c), float(s)) for c in chanthreshs for s in subintthreshs]


def format_table(points: list[SweepPoint]) -> str:
    lines = ["chanthresh  subintthresh  rfi_frac  loops  converged"]
    for p in points:
        lines.append(
            f"{p.chanthresh:10.3g}  {p.subintthresh:12.3g}  "
            f"{p.rfi_frac:8.4f}  {p.loops:5d}  {str(p.converged):>9s}")
    return "\n".join(lines)


def save_sweep(points: list[SweepPoint], path: str) -> None:
    """All sweep masks and metrics in one NPZ (masks stacked in pair order),
    with the JAX package's keys and dtypes."""
    payload = dict(
        chanthresh=np.array([p.chanthresh for p in points], np.float32),
        subintthresh=np.array([p.subintthresh for p in points], np.float32),
        rfi_frac=np.array([p.rfi_frac for p in points], np.float32),
        loops=np.array([p.loops for p in points], np.int32),
        converged=np.array([p.converged for p in points], bool),
    )
    if points and points[0].weights is not None:
        payload["weights"] = np.stack([p.weights for p in points])
    np.savez_compressed(path, **payload)
