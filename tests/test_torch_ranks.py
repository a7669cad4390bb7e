"""The port's rank-sharded clean against the JAX package, on the CPU.

Ranks are child processes in a ``gloo`` group on ``cpu``
(``parallel/mesh.initialize_distributed``), each given a timeout.  Every
rank calls ``parallel/sharded.sharded_clean`` with the same seeded batch
and saves what it got back; the test process holds each rank's result
against the port's numpy oracle (masks, loops, converged bit for bit),
against the JAX package's ``sharded_clean`` over a mesh of the conftest's
CPU devices (masks bit for bit, scores within the unit-floored 5e-5 bound)
and against the port's one-process batch (scores bit for bit: a rank's
maps are per-profile reductions of its own subints, gathered, and the
template is continued along the ranks in the one-process order).  Also:
a ``dp=2 x sp=2`` batch, uneven ``sp`` blocks, a rank left out of a
partial mesh, no history across ranks, and a rank that dies failing its
peer instead of hanging it.
"""

from __future__ import annotations

import functools
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from iterative_cleaner_tpu.config import CleanConfig as JaxConfig
from iterative_cleaner_tpu.io.synthetic import make_archive as jax_make_archive
from iterative_cleaner_tpu.ops.preprocess import preprocess as jax_preprocess
from iterative_cleaner_tpu.parallel.mesh import make_mesh as jax_make_mesh
from iterative_cleaner_tpu.parallel.sharded import sharded_clean as jax_sharded_clean
from iterative_cleaner_tpu_torch.config import CleanConfig
from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
from iterative_cleaner_tpu_torch.obs.audit import AUDIT_DRIFT_BOUND
from iterative_cleaner_tpu_torch.parallel import sharded
from iterative_cleaner_tpu_torch.parallel.mesh import Mesh, make_mesh

REPO = Path(__file__).resolve().parents[1]
SHAPE = (8, 16, 64)


class StandInGroup:
    """Stands for a process group in a mesh whose collectives a test never
    runs (a mesh refers to its group weakly, so the stand-in lives here)."""


STAND_IN_GROUP = StandInGroup()
#: Seconds a child rank may take; its group's collectives time out sooner.
RANK_TIMEOUT_S = 120
GROUP_TIMEOUT_S = 60


def run_ranks(script: str, n: int, cwd, args=(), timeout: float = RANK_TIMEOUT_S,
              expect_ok: bool = True) -> list[tuple[int, str, str]]:
    """Run ``script`` (``python -c``) as ranks ``0..n-1`` of one group:
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and a free ``MASTER_PORT`` in
    each child's environment.  Every child is killed at ``timeout``
    seconds; returns each rank's (returncode, stdout, stderr), after
    asserting every returncode is 0 when ``expect_ok``."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(n):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, "-c", script, *map(str, args)],
                                      env=env, cwd=str(cwd), stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    got = [(p.returncode, out, err) for p, (out, err) in zip(procs, outs)]
    if expect_ok:
        for rank, (rc, out, err) in enumerate(got):
            assert rc == 0, f"rank {rank}: rc={rc}\n{out}\n{err}"
    return got


#: A rank: joins the group, cleans the seeded batch on the mesh its
#: arguments give (dp, sp, seeds, then optional extras) and saves what
#: sharded_clean returned, with the kernel route off and on.
RANK_SCRIPT = r"""
import os, sys
import numpy as np
from iterative_cleaner_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
dev = initialize_distributed(backend="gloo", device="cpu", timeout_s=float(sys.argv[1]))
from iterative_cleaner_tpu_torch.config import CleanConfig
from iterative_cleaner_tpu_torch.io.synthetic import make_archive
from iterative_cleaner_tpu_torch.ops.preprocess import preprocess
from iterative_cleaner_tpu_torch.parallel import autoshard, collectives, sharded
out_dir, dp, sp = sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
seeds = [int(s) for s in sys.argv[5].split(",")]
extra = sys.argv[6:]
rank = int(os.environ["RANK"])
cubes = [preprocess(make_archive(nsub=8, nchan=16, nbin=64, seed=s), prefer_native=False)
         for s in seeds]
Db, wb = [c[0] for c in cubes], [c[1] for c in cubes]
if "single_archive_mesh" in extra:
    assert autoshard.single_archive_mesh(Db[0].shape) is None   # 3 ranks, nsub 8
    mesh = autoshard.single_archive_mesh(Db[0].shape, dp * sp)
else:
    mesh = make_mesh(dp * sp, dp=dp, sp=sp, tp=1)
assert mesh.spans_ranks and mesh.device == dev
res = {"coords": np.array(mesh.coords if mesh.coords is not None else (-1, -1))}
for kernel in (False, True):
    collectives.traffic.reset()
    t, w, loops, done = sharded.sharded_clean(Db, wb, CleanConfig(backend="torch", kernel=kernel),
                                              mesh)
    tag = "kernel" if kernel else "plain"
    res.update({f"{tag}_test": t, f"{tag}_w": w, f"{tag}_loops": loops, f"{tag}_done": done,
                f"{tag}_gathered": collectives.traffic.gathered_bytes,
                f"{tag}_staged": collectives.traffic.staged_bytes})
if "history" in extra:
    out = sharded.sharded_clean(Db, wb, CleanConfig(backend="torch"), mesh, want_history=True)
    assert len(out) == 6 and out[4] is None and out[5] is None, out[4:]
    assert np.array_equal(out[1], res["plain_w"])
if "tp" in extra:
    try:
        make_mesh(dp * sp, dp=1, sp=1, tp=dp * sp)
    except NotImplementedError as exc:
        res["tp_error"] = np.array(str(exc))
np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
import torch.distributed as dist
dist.destroy_process_group()
"""


@functools.lru_cache(maxsize=None)
def _cube(seed):
    D, w0 = jax_preprocess(jax_make_archive(nsub=SHAPE[0], nchan=SHAPE[1], nbin=SHAPE[2],
                                            seed=seed), prefer_native=False)
    D.setflags(write=False)
    w0.setflags(write=False)
    return D, w0


def _drift(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
    fin = np.isfinite(a)
    if not fin.any():
        return 0.0
    return float(np.max(np.abs(a[fin] - b[fin]) / np.maximum(np.abs(b[fin]), 1.0)))


def _ranks(tmp_path, n, dp, sp, seeds, *extra) -> list[dict]:
    run_ranks(RANK_SCRIPT, n, tmp_path,
              (GROUP_TIMEOUT_S, tmp_path, dp, sp, ",".join(map(str, seeds)), *extra))
    out = []
    for rank in range(n):
        with np.load(tmp_path / f"rank{rank}.npz") as z:
            out.append({k: z[k] for k in z.files})
    return out


def _hold(results, seeds, jax_mesh_kw):
    """Every rank's results: the same on every rank; against the port's
    oracle, the JAX package's sharded_clean and the port's one-process
    batch."""
    Db = [_cube(s)[0] for s in seeds]
    wb = [_cube(s)[1] for s in seeds]
    jt, jw, jl, jd = jax_sharded_clean(np.stack(Db), np.stack(wb), JaxConfig(backend="jax"),
                                       jax_make_mesh(**jax_mesh_kw))
    for kernel in (False, True):
        tag = "kernel" if kernel else "plain"
        cfg = CleanConfig(backend="torch", kernel=kernel)
        one = sharded.sharded_clean(Db, wb, cfg, make_mesh(devices=["cpu"]))
        for rank, res in enumerate(results):
            t, w, loops, done = (res[f"{tag}_{k}"] for k in ("test", "w", "loops", "done"))
            where = f"rank {rank} ({tag})"
            assert np.array_equal(t, results[0][f"{tag}_test"], equal_nan=True), where
            # Bit for bit the one-process batch: the scores and the mask.
            assert np.array_equal(t.view(np.int32), one[0].view(np.int32)), where
            assert np.array_equal(w, one[1]), where
            assert np.array_equal(loops, one[2]) and np.array_equal(done, one[3]), where
            for j, (D, w0) in enumerate(zip(Db, wb)):
                ora = clean_cube(D, w0, CleanConfig(backend="numpy"))
                assert np.array_equal(w[j], ora.weights), f"{where} archive {j} != oracle"
                assert (int(loops[j]), bool(done[j])) == (ora.loops, ora.converged), where
            assert np.array_equal(w, np.asarray(jw)), f"{where}: mask != JAX"
            assert np.array_equal(loops, np.asarray(jl)) and np.array_equal(done, np.asarray(jd))
            assert _drift(t, np.asarray(jt)) <= AUDIT_DRIFT_BOUND, where
            # CPU tensors: gloo takes them as they are, nothing is staged.
            assert res[f"{tag}_staged"] == 0 and res[f"{tag}_gathered"] > 0, where


class TestRankShardedClean:
    def test_two_ranks_sp2(self, tmp_path, cpu_devices):
        results = _ranks(tmp_path, 2, 1, 2, [99], "history", "tp")
        assert [tuple(r["coords"]) for r in results] == [(0, 0), (0, 1)]
        _hold(results, [99], dict(n_devices=2, dp=1, sp=2, tp=1, devices=cpu_devices))
        for res in results:
            assert "channel sharding" in str(res["tp_error"])

    def test_four_ranks_dp2_sp2(self, tmp_path, cpu_devices):
        # Seeds 5 and 0 stop after 3 and 2 loops: each dp slice stops alone.
        results = _ranks(tmp_path, 4, 2, 2, [5, 0])
        assert [tuple(r["coords"]) for r in results] == [(0, 0), (0, 1), (1, 0), (1, 1)]
        assert list(results[0]["plain_loops"]) == [3, 2]
        _hold(results, [5, 0], dict(n_devices=4, dp=2, sp=2, tp=1, devices=cpu_devices))

    def test_three_ranks_uneven_blocks(self, tmp_path, cpu_devices):
        # nsub 8 over sp=3: blocks of 3, 3 and 2 subints.
        results = _ranks(tmp_path, 3, 1, 3, [99])
        _hold(results, [99], dict(n_devices=2, dp=1, sp=2, tp=1, devices=cpu_devices))

    def test_partial_mesh_leaves_a_rank_out(self, tmp_path, cpu_devices):
        # single_archive_mesh over 2 of 3 ranks; over all 3 it declines (3
        # does not divide nsub 8).  Rank 2 does no device work and gets the
        # whole result.
        results = _ranks(tmp_path, 3, 1, 2, [99], "single_archive_mesh", "history")
        assert [tuple(r["coords"]) for r in results] == [(0, 0), (0, 1), (-1, -1)]
        _hold(results, [99], dict(n_devices=2, dp=1, sp=2, tp=1, devices=cpu_devices))
        assert results[2]["plain_gathered"] > 0


#: A group whose rank 1 dies before the first collective.
DYING_SCRIPT = r"""
import os, sys
from iterative_cleaner_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
initialize_distributed(backend="gloo", device="cpu", timeout_s=float(sys.argv[1]))
mesh = make_mesh(dp=1, sp=2, tp=1)
if os.environ["RANK"] == "1":
    raise SystemExit("rank 1 fails before the clean")
from iterative_cleaner_tpu_torch.config import CleanConfig
from iterative_cleaner_tpu_torch.io.synthetic import make_archive
from iterative_cleaner_tpu_torch.ops.preprocess import preprocess
from iterative_cleaner_tpu_torch.parallel.sharded import sharded_clean_single
D, w0 = preprocess(make_archive(nsub=8, nchan=16, nbin=64, seed=99), prefer_native=False)
sharded_clean_single(D, w0, CleanConfig(backend="torch"), mesh)
print("rank 0 finished without its peer")
"""


def test_a_dead_rank_fails_its_peer(tmp_path):
    t0 = time.monotonic()
    got = run_ranks(DYING_SCRIPT, 2, tmp_path, (10,), expect_ok=False)
    assert [rc != 0 for rc, _, _ in got] == [True, True], got
    assert "finished without its peer" not in got[0][1]
    assert time.monotonic() - t0 < RANK_TIMEOUT_S


#: A rank that makes a mesh over two ranks (with an sp group), then either
#: destroys the group and reads what is left of it, or exits holding it.
#: The hook registered first runs last, after the port's.
TEARDOWN_SCRIPT = r"""
import atexit, sys, weakref
import torch.distributed as dist
atexit.register(lambda: print("initialized at exit:", dist.is_initialized(), flush=True))
from iterative_cleaner_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
initialize_distributed(backend="gloo", device="cpu", timeout_s=float(sys.argv[1]))
mesh = make_mesh(2, dp=1, sp=2, tp=1)
refs = [weakref.ref(mesh.group), weakref.ref(mesh.sp_group)]
if sys.argv[2] == "destroy":
    dist.destroy_process_group()
    print("groups alive:", [r() is not None for r in refs], flush=True)
    try:
        mesh.group
    except RuntimeError as exc:
        print("group read:", exc, flush=True)
"""


@pytest.mark.parametrize("end", ["destroy", "exit"])
def test_a_mesh_leaves_its_groups_to_torch_distributed(tmp_path, end):
    # A group that outlives destroy_process_group (or a process that never
    # calls it) is torn down while the interpreter exits, where gloo
    # aborts at random: rc -6, "terminate called without an active
    # exception".  The mesh must not keep its groups alive, and the group
    # must be gone before the interpreter's own teardown.
    got = run_ranks(TEARDOWN_SCRIPT, 2, tmp_path, (GROUP_TIMEOUT_S, end))
    for rank, (_rc, out, err) in enumerate(got):
        assert "terminate called" not in err, f"rank {rank}: {err}"
        assert out.splitlines()[-1] == "initialized at exit: False", f"rank {rank}: {out}"
        if end == "destroy":
            assert "groups alive: [False, False]" in out, f"rank {rank}: {out}"
            assert "process group was destroyed" in out, f"rank {rank}: {out}"


class TestShardBatch:
    @pytest.mark.parametrize("coords, archives, subints", [
        ((0, 0), [0, 2], (0, 3)), ((0, 2), [0, 2], (6, 8)), ((1, 1), [1], (3, 6))])
    def test_a_rank_uploads_its_slice_only(self, tmp_path, coords, archives, subints):
        # dp=2 x sp=3 over 3 archives of 8 subints, read from memory-mapped
        # .npy files as the ranks on one host read them.
        paths = []
        for seed in (99, 5, 0):
            D, w0 = _cube(seed)
            np.save(tmp_path / f"D{seed}.npy", D)
            paths.append((tmp_path / f"D{seed}.npy", w0))
        cubes = [np.load(p, mmap_mode="r") for p, _ in paths]
        mesh = Mesh(devices=(torch.device("cpu"),), shape={"dp": 2, "sp": 3, "tp": 1},
                    group=STAND_IN_GROUP, backend="gloo", group_ranks=tuple(range(6)),
                    coords=coords)
        Dt, wt = sharded.shard_batch(cubes, [w for _, w in paths], mesh)
        lo, hi = subints
        assert tuple(Dt.shape) == (len(archives), hi - lo, *SHAPE[1:])
        for j, src in enumerate(archives):
            assert np.array_equal(Dt[j].numpy(), cubes[src][lo:hi])
            assert np.array_equal(wt[j].numpy(), paths[src][1])

    def test_more_sp_ranks_than_subints_raise_on_every_rank(self):
        mesh = Mesh(devices=(torch.device("cpu"),), shape={"dp": 1, "sp": 9, "tp": 1},
                    group=STAND_IN_GROUP, backend="gloo", group_ranks=tuple(range(9)), coords=None)
        with pytest.raises(ValueError, match="would hold none"):
            sharded.shard_batch([_cube(99)[0]], [_cube(99)[1]], mesh)

    def test_a_rank_outside_the_mesh_uploads_nothing(self):
        mesh = Mesh(devices=(torch.device("cpu"),), shape={"dp": 1, "sp": 2, "tp": 1},
                    group=STAND_IN_GROUP, backend="gloo", group_ranks=(0, 1, 2), coords=None)
        assert sharded.shard_batch([_cube(99)[0]], [_cube(99)[1]], mesh) == (None, None)
