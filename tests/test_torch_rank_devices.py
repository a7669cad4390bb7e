"""Ranks that hold several devices each, against the JAX package, on the CPU.

Each rank is a child process in a ``gloo`` group that holds ``["cpu",
"cpu"]`` (``parallel/mesh.initialize_distributed(devices=...)``): two
logical devices, as the JAX package's processes under
``jax.distributed`` keep their local devices.  A mesh over ranks × their
devices numbers its positions ``group_rank * k + j``, ``dp``-major; a
``dp`` slice lies inside one rank or covers whole ranks.  Every case of a
group runs in one launch of its children (each killed at its timeout);
the test process holds every rank's result against the port's numpy
oracle (masks, loops and converged bit for bit), the JAX package's
``sharded_clean`` over as many of the conftest's CPU devices (masks bit
for bit, scores within the unit-floored 5e-5 bound) and the port's
one-process batch (scores bit for bit).

Cases: ``sp=4`` over 2 ranks × 2 (the JAX package's
``TestGlobalMeshTwoProcess`` cube), ``dp=2 × sp=2`` on two seeds, uneven
blocks (``nsub=10`` over ``sp=4``), a rank left out of the mesh, whole
slices inside each rank in lockstep, the meshes that must raise, the
rank's devices as ``default_devices``, ``local_mesh`` and the daemon's
mesh, and the directory split with ``--sharded_batch``.
"""

from __future__ import annotations

import functools
import json
import os

import numpy as np
import pytest
import torch

from iterative_cleaner_tpu.config import CleanConfig as JaxConfig
from iterative_cleaner_tpu.io.synthetic import make_archive as jax_make_archive
from iterative_cleaner_tpu.ops.preprocess import preprocess as jax_preprocess
from iterative_cleaner_tpu.parallel.mesh import make_mesh as jax_make_mesh
from iterative_cleaner_tpu.parallel.sharded import sharded_clean as jax_sharded_clean
from iterative_cleaner_tpu_torch import cli
from iterative_cleaner_tpu_torch.analysis import contracts
from iterative_cleaner_tpu_torch.config import CleanConfig
from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
from iterative_cleaner_tpu_torch.io.npz import NpzIO
from iterative_cleaner_tpu_torch.io.synthetic import make_archive
from iterative_cleaner_tpu_torch.obs.audit import AUDIT_DRIFT_BOUND
from iterative_cleaner_tpu_torch.parallel import sharded
from iterative_cleaner_tpu_torch.parallel.mesh import (
    Mesh,
    initialize_distributed,
    make_mesh,
    rank_cards,
)
from test_torch_ranks import run_ranks

NCHAN, NBIN = 16, 64
#: Seconds a group's children may take; their collectives time out sooner.
GROUP_TIMEOUT_S = 60
RANK_TIMEOUT_S = 120

#: A rank holding two logical CPU devices: runs every case its argument
#: lists and saves what it got (rank<r>.npz, rank<r>.json).
RANK_SCRIPT = r"""
import json, os, sys
import numpy as np
from iterative_cleaner_tpu_torch.parallel.mesh import (
    initialize_distributed, make_mesh, rank_devices)
initialize_distributed(backend="gloo", devices=["cpu", "cpu"], timeout_s=float(sys.argv[1]))
import torch
import torch.distributed as dist
from iterative_cleaner_tpu_torch.config import CleanConfig
from iterative_cleaner_tpu_torch.io.synthetic import make_archive
from iterative_cleaner_tpu_torch.ops.preprocess import preprocess
from iterative_cleaner_tpu_torch.parallel import autoshard, collectives, sharded
from iterative_cleaner_tpu_torch.parallel.multihost import local_mesh
out_dir, cases = sys.argv[2], json.loads(sys.argv[3])
rank = int(os.environ["RANK"])
arrays, said = {}, {"rank_devices": [str(d) for d in rank_devices()]}

def cube(seed, nsub):
    return preprocess(make_archive(nsub=nsub, nchan=16, nbin=64, seed=seed), prefer_native=False)

for case in cases:
    tag = case["tag"]
    if case.get("single"):
        mesh = autoshard.single_archive_mesh((case["nsub"], 16, 64))
    else:
        mesh = make_mesh(case.get("n"), dp=case["dp"], sp=case["sp"], tp=1)
    said[tag] = {"positions": [list(p) for p in mesh.positions], "shape": mesh.shape,
                 "spans_ranks": mesh.spans_ranks, "sp_group": mesh.sp_group is not None}
    cubes = [cube(s, case["nsub"]) for s in case["seeds"]]
    for kernel in (False, True):
        key = f"{tag}_{'kernel' if kernel else 'plain'}"
        collectives.traffic.reset()
        t, w, loops, done = sharded.sharded_clean(
            [c[0] for c in cubes], [c[1] for c in cubes],
            CleanConfig(backend="torch", kernel=kernel, max_iter=case.get("max_iter", 5)), mesh)
        arrays.update({f"{key}_test": t, f"{key}_w": w, f"{key}_loops": loops,
                       f"{key}_done": done})
        tr = collectives.traffic
        said[key] = {"gathered": tr.gathered_bytes, "peer_copies": tr.peer_copies,
                     "staged": tr.staged_bytes}
    if case.get("trace"):
        # Rank 0 held to the route contract's ledger, as on the card.
        import contextlib
        from iterative_cleaner_tpu_torch.analysis import contracts
        collectives.traffic.reset()
        trace = contracts.Trace("cpu") if rank == 0 else contextlib.nullcontext()
        max_iter = case.get("max_iter", 5)
        with trace:
            out = sharded.sharded_clean([c[0] for c in cubes], [c[1] for c in cubes],
                                        CleanConfig(backend="torch", max_iter=max_iter), mesh)
        if rank == 0:
            dp = mesh.shape["dp"]
            iters = max(int(out[2][j]) if out[3][j] else max_iter
                        for i, _ in mesh.positions for j in range(i, len(cubes), dp))
            units = {"run": 1, "continuing iteration": min(iters, max_iter - 1),
                     "archive block": sum(len(range(i, len(cubes), dp))
                                          for i, _ in mesh.positions),
                     "staged read": collectives.traffic.staged_reads,
                     "staged upload": collectives.traffic.staged_uploads}
            said[tag]["contract"] = {
                "reads": len(trace.reads), "uploads": len(trace.uploads),
                "f64": sorted(trace.f64), "units": units,
                "want": contracts.expected_counts(
                    contracts.ROUTE_HOST_READS["rank_devices"]["sharded_clean"], units)}
    if case.get("history"):
        out = sharded.sharded_clean([c[0] for c in cubes], [c[1] for c in cubes],
                                    CleanConfig(backend="torch"), mesh, want_history=True)
        said[tag]["history"] = [out[4] is None, out[5] is None]

errors = {}
def refused(name, fn):
    try:
        fn()
        errors[name] = None
    except (ValueError, NotImplementedError) as exc:
        errors[name] = f"{type(exc).__name__}: {exc}"
if "refusals" in sys.argv[4:]:
    refused("split", lambda: make_mesh(3, dp=1, sp=3, tp=1))
    refused("tp", lambda: make_mesh(4, dp=1, sp=2, tp=2))
    refused("unequal", lambda: make_mesh(group=dist.group.WORLD, devices=["cpu"] * (2 - rank)))
said["errors"] = errors
if "local" in sys.argv[4:]:
    said["default_cpu"] = [str(d) for d in autoshard.default_devices("cpu")]
    said["default_cuda"] = [str(d) for d in autoshard.default_devices("cuda")]
    lm = local_mesh("cpu")
    said["local_mesh"] = {"devices": [str(d) for d in lm.devices], "shape": lm.shape,
                          "spans_ranks": lm.spans_ranks}
    from iterative_cleaner_tpu_torch.service import CleaningService, ServeConfig
    svc = CleaningService(ServeConfig(
        spool_dir=os.path.join(out_dir, f"spool{rank}"), port=0, deadline_s=0.2, quiet=True,
        device="cpu", clean=CleanConfig(backend="torch", max_iter=3, quiet=True, no_log=True)))
    svc.start()
    try:
        said["daemon"] = {"dp": svc.mesh.shape["dp"], "bucket_cap": svc.bucket_cap,
                          "devices": len(svc.mesh.devices)}
    finally:
        svc.stop()
if "cli" in sys.argv[4:]:
    from iterative_cleaner_tpu_torch import cli
    from iterative_cleaner_tpu_torch.parallel import batch
    from iterative_cleaner_tpu_torch.parallel.multihost import partition_paths
    paths = json.loads(open(os.path.join(out_dir, "paths.json")).read())
    meshes, real = [], batch.clean_directory_batch
    def spy(paths, cfg, mesh=None):
        meshes.append(mesh.shape)
        return real(paths, cfg, mesh=mesh)
    batch.clean_directory_batch = spy
    os.chdir(os.path.join(out_dir, "cli"))
    said["cli"] = {"rc": cli.main(["--device", "cpu", "-q", "--sharded_batch", "--report",
                                   "r.json", *paths]),
                   "slice": partition_paths(paths), "meshes": meshes}
np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
    json.dump(said, fh)
dist.destroy_process_group()
"""

#: Two ranks × two devices: sp=4 (the JAX package's two-process global
#: mesh cube, max_iter 4), dp=2 x sp=2 on seeds 5 and 0 (3 and 2 loops:
#: each slice stops alone), nsub 10 over sp=4 (blocks 3, 3, 2, 2: rank
#: spans of 6 and 4 subints), and single_archive_mesh over the 4 positions.
TWO_RANKS = [
    dict(tag="sp4", dp=1, sp=4, nsub=8, seeds=[99], max_iter=4, history=True, trace=True),
    dict(tag="dp2_sp2", dp=2, sp=2, nsub=8, seeds=[5, 0]),
    dict(tag="uneven", dp=1, sp=4, nsub=10, seeds=[99]),
    dict(tag="single", single=True, dp=1, sp=4, nsub=8, seeds=[99]),
]
#: Three ranks × two devices: sp=4 over ranks 0 and 1 with rank 2 left
#: out; dp=3 x sp=2 (a whole slice on each rank); dp=6 x sp=1 over 3
#: archives (two slices on a rank in lockstep, rank 1's second and rank
#: 2's both empty); single_archive_mesh (nsub 8 over 6 positions: sp=2,
#: inside rank 0).
THREE_RANKS = [
    dict(tag="left_out", n=4, dp=1, sp=4, nsub=8, seeds=[99]),
    dict(tag="dp3_sp2", dp=3, sp=2, nsub=8, seeds=[99, 5, 0]),
    dict(tag="dp6_sp1", dp=6, sp=1, nsub=8, seeds=[99, 5, 0]),
    dict(tag="single3", single=True, dp=1, sp=2, nsub=8, seeds=[99]),
]


@functools.lru_cache(maxsize=None)
def _cube(seed, nsub):
    D, w0 = jax_preprocess(jax_make_archive(nsub=nsub, nchan=NCHAN, nbin=NBIN, seed=seed),
                           prefer_native=False)
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


def _launch(out_dir, n, cases, *extra) -> list[tuple[dict, dict]]:
    run_ranks(RANK_SCRIPT, n, out_dir, (GROUP_TIMEOUT_S, out_dir, json.dumps(cases), *extra),
              timeout=RANK_TIMEOUT_S)
    got = []
    for rank in range(n):
        with np.load(out_dir / f"rank{rank}.npz") as z:
            arrays = {k: z[k] for k in z.files}
        got.append((arrays, json.loads((out_dir / f"rank{rank}.json").read_text())))
    return got


def _cli_paths(tmp_path) -> list[str]:
    paths = []
    for seed in (150, 151, 152):
        p = str(tmp_path / f"rd{seed}.npz")
        NpzIO().save(make_archive(nsub=4, nchan=NCHAN, nbin=NBIN, seed=seed), p)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("two_ranks")
    (out / "cli").mkdir()
    paths = _cli_paths(out / "cli")
    (out / "paths.json").write_text(json.dumps(paths))
    return out, paths, _launch(out, 2, TWO_RANKS, "refusals", "local", "cli")


@pytest.fixture(scope="module")
def three_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("three_ranks")
    return _launch(out, 3, THREE_RANKS)


@functools.lru_cache(maxsize=None)
def _jax(seeds, nsub, n, dp, sp, max_iter):
    import jax

    mesh = jax_make_mesh(n, dp=dp, sp=sp, tp=1, devices=jax.devices("cpu"))
    return tuple(np.asarray(x) for x in jax_sharded_clean(
        np.stack([_cube(s, nsub)[0] for s in seeds]),
        np.stack([_cube(s, nsub)[1] for s in seeds]),
        JaxConfig(backend="jax", max_iter=max_iter), mesh))


def _hold(results, case, jax_extents):
    """Every rank's results of ``case``: the same on every rank; against
    the port's one-process batch (bit for bit), the oracle and the JAX
    package's sharded_clean over ``jax_extents`` (n, dp, sp)."""
    seeds, nsub, max_iter = tuple(case["seeds"]), case["nsub"], case.get("max_iter", 5)
    Db = [_cube(s, nsub)[0] for s in seeds]
    wb = [_cube(s, nsub)[1] for s in seeds]
    jt, jw, jl, jd = _jax(seeds, nsub, *jax_extents, max_iter)
    for kernel in (False, True):
        key = f"{case['tag']}_{'kernel' if kernel else 'plain'}"
        cfg = CleanConfig(backend="torch", kernel=kernel, max_iter=max_iter)
        one = sharded.sharded_clean(Db, wb, cfg, make_mesh(devices=["cpu"]))
        for rank, (arrays, said) in enumerate(results):
            t, w, loops, done = (arrays[f"{key}_{k}"] for k in ("test", "w", "loops", "done"))
            where = f"rank {rank} ({key})"
            assert np.array_equal(t.view(np.int32), one[0].view(np.int32)), where
            assert np.array_equal(w, one[1]), where
            assert np.array_equal(loops, one[2]) and np.array_equal(done, one[3]), where
            for j, (D, w0) in enumerate(zip(Db, wb)):
                ora = clean_cube(D, w0, CleanConfig(backend="numpy", max_iter=max_iter))
                assert np.array_equal(w[j], ora.weights), f"{where} archive {j} != oracle"
                assert (int(loops[j]), bool(done[j])) == (ora.loops, ora.converged), where
            assert np.array_equal(w, jw), f"{where}: mask != JAX"
            assert np.array_equal(loops, jl) and np.array_equal(done, jd), where
            assert _drift(t, jt) <= AUDIT_DRIFT_BOUND, where
            # Logical CPU devices: no copy between them, nothing staged
            # through the host (gloo takes CPU tensors as they are).
            assert said[key]["peer_copies"] == 0 and said[key]["staged"] == 0, where
            assert said[key]["gathered"] > 0, where


def _case(cases, tag):
    return next(c for c in cases if c["tag"] == tag)


class TestTwoRanksTwoDevices:
    def test_sp4_over_two_ranks_of_two(self, two_ranks):
        _out, _paths, results = two_ranks
        assert [r[1]["sp4"]["positions"] for r in results] == [[[0, 0], [0, 1]],
                                                                [[0, 2], [0, 3]]]
        assert all(r[1]["sp4"]["sp_group"] for r in results)
        assert all(r[1]["sp4"]["history"] == [True, True] for r in results)
        _hold(results, _case(TWO_RANKS, "sp4"), (4, 1, 4))

    def test_rank_0_holds_the_route_contract(self, two_ranks):
        _out, _paths, results = two_ranks
        c = results[0][1]["sp4"]["contract"]
        assert c["units"]["archive block"] == 2 and c["units"]["continuing iteration"] > 0
        assert (c["reads"], c["uploads"]) == (c["want"]["read"], c["want"]["upload"]), c
        assert c["f64"] == []

    def test_dp2_sp2_each_rank_one_slice(self, two_ranks):
        _out, _paths, results = two_ranks
        assert [r[1]["dp2_sp2"]["positions"] for r in results] == [[[0, 0], [0, 1]],
                                                                    [[1, 0], [1, 1]]]
        # Each slice lies inside its rank: no sp group, nothing crosses ranks
        # until the results meet.
        assert not any(r[1]["dp2_sp2"]["sp_group"] for r in results)
        assert list(results[0][0]["dp2_sp2_plain_loops"]) == [3, 2]
        _hold(results, _case(TWO_RANKS, "dp2_sp2"), (4, 2, 2))

    def test_uneven_blocks_and_spans(self, two_ranks):
        _out, _paths, results = two_ranks
        _hold(results, _case(TWO_RANKS, "uneven"), (2, 1, 2))

    def test_single_archive_mesh_takes_every_position(self, two_ranks):
        _out, _paths, results = two_ranks
        assert [r[1]["single"]["shape"]["sp"] for r in results] == [4, 4]
        assert all(r[1]["single"]["spans_ranks"] for r in results)
        _hold(results, _case(TWO_RANKS, "single"), (4, 1, 4))

    def test_invalid_meshes_raise_on_every_rank(self, two_ranks):
        _out, _paths, results = two_ranks
        for _arrays, said in results:
            errors = said["errors"]
            assert errors["split"].startswith("ValueError") and "k % sp == 0" in errors["split"]
            assert errors["tp"].startswith("NotImplementedError")
            assert "channel sharding" in errors["tp"]
            assert errors["unequal"].startswith("ValueError")
            assert "[2, 1] devices" in errors["unequal"]

    def test_default_devices_local_mesh_and_daemon_are_the_ranks(self, two_ranks):
        _out, _paths, results = two_ranks
        for _arrays, said in results:
            assert said["rank_devices"] == ["cpu", "cpu"]
            assert said["default_cpu"] == said["default_cuda"] == ["cpu", "cpu"]
            assert said["local_mesh"] == {"devices": ["cpu", "cpu"], "spans_ranks": False,
                                          "shape": {"dp": 2, "sp": 1, "tp": 1}}
            assert said["daemon"] == {"dp": 2, "bucket_cap": 2, "devices": 2}

    def test_directory_split_with_sharded_batch(self, two_ranks, tmp_path):
        out, paths, results = two_ranks
        slices = [said["cli"]["slice"] for _a, said in results]
        assert slices == [[paths[0], paths[2]], [paths[1]]]
        for rank, (_arrays, said) in enumerate(results):
            assert said["cli"]["rc"] == 0
            # Each rank batches its paths over its own two devices.
            assert said["cli"]["meshes"] == [{"dp": 2, "sp": 1, "tp": 1}]
            rep = json.loads((out / "cli" / f"r.json.p{rank}").read_text())
            assert [r["path"] for r in rep] == slices[rank]
            assert all(r["error"] is None for r in rep)
        assert not (out / "cli" / "r.json").exists()
        # The same archives through one process's batch: the same weights.
        solo = []
        for p in paths:
            q = tmp_path / os.path.basename(p)
            q.write_bytes(open(p, "rb").read())
            solo.append(str(q))
        assert cli.main(["--device", "cpu", "-q", "-l", "--sharded_batch", *solo]) == 0
        for p, s in zip(paths, solo):
            got = NpzIO().load(p + "_cleaned.npz").weights
            assert np.array_equal(got, NpzIO().load(s + "_cleaned.npz").weights), p


class TestThreeRanksTwoDevices:
    def test_a_rank_left_out_receives_the_result(self, three_ranks):
        assert [r[1]["left_out"]["positions"] for r in three_ranks] == [
            [[0, 0], [0, 1]], [[0, 2], [0, 3]], []]
        _hold(three_ranks, _case(THREE_RANKS, "left_out"), (4, 1, 4))

    def test_a_whole_slice_on_each_rank(self, three_ranks):
        assert [r[1]["dp3_sp2"]["positions"] for r in three_ranks] == [
            [[0, 0], [0, 1]], [[1, 0], [1, 1]], [[2, 0], [2, 1]]]
        _hold(three_ranks, _case(THREE_RANKS, "dp3_sp2"), (6, 3, 2))

    def test_two_slices_of_a_rank_in_lockstep(self, three_ranks):
        assert [r[1]["dp6_sp1"]["positions"] for r in three_ranks] == [
            [[0, 0], [1, 0]], [[2, 0], [3, 0]], [[4, 0], [5, 0]]]
        _hold(three_ranks, _case(THREE_RANKS, "dp6_sp1"), (3, 3, 1))

    def test_single_archive_mesh_stays_inside_rank_0(self, three_ranks):
        # nsub 8 over 6 positions peels sp=2 (as the JAX package does): the
        # slice lies inside rank 0, and ranks 1 and 2 receive the result.
        assert [r[1]["single3"]["positions"] for r in three_ranks] == [
            [[0, 0], [0, 1]], [], []]
        assert not any(r[1]["single3"]["sp_group"] for r in three_ranks)
        _hold(three_ranks, _case(THREE_RANKS, "single3"), (2, 1, 2))


class TestRankCards:
    @pytest.mark.parametrize("local_rank, local_world, n_cards, want", [
        (0, None, 0, [0]),          # no LOCAL_WORLD_SIZE: card LOCAL_RANK
        (3, None, 8, [3]),
        (1, 4, 4, [1]),             # as many cards as ranks: one each
        (0, 2, 4, [0, 1]),
        (1, 2, 4, [2, 3]),
        (1, 3, 8, [2, 3]),          # 8 // 3 = 2 each, cards 6 and 7 unused
        (0, 2, 1, []),              # fewer cards than ranks
        (0, 1, 8, list(range(8))),
    ])
    def test_default_block(self, local_rank, local_world, n_cards, want):
        assert rank_cards(local_rank, local_world, n_cards) == want

    @pytest.mark.parametrize("local_rank, local_world", [(2, 2), (-1, 2)])
    def test_local_rank_out_of_range(self, local_rank, local_world):
        with pytest.raises(ValueError, match="LOCAL_RANK"):
            rank_cards(local_rank, local_world, 4)


class TestInitializeRefusals:
    ENV = {"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1",
           "LOCAL_RANK": "0"}

    @pytest.mark.parametrize("kw, env, err, match", [
        ({"device": "cpu", "devices": ["cpu"]}, {}, ValueError, "not both"),
        ({"devices": []}, {}, ValueError, "one or more devices"),
        ({"devices": ["cpu", "cuda:0"]}, {}, ValueError, "of one type"),
        ({"devices": ["cuda:0", "cuda:0"]}, {}, RuntimeError, "does not exist"),
        ({}, {"LOCAL_WORLD_SIZE": "2"}, RuntimeError, "does not exist"),
        ({}, {"LOCAL_WORLD_SIZE": "2", "LOCAL_RANK": "2"}, ValueError, "LOCAL_RANK"),
    ])
    def test_refuses_without_falling_back(self, monkeypatch, kw, env, err, match):
        for k, v in {**self.ENV, **env}.items():
            monkeypatch.setenv(k, v)
        with pytest.raises(err, match=match):
            initialize_distributed(**kw)
        assert not torch.distributed.is_initialized()


def _rank_mesh(dp, sp, k, n_ranks, me):
    """A mesh over ranks as ``make_mesh`` gives rank ``me``, built without
    a group (``group=object()``): the positions of its ``k`` devices."""
    n = dp * sp
    positions = tuple((p // sp, p % sp) for p in range(me * k, min((me + 1) * k, n)))
    return Mesh(devices=(torch.device("cpu"),) * k, shape={"dp": dp, "sp": sp, "tp": 1},
                group=object(), backend="gloo", group_ranks=tuple(range(n_ranks)),
                coords=positions[0] if positions else None, positions=positions)


class TestRankMeshLayout:
    @pytest.mark.parametrize("dp, sp, k, n_ranks, ranks, slices", [
        (1, 4, 2, 2, (0, 1), [(0, 1)]),
        (2, 2, 2, 2, (0, 1), [(0,), (1,)]),
        (1, 8, 2, 4, (0, 1, 2, 3), [(0, 1, 2, 3)]),
        (2, 4, 2, 4, (0, 1, 2, 3), [(0, 1), (2, 3)]),
        (6, 1, 2, 3, (0, 1, 2), [(0,), (0,), (1,), (1,), (2,), (2,)]),
        (1, 2, 2, 3, (0,), [(0,)]),
        (1, 2, 1, 3, (0, 1), [(0, 1)]),     # one device a rank, as before
    ])
    def test_ranks_and_slices(self, dp, sp, k, n_ranks, ranks, slices):
        mesh = _rank_mesh(dp, sp, k, n_ranks, 0)
        assert mesh.ranks == ranks
        assert [mesh.sp_ranks(i) for i in range(dp)] == slices

    def test_coords_alone_give_one_position(self):
        mesh = Mesh(devices=(torch.device("cpu"),), shape={"dp": 1, "sp": 2, "tp": 1},
                    group=object(), group_ranks=(0, 1), coords=(0, 1))
        assert mesh.positions == ((0, 1),)

    @pytest.mark.parametrize("dp, sp, me, archives, blocks", [
        # nsub 10 over sp=4: blocks (0, 3), (3, 6), (6, 8), (8, 10).
        (1, 4, 1, [0, 1, 2], [(6, 8), (8, 10)]),
        (1, 4, 0, [0, 1, 2], [(0, 3), (3, 6)]),
        # dp=2 x sp=2: rank 1 holds slice 1 (archive 1) whole.
        (2, 2, 1, [1], [(0, 5), (5, 10)]),
    ])
    def test_a_rank_uploads_its_blocks_only(self, tmp_path, dp, sp, me, archives, blocks):
        cubes, weights = [], []
        for seed in (99, 5, 0):
            D, w0 = _cube(seed, 10)
            np.save(tmp_path / f"D{seed}.npy", D)
            cubes.append(np.load(tmp_path / f"D{seed}.npy", mmap_mode="r"))
            weights.append(w0)
        Ds, ws = sharded.shard_batch(cubes, weights, _rank_mesh(dp, sp, 2, 2, me))
        assert len(Ds) == len(ws) == len(blocks)
        for D, w, (lo, hi) in zip(Ds, ws, blocks):
            assert tuple(D.shape) == (len(archives), hi - lo, NCHAN, NBIN)
            for j, src in enumerate(archives):
                assert np.array_equal(D[j].numpy(), cubes[src][lo:hi])
                assert np.array_equal(w[j].numpy(), weights[src][lo:hi])

    def test_a_rank_outside_the_mesh_uploads_nothing(self):
        mesh = _rank_mesh(1, 2, 2, 3, 2)
        assert mesh.positions == () and mesh.coords is None
        assert sharded.shard_batch([_cube(99, 8)[0]], [_cube(99, 8)[1]], mesh) == (None, None)


class TestRouteContract:
    def test_rank_devices_route_holds_its_ledger(self):
        # One rank of a gloo group made for the run, holding the CPU twice:
        # one sp=2 slice inside the rank.
        runs, failures = contracts.run_routes("cpu", routes={"rank_devices"})
        assert failures == [] and len(runs) == 2
        for run in runs:
            assert run.units["archive block"] == 2 and run.units["continuing iteration"] > 0
            assert contracts.check_run(run) == [], run.name
            assert len(run.trace.uploads) == 4
