"""The port's mesh over one process's devices against the JAX package, on
the CPU.

Mirrors tests/test_autoshard.py and the in-process half of
tests/test_parallel.py.  The port's devices are ``["cpu"] * n``: logical
devices, as the conftest's ``--xla_force_host_platform_device_count=8``
gives the JAX package 8 CPU devices.  The same seeded cubes (numpy, through
``make_archive``) go through the port's ``sharded_clean`` on such a mesh
and its ``clean_cube`` reroute, and through the JAX package's
``sharded_clean`` over the conftest's CPU devices and its ``clean_cube``
under ``ICT_HBM_BYTES=1024``: masks, loops and converged bit for bit,
scores within the unit-floored 5e-5 bound (``AUDIT_DRIFT_BOUND``).  Against
the port's one-device batch the scores are bit for bit: each device's maps
are per-profile reductions of its own subints, gathered, and the template
is continued along the devices in the one-device order.  Also: the mesh's
default extents (8 devices give ``(4, 2, 1)``, on the ranks mesh too),
``should_shard``, ``single_archive_mesh``, the reroute's declines, the
histories, the directory batch, the driver and the daemon on the mesh, and
the route contract of the new route.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from iterative_cleaner_tpu.config import CleanConfig as JaxConfig
from iterative_cleaner_tpu.core.cleaner import clean_cube as jax_clean_cube
from iterative_cleaner_tpu.io.synthetic import make_archive as jax_make_archive
from iterative_cleaner_tpu.ops.preprocess import preprocess as jax_preprocess
from iterative_cleaner_tpu.parallel.autoshard import single_archive_mesh as jax_single_mesh
from iterative_cleaner_tpu.parallel.mesh import make_mesh as jax_make_mesh
from iterative_cleaner_tpu.parallel.sharded import sharded_clean as jax_sharded_clean
from iterative_cleaner_tpu_torch import driver
from iterative_cleaner_tpu_torch.analysis import contracts
from iterative_cleaner_tpu_torch.config import CleanConfig
from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
from iterative_cleaner_tpu_torch.io.npz import NpzIO
from iterative_cleaner_tpu_torch.io.synthetic import make_archive
from iterative_cleaner_tpu_torch.obs import memory as obs_memory
from iterative_cleaner_tpu_torch.obs.audit import AUDIT_DRIFT_BOUND
from iterative_cleaner_tpu_torch.ops.preprocess import preprocess
from iterative_cleaner_tpu_torch.parallel import autoshard, batch, collectives, sharded
from iterative_cleaner_tpu_torch.parallel.mesh import _extents, factor_mesh, make_mesh
from iterative_cleaner_tpu_torch.parallel.multihost import local_mesh
from iterative_cleaner_tpu_torch.service import CleaningService, ServeConfig

SHAPE = (8, 16, 64)


@functools.lru_cache(maxsize=None)
def _cube(seed, nsub=SHAPE[0]):
    D, w0 = jax_preprocess(jax_make_archive(nsub=nsub, nchan=SHAPE[1], nbin=SHAPE[2],
                                            seed=seed), prefer_native=False)
    D.setflags(write=False)
    w0.setflags(write=False)
    return D, w0


def _batch(seeds):
    return [_cube(s)[0] for s in seeds], [_cube(s)[1] for s in seeds]


def _cpus(n):
    return ["cpu"] * n


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _drift(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
    fin = np.isfinite(a)
    if not fin.any():
        return 0.0
    return float(np.max(np.abs(a[fin] - b[fin]) / np.maximum(np.abs(b[fin]), 1.0)))


@functools.lru_cache(maxsize=None)
def _one_device(seeds, kernel):
    Db, wb = _batch(seeds)
    return sharded.sharded_clean(Db, wb, CleanConfig(backend="torch", kernel=kernel),
                                 make_mesh(devices=["cpu"]), want_history=True)


@functools.lru_cache(maxsize=None)
def _jax_sharded(seeds, n, dp, sp):
    import jax

    Db, wb = _batch(seeds)
    mesh = jax_make_mesh(n, dp=dp, sp=sp, tp=1, devices=jax.devices("cpu"))
    return tuple(np.asarray(x) for x in jax_sharded_clean(
        np.stack(Db), np.stack(wb), JaxConfig(backend="jax"), mesh))


def _hold(got, seeds, kernel, jax_extents):
    """``got`` (sharded_clean's test, weights, loops, converged) against the
    port's one-device batch (bit for bit), the JAX package's sharded_clean
    (masks bit for bit, scores within the bound) and the oracle's masks."""
    t, w, loops, done = got[:4]
    one = _one_device(tuple(seeds), kernel)
    assert np.array_equal(_bits(t), _bits(one[0])), "scores != the one-device batch"
    assert np.array_equal(w, one[1])
    assert np.array_equal(loops, one[2]) and np.array_equal(done, one[3])
    jt, jw, jl, jd = _jax_sharded(tuple(seeds), *jax_extents)
    assert np.array_equal(w, jw), "mask != JAX"
    assert np.array_equal(loops, jl) and np.array_equal(done, jd)
    assert _drift(t, jt) <= AUDIT_DRIFT_BOUND
    for j, s in enumerate(seeds):
        ora = clean_cube(*_cube(s), CleanConfig(backend="numpy"))
        assert np.array_equal(w[j], ora.weights), f"archive {j} != oracle"
        assert (int(loops[j]), bool(done[j])) == (ora.loops, ora.converged)


class TestMesh:
    @pytest.mark.parametrize("n", range(1, 13))
    def test_default_extents_fold_tp_into_dp(self, n):
        dp, sp, tp = factor_mesh(n)
        mesh = make_mesh(devices=_cpus(n))
        assert mesh.shape == {"dp": dp * tp, "sp": sp, "tp": 1}
        assert not mesh.spans_ranks and mesh.is_local == (n > 1)
        assert len(mesh.devices) == n

    def test_eight_devices_give_4_2_1(self):
        assert make_mesh(devices=_cpus(8)).shape == {"dp": 4, "sp": 2, "tp": 1}

    def test_ranks_mesh_extents_over_eight_no_longer_raise(self):
        # factor_mesh(8) is (2, 2, 2), as in the JAX package: the ranks
        # mesh's default used to raise for its tp=2.
        assert factor_mesh(8) == (2, 2, 2)
        assert _extents(8, None, None, None) == (4, 2, 1)
        assert _extents(12, None, None, None) == (6, 2, 1)

    @pytest.mark.parametrize("kw", [dict(dp=4, sp=1, tp=2), dict(tp=8), dict(dp=1, sp=2, tp=4)])
    def test_explicit_tp_still_raises(self, kw):
        with pytest.raises(NotImplementedError, match="channel sharding"):
            make_mesh(8, devices=_cpus(8), **kw)
        with pytest.raises(NotImplementedError, match="channel sharding"):
            _extents(8, kw.get("dp"), kw.get("sp"), kw.get("tp"))

    def test_grid_is_dp_major(self):
        devs = [torch.device("cpu")] * 6
        mesh = make_mesh(devices=devs, dp=2, sp=3)
        assert [len(row) for row in mesh.grid] == [3, 3]
        assert mesh.device == torch.device("cpu")

    def test_first_n_devices_and_bad_counts(self):
        assert len(make_mesh(2, devices=_cpus(5)).devices) == 2
        with pytest.raises(ValueError, match="n_devices"):
            make_mesh(6, devices=_cpus(5))
        with pytest.raises(ValueError, match="dp\\*sp\\*tp"):
            make_mesh(devices=_cpus(4), dp=3, sp=1)

    def test_devices_of_one_type(self):
        with pytest.raises(ValueError, match="one type"):
            make_mesh(devices=["cpu", "meta"])

    def test_default_devices_need_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present; the default devices are valid here")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            autoshard.default_devices("cuda")

    def test_default_devices_by_name(self):
        assert autoshard.default_devices("cpu") == [torch.device("cpu")]
        # A named card is that card alone (no card is touched to say so).
        assert autoshard.default_devices("cuda:1") == [torch.device("cuda", 1)]


class TestShardedClean:
    """sharded_clean on in-process meshes of logical CPU devices."""

    @pytest.mark.parametrize("kernel", [False, True])
    @pytest.mark.parametrize("dp, sp, seeds", [
        (1, 2, (99,)),
        (1, 3, (99,)),            # nsub 8 over sp=3: blocks of 3, 3 and 2 subints
        (2, 2, (5, 0)),           # seeds 5 and 0 stop after 3 and 2 loops
        (2, 1, (5, 0, 9)),        # slices of 2 and 1 archives
        (2, 3, (0, 5, 9, 1)),
    ])
    def test_against_jax_and_the_one_device_batch(self, kernel, dp, sp, seeds):
        Db, wb = _batch(seeds)
        mesh = make_mesh(devices=_cpus(dp * sp), dp=dp, sp=sp)
        got = sharded.sharded_clean(Db, wb, CleanConfig(backend="torch", kernel=kernel), mesh)
        _hold(got, seeds, kernel, (dp * sp, dp, sp))

    def test_eight_devices_by_default(self):
        seeds = (0, 5, 9, 1)
        Db, wb = _batch(seeds)
        mesh = make_mesh(devices=_cpus(8))
        assert mesh.shape == {"dp": 4, "sp": 2, "tp": 1}
        got = sharded.sharded_clean(Db, wb, CleanConfig(backend="torch"), mesh)
        _hold(got, seeds, False, (8, 4, 2))

    def test_a_batch_shorter_than_dp_leaves_slices_idle(self):
        seeds = (99,)
        Db, wb = _batch(seeds)
        got = sharded.sharded_clean(Db, wb, CleanConfig(backend="torch"),
                                    make_mesh(devices=_cpus(4), dp=4, sp=1))
        _hold(got, seeds, False, (4, 4, 1))

    @pytest.mark.parametrize("kernel", [False, True])
    def test_histories_come_back_on_request(self, kernel):
        seeds = (5, 0, 9)
        Db, wb = _batch(seeds)
        got = sharded.sharded_clean(Db, wb, CleanConfig(backend="torch", kernel=kernel),
                                    make_mesh(devices=_cpus(4), dp=2, sp=2), want_history=True)
        one = _one_device(seeds, kernel)
        assert len(got) == 6
        assert np.array_equal(got[4], one[4]) and np.array_equal(got[5], one[5])
        for j in range(len(seeds)):
            assert np.array_equal(got[5][j][int(got[4][j])], got[1][j])

    def test_traffic_counts_every_hop_and_no_copy_on_one_device(self):
        Db, wb = _batch((99,))
        collectives.traffic.reset()
        sharded.sharded_clean(Db, wb, CleanConfig(backend="torch"),
                              make_mesh(devices=_cpus(2), dp=1, sp=2))
        t = collectives.traffic
        assert t.gathered_bytes > 0 and t.peer_copies == 0
        assert t.staged_reads == t.staged_uploads == t.staged_bytes == 0

    def test_more_devices_than_subints_raise(self):
        Db, wb = _batch((99,))
        with pytest.raises(ValueError, match="would hold none"):
            sharded.sharded_clean(Db, wb, CleanConfig(backend="torch"),
                                  make_mesh(devices=_cpus(9), dp=1, sp=9))


class TestShardBatch:
    def test_each_device_uploads_its_block(self, tmp_path):
        # dp=2 x sp=3 over 3 archives of 8 subints, from memory-mapped .npy
        # files: device (i, k) holds archives i::2, subints of block k.
        paths = []
        for seed in (99, 5, 0):
            D, w0 = _cube(seed)
            np.save(tmp_path / f"D{seed}.npy", D)
            paths.append((np.load(tmp_path / f"D{seed}.npy", mmap_mode="r"), w0))
        mesh = make_mesh(devices=_cpus(6), dp=2, sp=3)
        Ds, ws = sharded.shard_batch([c for c, _ in paths], [w for _, w in paths], mesh)
        assert len(Ds) == len(ws) == 6
        bounds = [(0, 3), (3, 6), (6, 8)]
        for pos, (D, w) in enumerate(zip(Ds, ws)):
            i, k = divmod(pos, 3)
            lo, hi = bounds[k]
            take = list(range(i, 3, 2))
            assert tuple(D.shape) == (len(take), hi - lo, *SHAPE[1:])
            for j, src in enumerate(take):
                assert np.array_equal(D[j].numpy(), paths[src][0][lo:hi])
                assert np.array_equal(w[j].numpy(), paths[src][1][lo:hi])


@pytest.fixture()
def tiny_hbm(monkeypatch):
    """Pretend devices have 1 kB of memory so any real cube is oversized."""
    monkeypatch.setenv("ICT_HBM_BYTES", "1024")


@pytest.fixture()
def cpu_mesh_devices(monkeypatch):
    """``autoshard.default_devices`` giving ``n`` logical CPU devices."""
    def use(n):
        monkeypatch.setattr(autoshard, "default_devices", lambda device="cuda": _cpus(n))
    return use


class TestShouldShard:
    def test_needs_multiple_devices(self, tiny_hbm):
        assert autoshard.should_shard(SHAPE, "cpu", n_devices=1) is False
        assert autoshard.should_shard(SHAPE, "cpu", n_devices=8) is True

    def test_false_when_memory_unknown(self, monkeypatch):
        monkeypatch.delenv("ICT_HBM_BYTES", raising=False)
        assert autoshard.device_memory_bytes("cpu") is None
        assert autoshard.should_shard((1 << 10, 1 << 10, 1 << 10), "cpu", n_devices=8) is False

    def test_false_when_it_fits(self, monkeypatch):
        monkeypatch.setenv("ICT_HBM_BYTES", str(1 << 40))
        assert autoshard.should_shard(SHAPE, "cpu", n_devices=8) is False

    def test_devices_default_to_the_callers(self, tiny_hbm, cpu_mesh_devices):
        assert autoshard.should_shard(SHAPE, "cpu") is False   # [cpu]: one device
        cpu_mesh_devices(2)
        assert autoshard.should_shard(SHAPE, "cpu") is True


class TestSingleArchiveMesh:
    def test_takes_sp_only(self):
        mesh = autoshard.single_archive_mesh(SHAPE, devices=_cpus(8))
        assert mesh.shape == {"dp": 1, "sp": 8, "tp": 1}

    def test_drops_what_the_peel_cannot_use(self):
        # nsub 2 takes one factor of 2; the JAX package spills the rest to
        # tp, the port leaves those devices out.
        mesh = autoshard.single_archive_mesh((2, 16, 64), devices=_cpus(8))
        assert mesh.shape == {"dp": 1, "sp": 2, "tp": 1} and len(mesh.devices) == 2
        assert jax_single_mesh((2, 16, 64), n_devices=8).shape["sp"] == 2

    @pytest.mark.parametrize("shape", [(3, 5, 64), (9, 16, 64)])
    def test_one_device_is_none(self, shape):
        assert autoshard.single_archive_mesh(shape, devices=_cpus(8)) is None

    @pytest.mark.parametrize("nsub", [8, 6, 12])
    @pytest.mark.parametrize("n", [2, 3, 4, 6, 8])
    def test_sp_matches_the_jax_package(self, nsub, n):
        mesh = autoshard.single_archive_mesh((nsub, 16, 64), devices=_cpus(n))
        want = jax_single_mesh((nsub, 16, 64), n_devices=n).shape["sp"]
        assert (1 if mesh is None else mesh.shape["sp"]) == want

    def test_default_devices(self, cpu_mesh_devices):
        cpu_mesh_devices(4)
        assert autoshard.single_archive_mesh(SHAPE).shape["sp"] == 4


class TestAutoShardedClean:
    def test_against_jax_clean_cube_and_the_one_device_batch(self, tiny_hbm,
                                                             cpu_mesh_devices, capsys):
        cpu_mesh_devices(2)
        D, w0 = _cube(60)
        res = clean_cube(D, w0, CleanConfig(backend="torch"), device="cpu")
        err = capsys.readouterr().err
        assert "auto-sharding cube (8, 16, 64)" in err and "over 2 devices (sp=2" in err
        # The sharded route: no per-loop records, no history.
        assert res.history == [] and res.iterations == []
        jres = jax_clean_cube(D, w0, JaxConfig(backend="jax"))
        assert jres.history == []   # the JAX package took its sharded route too
        assert np.array_equal(res.weights, jres.weights)
        assert (res.loops, res.converged) == (jres.loops, jres.converged)
        assert _drift(res.test_results, jres.test_results) <= AUDIT_DRIFT_BOUND
        one = sharded.sharded_clean([D], [w0], CleanConfig(backend="torch"),
                                    make_mesh(devices=["cpu"]))
        assert np.array_equal(_bits(res.test_results), _bits(one[0][0]))
        ora = clean_cube(D, w0, CleanConfig(backend="numpy"))
        assert np.array_equal(res.weights, ora.weights) and res.loops == ora.loops

    def test_masks_identical_to_unsharded(self, tiny_hbm, cpu_mesh_devices):
        cpu_mesh_devices(4)
        D, w0 = _cube(61)
        cfg = CleanConfig(backend="torch", max_iter=4)
        auto = clean_cube(D, w0, cfg, device="cpu")
        assert auto.history == []
        plain = clean_cube(D, w0, cfg.replace(auto_shard=False), device="cpu")
        assert plain.history   # and the opt-out really opted out
        assert np.array_equal(auto.weights, plain.weights)
        assert (auto.loops, auto.converged) == (plain.loops, plain.converged)

    def test_route_is_observed(self, tiny_hbm, cpu_mesh_devices, monkeypatch):
        cpu_mesh_devices(2)
        seen = []
        monkeypatch.setattr(obs_memory, "observe_route", seen.append)
        clean_cube(*_cube(62), CleanConfig(backend="torch"), device="cpu")
        assert seen == ["sharded"]

    @pytest.mark.parametrize("why", ["residual", "x64", "one device", "indivisible"])
    def test_declines_to_chunked(self, tiny_hbm, cpu_mesh_devices, capsys, why):
        cpu_mesh_devices(1 if why == "one device" else 2)
        D, w0 = _cube(63, nsub=7 if why == "indivisible" else SHAPE[0])
        cfg = CleanConfig(backend="torch", max_iter=3, x64=why == "x64")
        res = clean_cube(D, w0, cfg, want_residual=why == "residual", device="cpu")
        err = capsys.readouterr().err
        assert "auto-sharding" not in err and "chunked clean:" in err
        assert len(res.history) >= 2   # the stepwise chunked route
        if why == "residual":
            assert res.residual is not None
        ora = clean_cube(D, w0, CleanConfig(backend="numpy", max_iter=3))
        assert np.array_equal(res.weights, ora.weights)

    def test_numpy_backend_never_routed(self, tiny_hbm, cpu_mesh_devices):
        cpu_mesh_devices(2)
        res = clean_cube(*_cube(64), CleanConfig(backend="numpy", max_iter=3))
        assert len(res.history) >= 2


def _write(tmp_path, seeds):
    paths = []
    for s in seeds:
        p = str(tmp_path / f"a{s}.npz")
        NpzIO().save(make_archive(nsub=SHAPE[0], nchan=SHAPE[1], nbin=SHAPE[2], seed=s), p)
        paths.append(p)
    return paths


class TestBatchDriverDaemon:
    def test_local_mesh_defaults(self, cpu_mesh_devices):
        assert local_mesh("cpu").devices == (torch.device("cpu"),)
        cpu_mesh_devices(4)
        assert local_mesh("cpu").shape == {"dp": 2, "sp": 2, "tp": 1}

    def test_directory_batch_on_dp2_sp2(self, tmp_path):
        paths = _write(tmp_path, (70, 71, 72))
        cfg = CleanConfig(backend="torch")
        got = batch.clean_directory_batch(paths, cfg, mesh=make_mesh(devices=_cpus(4)))
        one = batch.clean_directory_batch(paths, cfg, mesh=make_mesh(devices=["cpu"]))
        for g, o in zip(got, one):
            assert g.error is None and np.array_equal(g.weights, o.weights)
            assert np.array_equal(_bits(g.test_results), _bits(o.test_results))
            assert (g.loops, g.converged) == (o.loops, o.converged)

    def test_dispatch_size_is_per_dp_slice(self, monkeypatch):
        monkeypatch.setenv("ICT_HBM_BYTES", str(10 ** 9))
        cfg = CleanConfig(backend="torch")
        one = batch._dispatch_size(SHAPE, cfg, make_mesh(devices=["cpu"]))
        assert one > 0
        assert batch._dispatch_size(SHAPE, cfg, make_mesh(devices=_cpus(4))) == 2 * one
        monkeypatch.delenv("ICT_HBM_BYTES")
        assert batch._dispatch_size(SHAPE, cfg, make_mesh(devices=_cpus(4))) is None

    def test_driver_sharded_batch_on_the_local_mesh(self, tmp_path, monkeypatch,
                                                    cpu_mesh_devices):
        cpu_mesh_devices(4)
        meshes = []
        real = batch.clean_directory_batch

        def spy(paths, cfg, mesh=None):
            meshes.append(mesh)
            return real(paths, cfg, mesh=mesh)

        monkeypatch.setattr(batch, "clean_directory_batch", spy)
        paths = _write(tmp_path, (73, 74))
        cfg = CleanConfig(backend="torch", sharded_batch=True, no_log=True, quiet=True)
        reports = driver.run(paths, cfg, device="cpu")
        assert [m.shape for m in meshes] == [{"dp": 2, "sp": 2, "tp": 1}]
        for rep, p in zip(reports, paths):
            assert rep.error is None
            ora = clean_cube(*preprocess(NpzIO().load(p)), CleanConfig(backend="numpy"))
            assert (rep.loops, rep.converged) == (ora.loops, ora.converged)

    @pytest.mark.parametrize("n, cap", [(1, 1), (2, 2), (4, 2), (8, 4)])
    def test_daemon_bucket_cap_is_dp(self, tmp_path, cpu_mesh_devices, n, cap):
        cpu_mesh_devices(n)
        svc = CleaningService(ServeConfig(
            spool_dir=str(tmp_path / "spool"), port=0, deadline_s=0.2, quiet=True,
            device="cpu", clean=CleanConfig(backend="torch", max_iter=3, quiet=True,
                                            no_log=True)))
        svc.start()
        try:
            assert svc.mesh.shape["dp"] == cap and svc.bucket_cap == cap
        finally:
            svc.stop()


    def test_warm_pool_reaches_every_device(self, tmp_path, cpu_mesh_devices, monkeypatch):
        # dp=2 x sp=2: the warm dispatches of 1 and 2 archives between them
        # put zeros on every device of the mesh.
        cpu_mesh_devices(4)
        held = []
        real = sharded.shard_batch

        def spy(Db, w0b, mesh):
            out = real(Db, w0b, mesh)
            if mesh.is_local:
                held.append([int(D.shape[0]) for D in out[0]])
            return out

        monkeypatch.setattr(sharded, "shard_batch", spy)
        svc = CleaningService(ServeConfig(
            spool_dir=str(tmp_path / "spool"), port=0, deadline_s=0.2, quiet=True,
            device="cpu", warm_shapes=((4, 16, 64),),
            clean=CleanConfig(backend="torch", max_iter=3, quiet=True, no_log=True)))
        svc.start()
        try:
            assert svc.pool.is_warm((4, 16, 64))
        finally:
            svc.stop()
        assert held == [[1, 1, 0, 0], [1, 1, 1, 1]]


class TestRouteContract:
    def test_local_route_holds_its_ledger(self):
        runs, failures = contracts.run_routes("cpu", routes={"local"})
        assert failures == [] and len(runs) == 2
        for run in runs:
            assert run.units["archive block"] == 2 and run.units["continuing iteration"] > 0
            assert contracts.check_run(run) == [], run.name
            assert len(run.trace.uploads) == 4
