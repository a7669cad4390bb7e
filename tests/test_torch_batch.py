"""The port's directory batch against the JAX package, on the CPU.

The same seeded cubes go through the JAX package's batched route
(``parallel/sharded.batched_fused_clean``, with its Pallas kernel in
interpret mode where ``use_pallas=True``, as tests/test_pallas.py runs it;
``jax.vmap`` of the kernel and of the scalers) and the port's
(``iterative_cleaner_tpu_torch.parallel``), the port on ``device="cpu"``
where a forced kernel runs its plain version.  Masks, ``loops``, ``done`` and
the iteration counts must be identical, the kernel's maps within the
tolerances of tests/test_torch_fused_kernel.py (the f32 sum order differs),
and the port's batch bit-identical to its own single-archive route.  Also:
the directory dispatchers (mirroring tests/test_parallel.py and
tests/test_streaming.py), the driver's ``--sharded_batch`` / ``--stream`` /
``--resume``, the mesh, and the batch sizing on a fake device budget.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterative_cleaner_tpu.config import CleanConfig as JaxConfig
from iterative_cleaner_tpu.core.cleaner import clean_cube as jax_clean_cube
from iterative_cleaner_tpu.io.synthetic import make_archive as jax_make_archive
from iterative_cleaner_tpu.ops import stats as jstats
from iterative_cleaner_tpu.ops.pallas_kernels import fused_fit_moments as jax_fused
from iterative_cleaner_tpu.ops.preprocess import preprocess as jax_preprocess
from iterative_cleaner_tpu.ops.template import build_template as jax_build_template
from iterative_cleaner_tpu.parallel.mesh import factor_mesh as jax_factor_mesh
from iterative_cleaner_tpu.parallel.sharded import batched_fused_clean as jax_batched
from iterative_cleaner_tpu_torch import cli, driver
from iterative_cleaner_tpu_torch.backends.torch_backend import clean_step, run_fused
from iterative_cleaner_tpu_torch.config import CleanConfig
from iterative_cleaner_tpu_torch.core.cleaner import clean_cube, find_bad_parts
from iterative_cleaner_tpu_torch.io.npz import NpzIO
from iterative_cleaner_tpu_torch.io.synthetic import make_archive
from iterative_cleaner_tpu_torch.ops import fused_kernels as fk
from iterative_cleaner_tpu_torch.ops import stats as tstats
from iterative_cleaner_tpu_torch.ops.preprocess import preprocess
from iterative_cleaner_tpu_torch.ops.template import build_template, build_templates
from iterative_cleaner_tpu_torch.parallel import autoshard, batch, sharded
from iterative_cleaner_tpu_torch.parallel.mesh import factor_mesh, make_mesh

DRIFT_BOUND = 5e-5
REGION = (0.0, 0.0, 1.0)
# At 8 x 16 x 64, seeds 5 and 9 stop after 3 loops, seeds 0 and 1 after 2.
MIXED_SEEDS = (0, 5, 9, 1)
SMALL = (8, 16, 64)


@functools.lru_cache(maxsize=None)
def _cube(nsub, nchan, nbin, seed):
    D, w0 = jax_preprocess(jax_make_archive(nsub=nsub, nchan=nchan, nbin=nbin, seed=seed),
                           prefer_native=False)
    D.setflags(write=False)
    w0.setflags(write=False)
    return D, w0


def _batch(shape, seeds):
    pre = [_cube(*shape, s) for s in seeds]
    return np.stack([d for d, _ in pre]), np.stack([w for _, w in pre])


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


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


def _cpu_mesh():
    return make_mesh(devices=["cpu"])


def _write(tmp_path, n, nsub=8, seed0=70, tag="a"):
    paths = []
    for i in range(n):
        p = str(tmp_path / f"{tag}{i}.npz")
        NpzIO().save(make_archive(nsub=nsub, nchan=16, nbin=64, seed=seed0 + i), p)
        paths.append(p)
    return paths


def _solo(path, cfg):
    return clean_cube(*preprocess(NpzIO().load(path)), cfg, device="cpu")


class TestBatchedKernelPlain:
    @pytest.mark.parametrize("shape", [(8, 64, 256), (5, 33, 100)])
    @pytest.mark.parametrize("with_valid", [False, True])
    def test_matches_vmapped_jax_kernel(self, shape, with_valid):
        Db, w0b = _batch(shape, (42, 3, 11))
        tb = np.stack([np.asarray(jax_build_template(jnp.asarray(D), jnp.asarray(w)))
                       for D, w in zip(Db, w0b)])
        vb = w0b != 0

        def one(D, t, w, v):
            return jax_fused(D, t, w, v if with_valid else None, pulse_region=REGION,
                             interpret=True)

        want = jax.vmap(one)(jnp.asarray(Db), jnp.asarray(tb), jnp.asarray(w0b),
                             jnp.asarray(vb))
        got = fk.fused_fit_moments_plain(_t(Db), _t(tb), _t(w0b),
                                         _t(vb) if with_valid else None)
        for g, w, (rtol, atol) in zip(got, want, ((1e-5, 1e-5), (1e-5, 1e-6),
                                                  (1e-5, 1e-6), (1e-5, 1e-5))):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol, atol=atol)

    @pytest.mark.parametrize("region", [REGION, (0.25, 10.0, 30.0)])
    @pytest.mark.parametrize("with_valid", [False, True])
    def test_batch_is_the_per_archive_loop(self, region, with_valid):
        Db, w0b = _batch((5, 33, 100), (0, 7, 42))
        Dt, wt = _t(Db), _t(w0b)
        tb = build_templates(Dt, wt)
        vb = (wt != 0) if with_valid else None
        got = fk.fused_fit_moments_plain(Dt, tb, wt, vb, pulse_region=region)
        for j in range(Db.shape[0]):
            one = fk.fused_fit_moments_plain(Dt[j], tb[j], wt[j],
                                             None if vb is None else vb[j],
                                             pulse_region=region)
            for g, w in zip(got, one):
                assert torch.equal(g[j], w)

    def test_templates_per_archive_are_the_single_builds(self):
        Db, w0b = _batch(SMALL, MIXED_SEEDS)
        tb = build_templates(_t(Db), _t(w0b))
        for j in range(Db.shape[0]):
            assert torch.equal(tb[j], build_template(_t(Db[j]), _t(w0b[j])))

    def test_wrapper_cpu_batch_runs_plain_and_counts_nothing(self):
        Db, w0b = _batch((4, 16, 64), (1, 2))
        Dt, wt = _t(Db), _t(w0b)
        tb = build_templates(Dt, wt)
        before = fk.fused_fit_moments.launches
        out = fk.fused_fit_moments(Dt, tb, wt, wt != 0)
        plain = fk.fused_fit_moments_plain(Dt, tb, wt, wt != 0)
        assert all(torch.equal(a, b) for a, b in zip(out, plain))
        assert fk.fused_fit_moments.launches == before

    def test_batch_input_checks(self):
        D = torch.zeros((2, 3, 4, 8))
        t = torch.zeros((2, 8))
        w = torch.zeros((2, 3, 4))
        assert fk._check_inputs(D, t, w, w != 0) == (3, 4, 8)
        with pytest.raises(ValueError, match="template"):
            fk._check_inputs(D, torch.zeros(8), w, None)
        with pytest.raises(ValueError, match="w0"):
            fk._check_inputs(D, t, torch.zeros((3, 4)), None)
        with pytest.raises(ValueError, match="D must be"):
            fk._check_inputs(torch.zeros((1, 2, 3, 4, 8)), t, w, None)
        many = fk.MAX_ARCHIVES + 1
        with pytest.raises(ValueError, match="archives in one launch"):
            fk._check_inputs(torch.zeros((many, 1, 1, 1)), torch.zeros((many, 1)),
                             torch.zeros((many, 1, 1)), None)


class TestBatchedScalers:
    @staticmethod
    def _maps(seed, a=3, nsub=9, nchan=12):
        rng = np.random.default_rng(seed)
        scales = np.array([1e-3, 1.0, 1e4, 7.0][:a], np.float32)
        stack = [(rng.standard_normal((a, nsub, nchan)) * scales[:, None, None])
                 .astype(np.float32) for _ in range(4)]
        stack[0] = np.abs(stack[0])
        stack[2] = np.abs(stack[2]) * 3
        valid = rng.random((a, nsub, nchan)) > 0.2
        valid[-1, 2, :] = False           # a fully masked subint in one archive
        return stack, valid

    @pytest.mark.parametrize("seed", range(4))
    @pytest.mark.parametrize("thresh", [(5.0, 5.0), (2.5, 4.0)])
    def test_bitwise_per_archive_and_vs_vmapped_jax(self, seed, thresh):
        (s, m, p, f), valid = self._maps(seed)
        got = tstats.scale_and_combine(_t(s), _t(m), _t(p), _t(f), _t(valid), *thresh).numpy()
        for j in range(valid.shape[0]):
            one = tstats.scale_and_combine(_t(s[j]), _t(m[j]), _t(p[j]), _t(f[j]),
                                           _t(valid[j]), *thresh).numpy()
            np.testing.assert_array_equal(_bits(got[j]), _bits(one))
        want = jax.vmap(lambda *x: jstats.scale_and_combine(*x, *thresh))(
            *(jnp.asarray(x) for x in (s, m, p, f, valid)))
        np.testing.assert_array_equal(_bits(got), _bits(np.asarray(want)))

    def test_medians_never_cross_archives(self):
        # Archive 1 is archive 0 scaled by 1e6: a median taken across the
        # batch would move archive 0's scores; per archive they are equal.
        (s, m, p, f), valid = self._maps(7, a=1)
        stack = [np.concatenate((x, x * np.float32(1e6))) for x in (s, m, p, f)]
        v2 = np.concatenate((valid, valid))
        got = tstats.scale_and_combine(*(_t(x) for x in stack), _t(v2), 5.0, 5.0).numpy()
        alone = tstats.scale_and_combine(*(_t(x) for x in (s, m, p, f)), _t(valid),
                                         5.0, 5.0).numpy()
        np.testing.assert_array_equal(_bits(got[0]), _bits(alone[0]))

    @pytest.mark.parametrize("nsub,piece_rows", [(10, 4), (8, 4), (3, 8)])
    def test_fft_pieces_stay_within_archives(self, monkeypatch, nsub, piece_rows):
        rng = np.random.default_rng(nsub)
        x = rng.standard_normal((3, nsub, 5, 16)).astype(np.float32)
        monkeypatch.setattr(tstats, "FFT_PIECE_ELEMENTS", piece_rows * 5 * 16)
        calls = []
        real = torch.fft.rfft

        def spy(t, *args, **kw):
            calls.append(t.shape[0])
            return real(t, *args, **kw)

        monkeypatch.setattr(torch.fft, "rfft", spy)
        got = tstats.fft_diagnostic(_t(x))
        per_archive = []
        for j in range(3):
            n0 = len(calls)
            np.testing.assert_array_equal(got[j].numpy(), tstats.fft_diagnostic(_t(x[j])).numpy())
            per_archive.append(calls[n0:])
        batch_calls = calls[:len(calls) - sum(len(c) for c in per_archive)]
        assert batch_calls == [n for c in per_archive for n in c]
        assert all(sum(c) == nsub for c in per_archive)


class TestBatchedFusedClean:
    @pytest.mark.parametrize("use_kernel", [False, True])
    @pytest.mark.parametrize("max_iter", [5, 2])
    def test_matches_jax_batched_fused_clean(self, use_kernel, max_iter):
        Db, w0b = _batch(SMALL, MIXED_SEEDS)
        want = jax_batched(jnp.asarray(Db), jnp.asarray(w0b), jnp.asarray(w0b != 0), 5.0, 5.0,
                           max_iter=max_iter, pulse_region=REGION, use_pallas=use_kernel)
        Dt, wt = _t(Db), _t(w0b)
        got = sharded.batched_fused_clean(Dt, wt, wt != 0, 5.0, 5.0, max_iter=max_iter,
                                          pulse_region=REGION, use_kernel=use_kernel)
        assert got[5] is None and want[5] is None
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))    # masks
        for k in (2, 3, 4):                                                  # loops, done, x
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        np.testing.assert_array_equal(got[6].numpy(), np.asarray(want[6]))    # history
        assert _drift(got[0].numpy(), np.asarray(want[0])) <= DRIFT_BOUND
        if max_iter == 5:
            assert got[2].tolist() == [2, 3, 3, 2] and bool(got[3].all())
        else:
            assert got[3].tolist() == [True, False, False, True]

    @pytest.mark.parametrize("use_kernel", [False, True])
    def test_each_archive_equals_its_own_fused_clean(self, use_kernel):
        Db, w0b = _batch(SMALL, MIXED_SEEDS)
        Dt, wt = _t(Db), _t(w0b)
        test, w, loops, done, x, _r, hist = sharded.batched_fused_clean(
            Dt, wt, wt != 0, 5.0, 5.0, max_iter=5, pulse_region=REGION,
            use_kernel=use_kernel)
        cfg = CleanConfig(backend="torch", kernel=use_kernel, incremental_template=False)
        for j in range(Db.shape[0]):
            t1, w1, l1, d1, x1, h1 = run_fused(Db[j], w0b[j], cfg, device="cpu")
            np.testing.assert_array_equal(_bits(test[j].numpy()), _bits(t1))
            np.testing.assert_array_equal(w[j].numpy(), w1)
            assert (int(loops[j]), bool(done[j]), int(x[j])) == (l1, d1, x1)
            np.testing.assert_array_equal(hist[j, : x1 + 1].numpy(), h1)
            assert not hist[j, x1 + 1:].any()      # a stopped archive's rows stay unwritten

    def test_batched_clean_step_is_clean_step_per_archive(self):
        Db, w0b = _batch(SMALL, (0, 5))
        Dt, wt = _t(Db), _t(w0b)
        w_prev = wt.clone()
        w_prev[0, 1, 2] = 0.0
        test, new_w, resid = sharded.batched_clean_step(
            Dt, wt, wt != 0, w_prev, 5.0, 5.0, pulse_region=REGION, use_kernel=False)
        for j in range(2):
            t1, n1, r1 = clean_step(Dt[j], wt[j], wt[j] != 0, w_prev[j], 5.0, 5.0,
                                    pulse_region=REGION)
            assert torch.equal(test[j], t1) and torch.equal(new_w[j], n1)
            assert torch.equal(resid[j], r1)


class TestShardedClean:
    @pytest.mark.parametrize("kernel", [None, True])
    def test_matches_clean_cube_jax_and_oracle(self, kernel):
        Db, w0b = _batch(SMALL, MIXED_SEEDS)
        cfg = CleanConfig(backend="torch", kernel=kernel, max_iter=4)
        test_b, w_b, loops_b, done_b = sharded.sharded_clean(Db, w0b, cfg, _cpu_mesh())
        assert w_b.shape == (4, 8, 16) and loops_b.dtype == np.int64 and done_b.dtype == bool
        for j in range(4):
            port = clean_cube(Db[j], w0b[j], cfg, device="cpu")
            oracle = clean_cube(Db[j], w0b[j], CleanConfig(backend="numpy", max_iter=4))
            jres = jax_clean_cube(Db[j], w0b[j], JaxConfig(backend="jax", max_iter=4))
            for ref in (port, oracle, jres):
                np.testing.assert_array_equal(w_b[j], ref.weights)
                assert (int(loops_b[j]), bool(done_b[j])) == (ref.loops, ref.converged)
            assert _drift(test_b[j], oracle.test_results) <= DRIFT_BOUND

    def test_sequence_input_and_single(self):
        Db, w0b = _batch(SMALL, (5, 9))
        cfg = CleanConfig(backend="torch")
        stacked = sharded.sharded_clean(Db, w0b, cfg, _cpu_mesh())
        listed = sharded.sharded_clean(list(Db), list(w0b), cfg, _cpu_mesh())
        for a, b in zip(stacked, listed):
            np.testing.assert_array_equal(a, b)
        t, w, loops, done = sharded.sharded_clean_single(Db[1], w0b[1], cfg, _cpu_mesh())
        np.testing.assert_array_equal(w, stacked[1][1])
        assert (loops, done) == (3, True)

    def test_upload_refuses_mixed_shapes_and_empty(self):
        a, wa = _cube(8, 16, 64, 0)
        b, wb = _cube(4, 16, 64, 0)
        with pytest.raises(ValueError, match="never pad"):
            sharded.shard_batch([a, b], [wa, wb], _cpu_mesh())
        with pytest.raises(ValueError, match="empty"):
            sharded.shard_batch([], [], _cpu_mesh())


class TestMesh:
    @pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
    def test_factor_mesh_matches_jax(self, n):
        assert factor_mesh(n) == jax_factor_mesh(n)

    def test_one_device_mesh(self):
        mesh = make_mesh(devices=["cpu"])
        assert mesh.shape == {"dp": 1, "sp": 1, "tp": 1}
        assert mesh.device == torch.device("cpu")

    @pytest.mark.parametrize("kw", [{}, {"dp": 1, "sp": 2, "tp": 1}])
    def test_more_than_one_device_raises(self, kw):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_mesh(2, devices=["cpu", "cpu"], **kw)

    def test_extents_must_match_device_count(self):
        with pytest.raises(ValueError, match="dp\\*sp\\*tp"):
            make_mesh(1, dp=2, devices=["cpu"])


class TestDirectoryBatch:
    def test_directory_batch(self, tmp_path):
        paths = _write(tmp_path, 3, seed0=50)
        p_odd = str(tmp_path / "odd.npz")       # a different shape: its own bucket
        NpzIO().save(make_archive(nsub=4, nchan=16, nbin=64, seed=99), p_odd)
        paths += [p_odd, str(tmp_path / "missing.npz")]
        cfg = CleanConfig(backend="torch", max_iter=3)
        items = batch.clean_directory_batch(paths, cfg, mesh=_cpu_mesh())
        assert [it.error is None for it in items] == [True, True, True, True, False]
        for it in items[:4]:
            assert it.weights is not None and it.loops >= 1
            res = _solo(it.path, cfg)
            np.testing.assert_array_equal(it.weights, res.weights)
            assert (it.loops, it.converged) == (res.loops, res.converged)
        jres = jax_clean_cube(*jax_preprocess(NpzIO().load(paths[0]), prefer_native=False),
                              JaxConfig(backend="jax", max_iter=3))
        np.testing.assert_array_equal(items[0].weights, jres.weights)

    def test_rfi_frac_before_the_sweep(self, tmp_path):
        paths = _write(tmp_path, 2, seed0=5)
        cfg = CleanConfig(backend="torch", bad_chan=0.05, bad_subint=0.05)
        items = batch.clean_directory_batch(paths, cfg, mesh=_cpu_mesh())
        for it in items:
            res = _solo(it.path, cfg)
            assert it.rfi_frac == float((res.weights == 0).mean())
            swept, nbs, nbc = find_bad_parts(res.weights, cfg)
            assert nbs + nbc > 0
            np.testing.assert_array_equal(it.weights, swept)

    def test_budget_splits_a_bucket_into_dispatches(self, tmp_path, monkeypatch):
        paths = _write(tmp_path, 5, seed0=20)
        cfg = CleanConfig(backend="torch", max_iter=3)
        free = batch.clean_directory_batch(paths, cfg, mesh=_cpu_mesh())
        one = autoshard.batch_working_set_bytes((8, 16, 64), cfg, False, 1)
        monkeypatch.setenv("ICT_HBM_BYTES", str(int(2.5 * one / autoshard.HBM_USABLE_FRACTION)))
        sizes = []
        real = batch.sharded_clean

        def spy(Db, w0b, *a, **kw):
            sizes.append(len(Db))
            return real(Db, w0b, *a, **kw)

        monkeypatch.setattr(batch, "sharded_clean", spy)
        split = batch.clean_directory_batch(paths, cfg, mesh=_cpu_mesh())
        assert sizes == [2, 2, 1]
        for a, b in zip(free, split):
            np.testing.assert_array_equal(a.weights, b.weights)
            assert (a.loops, a.converged) == (b.loops, b.converged)

    def test_archive_larger_than_the_budget_is_an_item_error(self, tmp_path, monkeypatch):
        paths = _write(tmp_path, 2, seed0=30)
        monkeypatch.setenv("ICT_HBM_BYTES", "1000")
        items = batch.clean_directory_batch(paths, CleanConfig(backend="torch"),
                                            mesh=_cpu_mesh())
        for it in items:
            assert it.weights is None and "without --sharded_batch" in it.error

    def test_numpy_backend_refused(self):
        with pytest.raises(ValueError, match="backend='torch'"):
            batch.clean_directory_batch([], CleanConfig(backend="numpy"), mesh=_cpu_mesh())


class TestStreaming:
    def test_streaming_matches_solo(self, tmp_path):
        paths = _write(tmp_path, 4)
        cfg = CleanConfig(backend="torch", max_iter=3)
        items = batch.clean_directory_streaming(paths, cfg, mesh=_cpu_mesh())
        assert all(it.error is None for it in items)
        for it in items:
            res = _solo(it.path, cfg)
            np.testing.assert_array_equal(it.weights, res.weights)
            assert it.loops == res.loops

    def test_streaming_mixed_shapes_and_failures(self, tmp_path):
        paths = _write(tmp_path, 3, nsub=8, seed0=80)
        paths += _write(tmp_path, 2, nsub=4, seed0=90, tag="b")
        paths.append(str(tmp_path / "missing.npz"))
        cfg = CleanConfig(backend="torch", max_iter=3)
        items = batch.clean_directory_streaming(paths, cfg, mesh=_cpu_mesh(), bucket_cap=2)
        assert [it.error is None for it in items] == [True] * 5 + [False]
        for it in items[:5]:
            np.testing.assert_array_equal(it.weights, _solo(it.path, cfg).weights)

    def test_heterogeneous_shapes_bounded_residency(self, tmp_path, monkeypatch):
        # 5 distinct shapes, cap 2, 1 loader: parked sub-cap buckets fill the
        # read-ahead window (3) and must trigger the early fullest-bucket
        # flush, never accumulating the whole directory.
        paths = []
        for i, nsub in enumerate((4, 6, 8, 10, 12)):
            p = str(tmp_path / f"h{i}.npz")
            NpzIO().save(make_archive(nsub=nsub, nchan=16, nbin=64, seed=130 + i), p)
            paths.append(p)
        live, peak = [0], [0]
        real = batch._load_and_preprocess

        def counted(path):
            out = real(path)
            live[0] += 1
            peak[0] = max(peak[0], live[0])
            return out

        def release(i, item):
            live[0] -= 1
            item.archive = None

        monkeypatch.setattr(batch, "_load_and_preprocess", counted)
        cfg = CleanConfig(backend="torch", max_iter=2)
        items = batch.clean_directory_streaming(paths, cfg, mesh=_cpu_mesh(), bucket_cap=2,
                                                n_loaders=1, on_item=release)
        assert all(it.error is None and it.weights is not None for it in items)
        assert peak[0] <= 3 and live[0] == 0
        for it in items:
            np.testing.assert_array_equal(it.weights, _solo(it.path, cfg).weights)

    def _dispatch_sizes(self, monkeypatch):
        sizes = []
        real = batch.sharded_clean

        def spy(Db, w0b, *a, **kw):
            sizes.append((len(Db), np.shape(Db[0])[0]))
            return real(Db, w0b, *a, **kw)

        monkeypatch.setattr(batch, "sharded_clean", spy)
        return sizes

    def test_partial_bucket_flush(self, tmp_path, monkeypatch):
        # 3 archives, cap 2: one full flush and one remainder flush.
        sizes = self._dispatch_sizes(monkeypatch)
        paths = _write(tmp_path, 3, seed0=100)
        items = batch.clean_directory_streaming(paths, CleanConfig(backend="torch", max_iter=2),
                                                mesh=_cpu_mesh(), bucket_cap=2)
        assert all(it.weights is not None for it in items)
        assert sorted(n for n, _ in sizes) == [1, 2]

    def test_early_flush_trims_to_a_power_of_two(self, tmp_path, monkeypatch):
        # Cap 4 and 1 loader: the window is 5.  Three of one shape and two
        # singletons fill it; the fullest bucket (3) goes early as 2.
        sizes = self._dispatch_sizes(monkeypatch)
        paths = _write(tmp_path, 3, nsub=8, seed0=60)
        paths += [_write(tmp_path, 1, nsub=4, seed0=64, tag="b")[0],
                  _write(tmp_path, 1, nsub=6, seed0=65, tag="c")[0]]
        cfg = CleanConfig(backend="torch", max_iter=2)
        items = batch.clean_directory_streaming(paths, cfg, mesh=_cpu_mesh(), bucket_cap=4,
                                                n_loaders=1)
        assert sizes[0] == (2, 8)
        assert sorted(sizes) == [(1, 4), (1, 6), (1, 8), (2, 8)]
        for it in items:
            np.testing.assert_array_equal(it.weights, _solo(it.path, cfg).weights)

    def test_default_cap_is_the_dispatch_size(self, tmp_path, monkeypatch):
        sizes = self._dispatch_sizes(monkeypatch)
        cfg = CleanConfig(backend="torch", max_iter=2)
        one = autoshard.batch_working_set_bytes((8, 16, 64), cfg, False, 1)
        monkeypatch.setenv("ICT_HBM_BYTES", str(int(3.5 * one / autoshard.HBM_USABLE_FRACTION)))
        paths = _write(tmp_path, 7, seed0=40)
        items = batch.clean_directory_streaming(paths, cfg, mesh=_cpu_mesh())
        assert all(it.error is None for it in items)
        assert sorted(n for n, _ in sizes) == [1, 3, 3]


class TestAutoStreamDefault:
    """--sharded_batch switches to the streaming dispatcher by itself above
    a host-RAM threshold, and then releases each item's host arrays."""

    def _spies(self, monkeypatch):
        calls = {}
        orig_stream = batch.clean_directory_streaming
        orig_batch = batch.clean_directory_batch

        def spy_stream(paths, cfg, mesh=None, **kw):
            calls["route"] = "stream"
            calls["on_item"] = kw.get("on_item")
            calls["items"] = orig_stream(paths, cfg, mesh=mesh, **kw)
            return calls["items"]

        def spy_batch(paths, cfg, mesh=None, **kw):
            calls["route"] = "batch"
            return orig_batch(paths, cfg, mesh=mesh, **kw)

        monkeypatch.setattr(batch, "clean_directory_streaming", spy_stream)
        monkeypatch.setattr(batch, "clean_directory_batch", spy_batch)
        return calls

    def test_large_batch_streams_by_default(self, tmp_path, monkeypatch):
        calls = self._spies(monkeypatch)
        monkeypatch.chdir(tmp_path)
        paths = _write(tmp_path, 3, seed0=140)
        monkeypatch.setenv("ICT_STREAM_THRESHOLD_BYTES", "1")
        cfg = CleanConfig(backend="torch", sharded_batch=True, max_iter=2, quiet=True,
                          no_log=True)
        reports = driver.run(paths, cfg, device="cpu")
        assert calls["route"] == "stream" and calls["on_item"] is not None
        assert all(it.archive is None and it.weights is None for it in calls["items"])
        assert all(r.error is None for r in reports)
        for r, p in zip(reports, paths):
            got = NpzIO().load(r.out_path)
            np.testing.assert_array_equal(
                got.weights, _solo(p, CleanConfig(backend="torch", max_iter=2)).weights)

    def test_small_batch_keeps_all_at_once_route(self, tmp_path, monkeypatch):
        calls = self._spies(monkeypatch)
        monkeypatch.chdir(tmp_path)
        paths = _write(tmp_path, 2, seed0=150)
        monkeypatch.setenv("ICT_STREAM_THRESHOLD_BYTES", str(1 << 40))
        cfg = CleanConfig(backend="torch", sharded_batch=True, max_iter=2, quiet=True,
                          no_log=True)
        reports = driver.run(paths, cfg, device="cpu")
        assert calls["route"] == "batch"
        assert all(r.error is None for r in reports)

    def test_threshold_zero_disables_the_switch(self, monkeypatch):
        monkeypatch.setenv("ICT_STREAM_THRESHOLD_BYTES", "0")
        cfg = CleanConfig(backend="torch", sharded_batch=True, quiet=True)
        assert driver._auto_stream(["x.npz"], cfg) is False
        monkeypatch.setenv("ICT_STREAM_THRESHOLD_BYTES", "1")
        assert driver._auto_stream([], cfg.replace(stream=True)) is True  # explicit wins

    def test_unparseable_threshold_warns(self, monkeypatch, capsys):
        monkeypatch.setenv("ICT_STREAM_THRESHOLD_BYTES", "lots")
        assert driver._stream_threshold_bytes() == int(
            driver._host_ram_bytes() * driver.STREAM_RAM_FRACTION)
        assert "unparseable" in capsys.readouterr().err


class TestDriverAndCLI:
    @pytest.mark.parametrize("sharded_batch", [False, True])
    def test_resume_skips_and_keeps_report_order(self, tmp_path, monkeypatch, sharded_batch):
        monkeypatch.chdir(tmp_path)
        paths = _write(tmp_path, 3, seed0=10)
        cfg = CleanConfig(backend="torch", sharded_batch=sharded_batch, quiet=True,
                          no_log=True)
        driver.run([paths[1]], cfg, device="cpu")
        before = os.path.getmtime(paths[1] + "_cleaned.npz")
        reports = driver.run(paths, cfg.replace(resume=True), device="cpu")
        assert [r.path for r in reports] == paths
        assert [r.skipped for r in reports] == [False, True, False]
        assert reports[1].out_path == paths[1] + "_cleaned.npz" and reports[1].loops == 0
        assert os.path.getmtime(paths[1] + "_cleaned.npz") == before
        assert all(os.path.exists(p + "_cleaned.npz") for p in paths)
        again = driver.run(paths, cfg.replace(resume=True), device="cpu")
        assert all(r.skipped for r in again)

    def test_resume_with_explicit_output_cleans_everything(self, tmp_path, monkeypatch,
                                                           capsys):
        monkeypatch.chdir(tmp_path)
        todo, skipped = driver.split_resumable(["a.npz", "b.npz"],
                                               CleanConfig(resume=True, output="x.npz"))
        assert todo == ["a.npz", "b.npz"] and skipped == {}
        assert "only skips archives in the default naming" in capsys.readouterr().err

    def test_merge_reports_order(self):
        R = driver.ArchiveReport
        skipped = {1: R("b", "b_c", skipped=True), 3: R("d", "d_c", skipped=True)}
        done = [R("a", "a_c"), R("c", "c_c")]
        assert [r.path for r in driver._merge_reports(4, skipped, done)] == ["a", "b", "c", "d"]

    def test_cli_sharded_batch_stream_and_resume(self, tmp_path, monkeypatch, capsys):
        monkeypatch.chdir(tmp_path)
        paths = _write(tmp_path, 3, seed0=0)
        paths.insert(1, "missing.npz")
        oracle = [clean_cube(*preprocess(NpzIO().load(p)), CleanConfig(backend="numpy"))
                  for p in paths if p != "missing.npz"]
        base = ["--device", "cpu", "-q", "--sharded_batch"]
        assert cli.main([*paths, *base]) == 1
        assert "ERROR cleaning missing.npz" in capsys.readouterr().err
        for p, ref in zip([p for p in paths if p != "missing.npz"], oracle):
            np.testing.assert_array_equal(NpzIO().load(p + "_cleaned.npz").weights, ref.weights)
        log = (tmp_path / "clean.log").read_text()
        assert log.count("Cleaned ") == 3 and "sharded_batch=True" in log
        for p in paths:
            if p != "missing.npz":
                os.remove(p + "_cleaned.npz")
        assert cli.main([*paths, *base, "--stream", "--report", "r.json"]) == 1
        import json

        rep = json.load(open("r.json"))
        assert [r["error"] is None for r in rep] == [True, False, True, True]
        assert cli.main([*paths, *base, "--resume", "--report", "r2.json"]) == 1
        rep = json.load(open("r2.json"))
        assert [r["skipped"] for r in rep] == [True, False, True, True]
        assert (tmp_path / "clean.log").read_text().count("Cleaned ") == 6

    def test_batch_warns_for_residual_and_mask_history(self, tmp_path, monkeypatch, capsys):
        monkeypatch.chdir(tmp_path)
        paths = _write(tmp_path, 1, seed0=3)
        cfg = CleanConfig(backend="torch", sharded_batch=True, unload_res=True,
                          dump_masks=True, quiet=True, no_log=True)
        reports = driver.run(paths, cfg, device="cpu")
        err = capsys.readouterr().err
        assert "--unload_res is not supported" in err and "'history' key" in err
        assert reports[0].error is None
        with np.load(paths[0] + "_cleaned.npz_masks.npz") as z:
            assert "history" not in z and int(z["loops"]) == reports[0].loops
        assert not os.path.exists(paths[0] + "_residual_2.npz")


class TestBatchSizing:
    SHAPE = (256, 1024, 1024)

    def test_working_set_is_per_archive_times_count(self):
        cfg = CleanConfig(backend="torch", max_iter=5)
        profiles = 256 * 1024
        for use_kernel in (True, False):
            one = autoshard.working_set_bytes(self.SHAPE, 4, use_kernel) + 6 * profiles * 4
            assert autoshard.batch_working_set_bytes(self.SHAPE, cfg, use_kernel, 8) == 8 * one

    @pytest.mark.parametrize("budget_gb,device,want", [
        (9, "cuda", 3), (80, "cuda", 28), (2, "cuda", 0), (80, "cpu", 11)])
    def test_archives_per_dispatch_on_a_fake_budget(self, monkeypatch, budget_gb, device,
                                                    want):
        monkeypatch.setenv("ICT_HBM_BYTES", str(budget_gb * 10**9))
        cfg = CleanConfig(backend="torch")
        k = autoshard.archives_per_dispatch(self.SHAPE, cfg, device)
        assert k == want
        one = autoshard.batch_working_set_bytes(self.SHAPE, cfg, device == "cuda", 1)
        usable = budget_gb * 10**9 * autoshard.HBM_USABLE_FRACTION
        assert k * one <= usable < (k + 1) * one

    def test_no_limit_on_the_cpu(self, monkeypatch):
        monkeypatch.delenv("ICT_HBM_BYTES", raising=False)
        assert autoshard.archives_per_dispatch(self.SHAPE, CleanConfig(backend="torch"),
                                               "cpu") is None


class TestNoHiddenDevice:
    @pytest.fixture(autouse=True)
    def _no_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present; the default device is valid here")

    def test_default_mesh_raises(self):
        Db, w0b = _batch(SMALL, (0,))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sharded.sharded_clean(Db, w0b, CleanConfig(backend="torch"))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            batch.clean_directory_streaming([], CleanConfig(backend="torch"))

    def test_driver_default_device_raises(self, tmp_path):
        paths = _write(tmp_path, 1, seed0=1)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            driver.run(paths, CleanConfig(backend="torch", sharded_batch=True))
