"""The port's threshold sweep against the JAX package's, on the CPU.

The same seeded cube goes through the JAX package's ``sweep_thresholds``
(``jax.vmap`` of its fused loop, Pallas off, as tests/test_sweep.py runs
it) and the port's (``iterative_cleaner_tpu_torch.models.sweep``, the
batched loop over a pair axis on ``device="cpu"``).  Masks, ``loops``,
``converged`` and ``rfi_frac`` must be identical between the two packages,
to the port's solo cleans with each pair's thresholds and, at (4, 4), to
the numpy oracle.  Also: the grid chunked on a pretend device budget, the
solo-clean reroute beneath one pair, the table and the NPZ against the JAX
package's, the CLI's ``--sweep``, and the scalers with one threshold pair
per archive bit-identical to the per-archive float calls.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import pytest
import torch

from iterative_cleaner_tpu.cli import main as jax_main
from iterative_cleaner_tpu.config import CleanConfig as JaxConfig
from iterative_cleaner_tpu.io.synthetic import make_archive as jax_make_archive
from iterative_cleaner_tpu.models import sweep as jax_sweep
from iterative_cleaner_tpu.ops.preprocess import preprocess as jax_preprocess
from iterative_cleaner_tpu_torch import cli
from iterative_cleaner_tpu_torch.backends.base import make_backend
from iterative_cleaner_tpu_torch.config import CleanConfig
from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
from iterative_cleaner_tpu_torch.io.npz import NpzIO
from iterative_cleaner_tpu_torch.io.synthetic import make_archive
from iterative_cleaner_tpu_torch.models import sweep
from iterative_cleaner_tpu_torch.ops import stats as tstats
from iterative_cleaner_tpu_torch.parallel import autoshard, sharded

PAIRS = [(3.0, 3.0), (5.0, 5.0), (8.0, 2.5), (0.0, 5.0)]
ZERO_WARNING = "threshold of exactly 0"


@functools.lru_cache(maxsize=None)
def _cube(seed=140, nsub=8, nchan=16, nbin=64):
    D, w0 = jax_preprocess(jax_make_archive(nsub=nsub, nchan=nchan, nbin=nbin, seed=seed),
                           prefer_native=False)
    D.setflags(write=False)
    w0.setflags(write=False)
    return D, w0


def _cfg(**kw):
    return CleanConfig(**{"backend": "torch", "max_iter": 4, **kw})


@functools.lru_cache(maxsize=None)
def _port_points(max_iter):
    return sweep.sweep_thresholds(*_cube(), _cfg(max_iter=max_iter), PAIRS, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_points(max_iter):
    return jax_sweep.sweep_thresholds(*_cube(), JaxConfig(backend="jax", max_iter=max_iter),
                                      PAIRS)


def _solo(D, w0, cfg, c, s):
    if c == 0 or s == 0:
        with pytest.warns(UserWarning, match=ZERO_WARNING):
            cfg = cfg.replace(chanthresh=c, subintthresh=s)
    else:
        cfg = cfg.replace(chanthresh=c, subintthresh=s)
    return clean_cube(D, w0, cfg, device="cpu")


def _same_point(p, q):
    assert (p.chanthresh, p.subintthresh) == (q.chanthresh, q.subintthresh)
    np.testing.assert_array_equal(p.weights, q.weights)
    assert (p.loops, p.converged, p.rfi_frac) == (q.loops, q.converged, q.rfi_frac)


@pytest.fixture()
def fresh_announcements(monkeypatch):
    monkeypatch.setattr(sweep, "_announced_chunkings", set())


class TestSweepPoints:
    @pytest.mark.parametrize("max_iter", [4, 2])
    @pytest.mark.parametrize("k", range(len(PAIRS)))
    def test_point_matches_jax_and_solo_cleans(self, k, max_iter):
        D, w0 = _cube()
        p, q = _port_points(max_iter)[k], _jax_points(max_iter)[k]
        _same_point(p, q)
        c, s = PAIRS[k]
        for kw in ({}, {"incremental_template": False}, {"fused": True}):
            solo = _solo(D, w0, _cfg(max_iter=max_iter, **kw), c, s)
            np.testing.assert_array_equal(p.weights, solo.weights)
            assert (p.loops, p.converged) == (solo.loops, solo.converged)
            assert p.rfi_frac == float((solo.weights == 0).mean())

    def test_matches_numpy_oracle(self):
        D, w0 = _cube()
        points = sweep.sweep_thresholds(D, w0, _cfg(), [(4.0, 4.0)], device="cpu")
        res = clean_cube(D, w0, CleanConfig(backend="numpy", max_iter=4, chanthresh=4.0,
                                            subintthresh=4.0))
        np.testing.assert_array_equal(points[0].weights, res.weights)
        assert (points[0].loops, points[0].converged) == (res.loops, res.converged)

    def test_tighter_thresholds_zap_no_less(self):
        points = sweep.sweep_thresholds(*_cube(), _cfg(), [(2.0, 2.0), (10.0, 10.0)],
                                        device="cpu")
        assert points[0].rfi_frac >= points[1].rfi_frac

    @pytest.mark.parametrize("seed", [0, 5, 42])
    def test_other_cubes_match_jax(self, seed):
        D, w0 = _cube(seed)
        pairs = [(4.0, 6.0), (6.0, 4.0), (5.0, 5.0)]
        got = sweep.sweep_thresholds(D, w0, _cfg(max_iter=5), pairs, device="cpu")
        want = jax_sweep.sweep_thresholds(D, w0, JaxConfig(backend="jax", max_iter=5), pairs)
        for p, q in zip(got, want):
            _same_point(p, q)

    def test_each_point_owns_its_mask(self):
        points = sweep.sweep_thresholds(*_cube(), _cfg(), PAIRS[:2], device="cpu")
        for p, q in zip(points, _port_points(4)):
            assert p.weights.shape == _cube()[1].shape and p.weights.base is None
            _same_point(p, q)
        points[0].weights[:] = -1
        np.testing.assert_array_equal(points[1].weights, _port_points(4)[1].weights)

    def test_one_broadcast_cube_and_threshold_tensors(self, monkeypatch):
        """The pair axis is the cube expanded (stride 0, no copy), and the
        thresholds reach the loop as (a,) float32 tensors."""
        seen = []
        real = sharded.batched_fused_clean

        def spy(Db, w0b, validb, cts, sts, **kw):
            seen.append((Db.stride(0), w0b.stride(0), validb.stride(0), cts.clone(),
                         sts.clone(), kw["use_kernel"]))
            return real(Db, w0b, validb, cts, sts, **kw)

        monkeypatch.setattr(sharded, "batched_fused_clean", spy)
        sweep.sweep_thresholds(*_cube(), _cfg(), PAIRS[:3], device="cpu")
        assert len(seen) == 1
        d0, w0s, v0, cts, sts, use_kernel = seen[0]
        assert (d0, w0s, v0) == (0, 0, 0) and use_kernel is False
        assert cts.dtype == sts.dtype == torch.float32
        assert cts.tolist() == [3.0, 5.0, 8.0] and sts.tolist() == [3.0, 5.0, 2.5]


class TestSweepSizing:
    @pytest.mark.parametrize("room,chunk,sizes", [(1.5, 1, [1, 1, 1, 1]),
                                                  (2.5, 2, [2, 2]), (3.2, 3, [3, 1])])
    def test_chunks_under_a_budget(self, monkeypatch, capsys, fresh_announcements, room,
                                   chunk, sizes):
        D, w0 = _cube()
        cfg = _cfg()
        one = autoshard.batch_working_set_bytes(D.shape, cfg, False, 1)
        monkeypatch.setenv("ICT_HBM_BYTES", str(int(room * one / autoshard.HBM_USABLE_FRACTION)))
        got = []
        real = sharded.batched_fused_clean

        def spy(Db, *args, **kw):
            got.append(Db.shape[0])
            return real(Db, *args, **kw)

        monkeypatch.setattr(sharded, "batched_fused_clean", spy)
        points = sweep.sweep_thresholds(D, w0, cfg, PAIRS, device="cpu")
        assert f"sweep: running 4 pairs in chunks of {chunk} (full grid would exceed device " \
               "memory)" in capsys.readouterr().err
        assert got == sizes
        for p, q in zip(points, _port_points(4)):
            _same_point(p, q)

    def test_chunking_matches_jax_message(self, monkeypatch, capsys, fresh_announcements):
        D, w0 = _cube()
        monkeypatch.setattr(jax_sweep, "_announced_chunkings", set())
        monkeypatch.setenv("ICT_HBM_BYTES", str(int(D.size * 4 * 3.5 * 1.5)))
        pairs = [(3.0, 3.0), (5.0, 5.0), (7.0, 7.0)]
        want = jax_sweep.sweep_thresholds(D, w0, JaxConfig(backend="jax", max_iter=3,
                                                           auto_shard=False), pairs)
        jax_err = capsys.readouterr().err
        assert "chunks of 1" in jax_err
        one = autoshard.batch_working_set_bytes(D.shape, _cfg(max_iter=3), False, 1)
        monkeypatch.setenv("ICT_HBM_BYTES", str(int(1.5 * one / autoshard.HBM_USABLE_FRACTION)))
        got = sweep.sweep_thresholds(D, w0, _cfg(max_iter=3), pairs, device="cpu")
        line = ("sweep: running 3 pairs in chunks of 1 (full grid would exceed device "
                "memory)\n")
        assert line in jax_err and capsys.readouterr().err == line
        for p, q in zip(got, want):
            _same_point(p, q)

    def test_announced_once_per_decision(self, monkeypatch, capsys, fresh_announcements):
        D, w0 = _cube()
        one = autoshard.batch_working_set_bytes(D.shape, _cfg(), False, 1)
        monkeypatch.setenv("ICT_HBM_BYTES", str(int(1.5 * one / autoshard.HBM_USABLE_FRACTION)))
        for _ in range(2):
            sweep.sweep_thresholds(D, w0, _cfg(), PAIRS[:2], device="cpu")
        assert capsys.readouterr().err.count("chunks of 1") == 1

    def test_solo_reroute_beneath_one_pair(self, monkeypatch, capsys, fresh_announcements):
        """A cube whose working set exceeds the budget for even one pair is
        never uploaded whole: each pair is a solo clean, which streams it
        through the chunked cleaner, and the points stay the same."""
        D, w0 = _cube()
        pairs = PAIRS[:3]
        monkeypatch.setenv("ICT_HBM_BYTES", str(int(D.size * 4 * 0.5)))
        monkeypatch.setattr(jax_sweep, "_announced_chunkings", set())
        called = []
        monkeypatch.setattr(sharded, "batched_fused_clean",
                            lambda *a, **k: called.append(1))
        got = sweep.sweep_thresholds(D, w0, _cfg(), pairs, device="cpu")
        err = capsys.readouterr().err
        assert not called
        assert ("sweep: cube (8, 16, 64) exceeds device memory even for a single pair; "
                "running 3 pairs as solo cleans through the >HBM sharded/chunked chain") in err
        assert err.count("chunked clean: cube (8, 16, 64) exceeds device memory") == 3
        for p, q in zip(got, _port_points(4)):
            _same_point(p, q)
        want = jax_sweep.sweep_thresholds(D, w0, JaxConfig(backend="jax", max_iter=4), pairs)
        for p, q in zip(got, want):
            _same_point(p, q)

    def test_lofar_pair_sizing(self):
        """At 256 x 1024 x 1024 one pair is ~6.5 GB on the plain route: 9
        pairs fit an 80 GB card in one dispatch, a 20 GB budget takes 2 per
        dispatch, a 4 GB budget none (the solo route)."""
        cfg = CleanConfig(backend="torch")
        one = autoshard.batch_working_set_bytes((256, 1024, 1024), cfg, False, 1)
        assert 6.4e9 < one < 6.6e9
        for hbm, want in ((80e9, 11), (20e9, 2), (4e9, 0)):
            assert int(hbm * autoshard.HBM_USABLE_FRACTION) // one == want


class TestSweepRules:
    def test_empty_grid(self):
        assert sweep.sweep_thresholds(*_cube(), _cfg(), [], device="cpu") == []
        assert sweep.grid([], [5]) == [] == jax_sweep.grid([], [5])

    @pytest.mark.parametrize("cs,ss", [([3, 5], [4, 6]), ([5], [2.5, 5, 7]), ([1.5], [2])])
    def test_grid_order_matches_jax(self, cs, ss):
        assert sweep.grid(cs, ss) == jax_sweep.grid(cs, ss)
        assert sweep.grid([3, 5], [4, 6]) == [(3.0, 4.0), (3.0, 6.0), (5.0, 4.0), (5.0, 6.0)]

    def test_requires_torch_backend(self):
        with pytest.raises(ValueError, match="backend='torch'"):
            sweep.sweep_thresholds(*_cube(), CleanConfig(backend="numpy"), [(5.0, 5.0)],
                                   device="cpu")

    def test_forced_kernel_refused(self):
        with pytest.raises(ValueError, match="does not support kernel=True"):
            sweep.sweep_thresholds(*_cube(), _cfg(kernel=True), [(5.0, 5.0)], device="cpu")
        with pytest.raises(ValueError, match="does not support pallas=True"):
            jax_sweep.sweep_thresholds(*_cube(), JaxConfig(backend="jax", pallas=True),
                                       [(5.0, 5.0)])

    @pytest.mark.parametrize("max_iter", [4, 2])
    def test_format_table_matches_jax(self, max_iter):
        assert sweep.format_table(_port_points(max_iter)) == \
            jax_sweep.format_table(_jax_points(max_iter))
        assert len(sweep.format_table(_port_points(max_iter)).splitlines()) == len(PAIRS) + 1

    @pytest.mark.parametrize("keep", [True, False])
    def test_save_sweep_matches_jax_file(self, tmp_path, keep):
        port = [sweep.SweepPoint(**{**p.__dict__, "weights": p.weights if keep else None})
                for p in _port_points(4)]
        jaxp = [jax_sweep.SweepPoint(**{**p.__dict__, "weights": p.weights if keep else None})
                for p in _jax_points(4)]
        sweep.save_sweep(port, str(tmp_path / "p.npz"))
        jax_sweep.save_sweep(jaxp, str(tmp_path / "j.npz"))
        with np.load(tmp_path / "p.npz") as a, np.load(tmp_path / "j.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            assert ("weights" in a.files) == keep
            for key in a.files:
                assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape
                np.testing.assert_array_equal(a[key], b[key])


class TestPerPairThresholds:
    @staticmethod
    def _maps(seed, a=3, nsub=9, nchan=12):
        rng = np.random.default_rng(seed)
        stack = [rng.standard_normal((a, nsub, nchan)).astype(np.float32) for _ in range(4)]
        stack[0] = np.abs(stack[0])
        stack[2] = np.abs(stack[2]) * 3
        valid = rng.random((a, nsub, nchan)) > 0.2
        valid[-1, 2, :] = False
        return [torch.from_numpy(x) for x in stack], torch.from_numpy(valid)

    @pytest.mark.parametrize("seed", range(4))
    @pytest.mark.parametrize("cts,sts", [((5.0, 3.0, 8.0), (5.0, 7.0, 2.5)),
                                         ((0.1, 1.0, 1e3), (3.3, 3.3, 3.3)),
                                         ((0.0, 5.0, 5.0), (5.0, 0.0, 5.0))])
    def test_bitwise_per_archive_float_calls(self, seed, cts, sts):
        maps, valid = self._maps(seed)
        got = tstats.scale_and_combine(*maps, valid, torch.tensor(cts), torch.tensor(sts))
        for j, (c, s) in enumerate(zip(cts, sts)):
            one = tstats.scale_and_combine(*(m[j] for m in maps), valid[j], c, s)
            np.testing.assert_array_equal(got[j].numpy().view(np.int32),
                                          one.numpy().view(np.int32))

    @pytest.mark.parametrize("thresh", [2.5, torch.tensor([2.5, 2.5])])
    def test_true_divide_by_threshold(self, thresh):
        x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4) + 1
        want = x / torch.full((), 2.5)
        assert torch.equal(tstats.true_divide(x, thresh), want)
        assert torch.equal(tstats.true_divide(x[None].expand(3, 2, 3, 4), thresh),
                           want[None].expand(3, 2, 3, 4))


class TestSweepCLI:
    def _write(self, tmp_path, seed=141, nsub=8):
        p = str(tmp_path / "a.npz")
        NpzIO().save(make_archive(nsub=nsub, nchan=16, nbin=64, seed=seed), p)
        return p

    def test_cli_writes_the_library_result(self, tmp_path, monkeypatch, capsys):
        monkeypatch.chdir(tmp_path)
        p = self._write(tmp_path)
        assert cli.main([p, "--device", "cpu", "--sweep", "3:3", "5:5", "8:2.5"]) == 0
        out = capsys.readouterr().out
        assert f"Sweep {p} (3 threshold pairs):" in out and "rfi_frac" in out
        D, w0 = jax_preprocess(NpzIO().load(p), prefer_native=False)
        lib = sweep.sweep_thresholds(D, w0, CleanConfig(backend="torch"),
                                     [(3.0, 3.0), (5.0, 5.0), (8.0, 2.5)], device="cpu")
        assert sweep.format_table(lib) in out
        with np.load(f"{p}_sweep.npz") as z:
            np.testing.assert_array_equal(z["weights"], np.stack([q.weights for q in lib]))
            assert z["loops"].tolist() == [q.loops for q in lib]
        assert not os.path.exists(f"{p}_cleaned.npz") and not os.path.exists("clean.log")

    def test_cli_matches_jax_cli(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        monkeypatch.setenv("ICT_NO_COMPILE_CACHE", "1")
        p = self._write(tmp_path, seed=142)
        assert jax_main([p, "--backend=jax", "-m", "3", "--sweep", "4:4", "6:3"]) == 0
        with np.load(f"{p}_sweep.npz") as z:
            want = {k: z[k] for k in z.files}
        os.remove(f"{p}_sweep.npz")
        assert cli.main([p, "--device", "cpu", "-m", "3", "--sweep", "4:4", "6:3"]) == 0
        with np.load(f"{p}_sweep.npz") as z:
            assert sorted(z.files) == sorted(want)
            for k in z.files:
                assert z[k].dtype == want[k].dtype
                np.testing.assert_array_equal(z[k], want[k])

    @pytest.mark.parametrize("spec", ["nonsense", "5", "a:b", "1:2:3"])
    def test_cli_bad_pair_exits_2(self, tmp_path, monkeypatch, capsys, spec):
        monkeypatch.chdir(tmp_path)
        p = self._write(tmp_path, nsub=4)
        assert cli.main([p, "--device", "cpu", "--sweep", spec]) == 2
        assert "bad --sweep pair" in capsys.readouterr().err
        assert not os.path.exists(f"{p}_sweep.npz")

    def test_cli_kernel_sweep_refused(self, tmp_path, monkeypatch, capsys):
        monkeypatch.chdir(tmp_path)
        p = self._write(tmp_path, nsub=4)
        assert cli.main([p, "--device", "cpu", "--kernel", "--sweep", "5:5"]) == 1
        assert "does not support kernel=True" in capsys.readouterr().err
        assert not os.path.exists(f"{p}_sweep.npz")
        assert jax_main([p, "--backend=jax", "--pallas", "--sweep", "5:5"]) == 1

    def test_cli_numpy_backend_refused(self, tmp_path, monkeypatch, capsys):
        monkeypatch.chdir(tmp_path)
        p = self._write(tmp_path, nsub=4)
        assert cli.main([p, "--backend", "numpy", "--sweep", "5:5", "--report", "r.json"]) == 1
        assert "--sweep requires --backend=torch" in capsys.readouterr().err

    def test_cli_zero_pair_warns(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        p = self._write(tmp_path, seed=143, nsub=4)
        with pytest.warns(UserWarning, match=ZERO_WARNING):
            assert cli.main([p, "--device", "cpu", "--sweep", "0:5", "5:5"]) == 0

    def test_cli_isolates_a_missing_archive(self, tmp_path, monkeypatch, capsys):
        monkeypatch.chdir(tmp_path)
        p = self._write(tmp_path, nsub=4)
        assert cli.main(["missing.npz", p, "--device", "cpu", "-q", "--sweep", "5:5"]) == 1
        assert "ERROR sweeping missing.npz" in capsys.readouterr().err
        assert os.path.exists(f"{p}_sweep.npz")


class TestNoHiddenDevice:
    @pytest.fixture(autouse=True)
    def _no_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present; the default device is valid here")

    def test_sweep_default_device_raises(self):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sweep.sweep_thresholds(*_cube(), CleanConfig(backend="torch"), [(5.0, 5.0)])

    def test_make_backend_default_device_raises(self):
        D, w0 = _cube()
        with pytest.raises(RuntimeError, match="no CUDA device.*pass device='cpu'"):
            make_backend(D, w0, CleanConfig(backend="torch"))
        assert make_backend(D, w0, CleanConfig(backend="numpy")).step(w0)[1].shape == w0.shape

    def test_cli_sweep_default_device_fails(self, tmp_path, monkeypatch, capsys):
        monkeypatch.chdir(tmp_path)
        NpzIO().save(make_archive(nsub=4, nchan=8, nbin=32), "a.npz")
        assert cli.main(["a.npz", "--sweep", "5:5"]) == 1
        assert "no CUDA device" in capsys.readouterr().err
