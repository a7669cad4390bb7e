"""The port's chunked streaming route, its uploader and its routing, on the
CPU, against the JAX package's ``ChunkedJaxCleaner`` and the numpy oracle.

Mirrors tests/test_chunked.py: masks identical at every block size, a
single-block stream bit-exact with the in-memory route, the residual
bit-exact after incremental iterations, the template pass dropping out
from iteration 2, a poisoned cube falling back to the dense pass; plus the
``stream_map`` protocol and ``chunk_block_subints`` against the JAX formula.
"""

from __future__ import annotations

import functools
import threading
import time

import numpy as np
import pytest
import torch

from iterative_cleaner_tpu.backends.numpy_backend import NumpyCleaner as JaxNumpyCleaner
from iterative_cleaner_tpu.config import CleanConfig as JaxConfig
from iterative_cleaner_tpu.core.cleaner import clean_cube as jax_clean_cube
from iterative_cleaner_tpu.io.synthetic import make_archive as jax_make_archive
from iterative_cleaner_tpu.ops.preprocess import preprocess as jax_preprocess
from iterative_cleaner_tpu.parallel import autoshard as jax_autoshard
from iterative_cleaner_tpu.parallel.chunked import ChunkedJaxCleaner
from iterative_cleaner_tpu_torch import cli
from iterative_cleaner_tpu_torch.backends.torch_backend import TorchCleaner
from iterative_cleaner_tpu_torch.config import CleanConfig
from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
from iterative_cleaner_tpu_torch.ingest import pipeline
from iterative_cleaner_tpu_torch.io.npz import NpzIO
from iterative_cleaner_tpu_torch.io.synthetic import make_preprocessed_cube
from iterative_cleaner_tpu_torch.models.surgical import SurgicalCleaner
from iterative_cleaner_tpu_torch.parallel import autoshard
from iterative_cleaner_tpu_torch.parallel.chunked import ChunkedTorchCleaner

DRIFT_BOUND = 5e-5
SEEDS = [0, 3, 5, 7, 11, 42]
SHAPES = [(8, 64, 256), (5, 33, 100)]


@functools.lru_cache(maxsize=None)
def _cube(nsub, nchan, nbin, seed):
    D, w0 = jax_preprocess(jax_make_archive(nsub=nsub, nchan=nchan, nbin=nbin, seed=seed),
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


def _chunked(D, w0, block, **kw):
    return ChunkedTorchCleaner(D, w0, CleanConfig(backend="torch", **kw), block=block,
                               device="cpu")


class TestChunkedParity:
    @pytest.mark.parametrize("shape", SHAPES)
    @pytest.mark.parametrize("seed", SEEDS)
    @pytest.mark.parametrize("block", [1, 3, "nsub"])
    def test_step_matches_jax_and_oracle(self, block, seed, shape):
        D, w0 = _cube(*shape, seed)
        block = shape[0] if block == "nsub" else block
        t_p, w_p = _chunked(D, w0, block).step(w0)
        t_j, w_j = ChunkedJaxCleaner(D, w0, JaxConfig(backend="jax"), block=block).step(w0)
        _t, w_o = JaxNumpyCleaner(D, w0, JaxConfig(backend="numpy")).step(w0)
        np.testing.assert_array_equal(w_p, w_j)
        np.testing.assert_array_equal(w_p, w_o)
        assert _drift(t_p, t_j) <= DRIFT_BOUND

    @pytest.mark.parametrize("seed", [0, 11, 42])
    @pytest.mark.parametrize("block", [1, 3, 8])
    def test_full_clean_matches_jax_and_oracle(self, block, seed):
        D, w0 = _cube(8, 64, 256, seed)
        port = clean_cube(D, w0, CleanConfig(backend="torch", chunk_block=block),
                          device="cpu")
        ref = jax_clean_cube(D, w0, JaxConfig(backend="jax", chunk_block=block))
        oracle = jax_clean_cube(D, w0, JaxConfig(backend="numpy"))
        for other in (ref, oracle):
            np.testing.assert_array_equal(port.weights, other.weights)
            assert (port.loops, port.converged) == (other.loops, other.converged)
        assert len(port.history) == len(ref.history) and port.timed

    @pytest.mark.parametrize("block", [3, 8])
    def test_kernel_forced_blocks_match_jax_pallas(self, block):
        D, w0 = _cube(8, 64, 256, 0)
        _t, w_p = _chunked(D, w0, block, kernel=True).step(w0)
        _t, w_x = _chunked(D, w0, block, kernel=False).step(w0)
        _t, w_j = ChunkedJaxCleaner(D, w0, JaxConfig(backend="jax", pallas=True),
                                    block=block).step(w0)
        np.testing.assert_array_equal(w_p, w_x)
        np.testing.assert_array_equal(w_p, w_j)

    @pytest.mark.parametrize("shape", SHAPES)
    def test_single_block_bit_exact_with_in_memory(self, shape):
        D, w0 = _cube(*shape, 3)
        cfg = CleanConfig(backend="torch")
        mem = TorchCleaner(D, w0, cfg, device="cpu")
        chunk = ChunkedTorchCleaner(D, w0, cfg, block=shape[0], device="cpu")
        w_m = w_c = w0
        for _ in range(3):
            t_m, w_m = mem.step(w_m)
            t_c, w_c = chunk.step(w_c)
            np.testing.assert_array_equal(t_c, t_m)
            np.testing.assert_array_equal(w_c, w_m)

    def test_residual_matches_in_memory(self):
        D, w0 = _cube(8, 64, 256, 7)
        cfg = CleanConfig(backend="torch", incremental_template=False)
        mem = TorchCleaner(D, w0, cfg, device="cpu")
        mem.step(w0)
        part = ChunkedTorchCleaner(D, w0, cfg, block=3, keep_residual=True, device="cpu")
        part.step(w0)
        np.testing.assert_allclose(part.residual(), mem.residual(), rtol=1e-4, atol=1e-5)
        full = ChunkedTorchCleaner(D, w0, cfg, block=8, keep_residual=True, device="cpu")
        full.step(w0)
        np.testing.assert_array_equal(full.residual(), mem.residual())

    def test_residual_bit_exact_after_incremental_iterations(self):
        """The residual fetch rebuilds the template densely, never reusing a
        sparse-updated carry, so a full-block residual stays bit-exact with
        the dense in-memory route."""
        D, w0 = _cube(8, 64, 256, 7)
        mem = TorchCleaner(D, w0, CleanConfig(backend="torch", incremental_template=False),
                           device="cpu")
        chunk = ChunkedTorchCleaner(D, w0, CleanConfig(backend="torch", max_iter=4),
                                    block=8, keep_residual=True, device="cpu")
        w_m = w_c = w0
        for _ in range(3):
            _, w_m = mem.step(w_m)
            _, w_c = chunk.step(w_c)
            np.testing.assert_array_equal(w_m, w_c)
        np.testing.assert_array_equal(chunk.residual(), mem.residual())

    def test_residual_through_clean_cube(self):
        D, w0 = _cube(5, 33, 100, 7)
        port = clean_cube(D, w0, CleanConfig(backend="torch", chunk_block=2), device="cpu",
                          want_residual=True)
        ref = jax_clean_cube(D, w0, JaxConfig(backend="jax", chunk_block=2),
                             want_residual=True)
        np.testing.assert_array_equal(port.weights, ref.weights)
        np.testing.assert_allclose(port.residual, ref.residual, rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("seed", [0, 5, 42])
    def test_template_passes_drop_from_iteration_2(self, seed):
        D, w0 = _cube(8, 64, 256, seed)
        inc = _chunked(D, w0, 3, max_iter=4)
        dense = _chunked(D, w0, 3, max_iter=4, incremental_template=False)
        w_i = w_d = w0
        for it in range(1, 4):
            _, w_i2 = inc.step(w_i)
            _, w_d = dense.step(w_d)
            np.testing.assert_array_equal(w_i2, w_d)
            assert inc.template_passes == 1 and dense.template_passes == it
            if np.array_equal(w_i2, w_i):
                break
            w_i = w_i2

    def test_poisoned_cube_falls_back_dense(self):
        D, w0 = _cube(8, 64, 256, 5)
        D = np.array(D)
        D[2, 3, 5] = np.inf
        backend = _chunked(D, w0, 3, max_iter=3)
        w = w0
        with np.errstate(all="ignore"):
            for it in range(1, 4):
                _, w_new = backend.step(w)
                assert backend.template_passes == it  # every iteration dense
                if np.array_equal(w_new, w):
                    break
                w = w_new
            port = clean_cube(D, w0, CleanConfig(backend="torch", max_iter=3,
                                                 chunk_block=3), device="cpu")
            oracle = jax_clean_cube(D, w0, JaxConfig(backend="numpy", max_iter=3))
        np.testing.assert_array_equal(port.weights, oracle.weights)

    def test_serial_and_pipelined_identical(self):
        D, w0 = _cube(8, 64, 256, 11)
        cfg = CleanConfig(backend="torch")
        a = ChunkedTorchCleaner(D, w0, cfg, block=3, ingest_depth=2, device="cpu")
        b = ChunkedTorchCleaner(D, w0, cfg, block=3, ingest_depth=1, device="cpu")
        t_a, w_a = a.step(w0)
        t_b, w_b = b.step(w0)
        np.testing.assert_array_equal(t_a, t_b)
        np.testing.assert_array_equal(w_a, w_b)


class TestStreamMap:
    def test_order_and_values(self):
        ranges = [(i, i + 2) for i in range(0, 10, 2)]
        seen = []
        outs = pipeline.stream_map(
            ranges, load=lambda lo, hi: np.arange(lo, hi),
            compute=lambda lo, hi, blk: (lo, hi, blk.sum()),
            sync=lambda out: seen.append(out[0]))
        assert [o[:2] for o in outs] == ranges
        assert [o[2] for o in outs] == [lo + lo + 1 for lo, _ in ranges]
        assert seen == [lo for lo, _ in ranges]  # every output synced once

    @pytest.mark.parametrize("depth", [2, 3])
    def test_at_most_depth_blocks_live(self, depth):
        lock = threading.Lock()
        state = {"live": 0, "peak": 0}

        def load(lo, hi):
            with lock:
                state["live"] += 1
                state["peak"] = max(state["peak"], state["live"])
            time.sleep(0.002)
            return lo

        def sync(out):
            time.sleep(0.002)
            with lock:
                state["live"] -= 1

        outs = pipeline.stream_map([(i, i + 1) for i in range(12)], load,
                                   compute=lambda lo, hi, blk: blk, sync=sync, depth=depth)
        assert outs == list(range(12))
        assert state["peak"] <= depth and state["live"] == 0

    def test_depth_one_equals_depth_two(self):
        host = np.random.default_rng(0).normal(size=(10, 4, 8)).astype(np.float32)
        outs = []
        for depth in (1, 2):
            up = pipeline.SlabUploader(host, 3, "cpu", depth)
            outs.append(up.stream([(lo, min(lo + 3, 10)) for lo in range(0, 10, 3)],
                                  lambda lo, hi, blk: blk.sum(dim=(1, 2)).clone(), depth))
        for a, b in zip(*outs):
            assert torch.equal(a, b)
        np.testing.assert_allclose(torch.cat(outs[0]).numpy(), host.sum(axis=(1, 2)),
                                   rtol=1e-5, atol=1e-5)

    def test_uploader_serves_exact_slices_and_never_writes_the_host(self):
        host = np.arange(7 * 3 * 5, dtype=np.float32).reshape(7, 3, 5)
        host.setflags(write=False)
        up = pipeline.SlabUploader(host, 3, "cpu", 2)
        got = up.stream([(0, 3), (3, 6), (6, 7)], lambda lo, hi, blk: blk.clone(), 2)
        assert [tuple(g.shape) for g in got] == [(3, 3, 5), (3, 3, 5), (1, 3, 5)]
        np.testing.assert_array_equal(torch.cat(got).numpy(), host)

    def test_stager_exception_reaches_the_caller(self):
        def load(lo, hi):
            if lo >= 4:
                raise RuntimeError("boom in stager thread")
            return np.zeros(2)

        result = {}

        def call():
            try:
                pipeline.stream_map([(i, i + 2) for i in range(0, 10, 2)], load,
                                    compute=lambda lo, hi, blk: blk, sync=lambda out: None)
            except RuntimeError as exc:
                result["exc"] = exc

        th = threading.Thread(target=call, daemon=True)
        th.start()
        th.join(timeout=30)
        assert not th.is_alive(), "stream_map hung on a stager exception"
        assert "boom in stager" in str(result["exc"])

    def test_compute_exception_shuts_stager_down(self):
        def compute(lo, hi, blk):
            if lo >= 4:
                raise ValueError("consumer died")
            return blk

        before = threading.active_count()
        with pytest.raises(ValueError, match="consumer died"):
            pipeline.stream_map([(i, i + 2) for i in range(0, 12, 2)],
                                load=lambda lo, hi: np.zeros(2), compute=compute,
                                sync=lambda out: None)
        assert threading.active_count() <= before

    def test_serial_depth_counts_all_stall(self):
        pipeline.reset_stats()
        pipeline.stream_map([(0, 2), (2, 4)], load=lambda lo, hi: np.zeros((hi - lo, 8)),
                            compute=lambda lo, hi, blk: blk, sync=lambda out: None, depth=1)
        s = pipeline.stats_snapshot()
        assert s["serial_blocks"] == 2 and s["bytes"] == 2 * 2 * 8 * 8
        assert s["overlap_efficiency"] == 0.0

    def test_overlap_high_when_uploads_hide_under_compute(self):
        pipeline.reset_stats()
        pipeline.stream_map([(i, i + 1) for i in range(6)],
                            load=lambda lo, hi: np.zeros(1024),
                            compute=lambda lo, hi, blk: blk,
                            sync=lambda out: time.sleep(0.02), depth=2)
        assert pipeline.stats_snapshot()["overlap_efficiency"] >= 0.5

    def test_stream_depth_env(self, monkeypatch):
        monkeypatch.setenv("ICT_INGEST_DEPTH", "1")
        assert pipeline.stream_depth() == 1
        monkeypatch.setenv("ICT_INGEST_DEPTH", "junk")
        assert pipeline.stream_depth() == pipeline.DEFAULT_DEPTH
        monkeypatch.delenv("ICT_INGEST_DEPTH")
        assert pipeline.stream_depth() == pipeline.DEFAULT_DEPTH


class TestAutoshard:
    @pytest.mark.parametrize("shape", [(8, 16, 64), (1024, 4096, 1024), (7, 33, 100)])
    @pytest.mark.parametrize("slabs", [1, 3.9, 8, 10, 1e6])
    def test_chunk_block_subints_equals_jax_formula(self, shape, slabs, monkeypatch):
        """At JAX's factor, no per-profile term and the default two slabs,
        the sizing is JAX's formula."""
        factor = jax_autoshard.PEAK_CUBE_FACTOR
        monkeypatch.setattr(autoshard, "PEAK_CUBE_FACTOR", {"kernel": factor,
                                                            "plain": factor})
        monkeypatch.setattr(autoshard, "PER_PROFILE_BYTES", {"kernel": 0, "plain": 0})
        monkeypatch.delenv("ICT_INGEST_DEPTH", raising=False)
        per_sub = jax_autoshard.working_set_bytes((1, *shape[1:]))
        monkeypatch.setenv("ICT_HBM_BYTES", str(int(per_sub * slabs)))
        for kernel in (None, False):
            got = autoshard.chunk_block_subints(
                shape, CleanConfig(backend="torch", kernel=kernel), "cpu")
            assert got == jax_autoshard.chunk_block_subints(shape, JaxConfig(backend="jax"))

    def test_routes_differ_by_their_own_factors(self, monkeypatch):
        shape = (64, 16, 64)
        hbm = int(autoshard.working_set_bytes(shape, 4, True) * 1.01
                  / autoshard.HBM_USABLE_FRACTION)
        monkeypatch.setenv("ICT_HBM_BYTES", str(hbm))
        assert autoshard.PEAK_CUBE_FACTOR["plain"] > autoshard.PEAK_CUBE_FACTOR["kernel"]
        assert (autoshard.working_set_bytes(shape, 4, False)
                > autoshard.working_set_bytes(shape, 4, True))
        assert autoshard.chunk_block_subints(shape, CleanConfig(backend="torch"),
                                             "cuda") is None
        assert autoshard.chunk_block_subints(shape, CleanConfig(backend="torch", kernel=False),
                                             "cuda") is not None
        # A residual request runs the plain route, so it is sized for it.
        assert autoshard.chunk_block_subints(shape, CleanConfig(backend="torch"), "cuda",
                                             want_residual=True) is not None

    @pytest.mark.parametrize("depth", [1, 2, 3, 5])
    def test_blocks_fit_the_budget_at_every_depth(self, depth, monkeypatch):
        """``depth`` live slabs, each with a block's working set, plus the
        whole cube's per-profile maps stay inside the usable budget, and one
        more subint per block would not."""
        monkeypatch.setenv("ICT_INGEST_DEPTH", str(depth))
        shape = (1024, 4096, 1024)
        hbm = 32 * 10**9
        usable = hbm * autoshard.HBM_USABLE_FRACTION
        maps = 1024 * 4096 * autoshard.PER_PROFILE_BYTES["kernel"]
        per_sub = autoshard.working_set_bytes((1, 4096, 1024), 4, True) - (
            4096 * autoshard.PER_PROFILE_BYTES["kernel"])
        block = autoshard.block_subints(shape, hbm)
        assert block == autoshard.block_subints(shape, hbm, depth=depth)
        assert 1 <= block < 1024
        assert maps + depth * block * per_sub <= usable
        assert maps + depth * (block + 1) * per_sub > usable

    def test_per_profile_term(self):
        """Two cubes of the same bytes: the one with more profiles needs
        more memory, by PER_PROFILE_BYTES each."""
        for kernel, route in ((True, "kernel"), (False, "plain")):
            a = autoshard.working_set_bytes((256, 1024, 1024), 4, kernel)
            b = autoshard.working_set_bytes((2048, 1024, 128), 4, kernel)
            assert b - a == (2048 - 256) * 1024 * autoshard.PER_PROFILE_BYTES[route]

    def test_fused_history_beyond_the_fit_counts(self, monkeypatch):
        """The fused loop keeps max_iter + 1 mask rows on the device: past
        the fitted max_iter each iteration adds 4 bytes per profile, and a
        cube that fits at the default no longer does."""
        shape = (64, 16, 64)
        extra = 40
        base = autoshard.working_set_bytes(shape, 4, True)
        assert autoshard.working_set_bytes(shape, 4, True, extra) == base + 64 * 16 * 4 * extra
        monkeypatch.setenv("ICT_HBM_BYTES", str(int(base * 1.01 / autoshard.HBM_USABLE_FRACTION)))
        long = autoshard.FIT_MAX_ITER + extra
        for cfg in (CleanConfig(backend="torch", fused=True),
                    CleanConfig(backend="torch", max_iter=long)):
            assert autoshard.chunk_block_subints(shape, cfg, "cuda") is None
        assert autoshard.chunk_block_subints(
            shape, CleanConfig(backend="torch", fused=True, max_iter=long), "cuda") is not None

    def test_device_memory_bytes(self, monkeypatch):
        monkeypatch.setenv("ICT_HBM_BYTES", "12345")
        assert autoshard.device_memory_bytes("cpu") == 12345
        monkeypatch.delenv("ICT_HBM_BYTES")
        assert autoshard.device_memory_bytes("cpu") is None

    def test_auto_routing_on_cpu_without_override_stays_in_memory(self, monkeypatch,
                                                                  capsys):
        monkeypatch.delenv("ICT_HBM_BYTES", raising=False)
        D, w0 = _cube(8, 64, 256, 5)
        res = clean_cube(D, w0, CleanConfig(backend="torch"), device="cpu")
        assert "chunked clean" not in capsys.readouterr().err
        ref = clean_cube(D, w0, CleanConfig(backend="torch", auto_shard=False), device="cpu")
        np.testing.assert_array_equal(res.test_results, ref.test_results)

    @pytest.mark.parametrize("fused", [False, True])
    def test_oversized_cube_routes_chunked_and_says_so(self, fused, monkeypatch, capsys):
        monkeypatch.setenv("ICT_HBM_BYTES", "4096")
        D, w0 = _cube(8, 64, 256, 3)
        res = clean_cube(D, w0, CleanConfig(backend="torch", max_iter=4, fused=fused),
                         device="cpu")
        err = capsys.readouterr().err
        assert err.count("chunked clean") == 1 and "exceeds device memory" in err
        assert ("fused loop runs stepwise" in err) == fused
        assert res.history and res.timed  # the stepwise chunked path ran
        oracle = jax_clean_cube(D, w0, JaxConfig(backend="numpy", max_iter=4))
        np.testing.assert_array_equal(res.weights, oracle.weights)
        assert res.loops == oracle.loops
        off = clean_cube(D, w0, CleanConfig(backend="torch", auto_shard=False), device="cpu")
        assert "chunked clean" not in capsys.readouterr().err
        np.testing.assert_array_equal(off.weights, res.weights)


class TestFlagsAndValidation:
    def test_cli_chunk_block(self, tmp_path, monkeypatch, capsys):
        monkeypatch.chdir(tmp_path)
        NpzIO().save(jax_make_archive(nsub=8, nchan=16, nbin=64, seed=91), "c.npz")
        assert cli.main(["c.npz", "--device", "cpu", "--chunk_block", "2", "-q", "-l"]) == 0
        assert "--chunk_block override; streaming 2-subint blocks" in capsys.readouterr().err
        D, w0 = jax_preprocess(jax_make_archive(nsub=8, nchan=16, nbin=64, seed=91),
                               prefer_native=False)
        oracle = jax_clean_cube(D, w0, JaxConfig(backend="numpy"))
        np.testing.assert_array_equal(NpzIO().load("c.npz_cleaned.npz").weights,
                                      oracle.weights)

    @pytest.mark.parametrize("route", [{"fused": True}, {"chunk_block": 2}])
    def test_audit_on_the_new_routes(self, route):
        ar = jax_make_archive(nsub=5, nchan=33, nbin=100, seed=3)
        cfg = CleanConfig(backend="torch", audit=True, **route)
        out = SurgicalCleaner(cfg, device="cpu").clean(ar)
        assert out.audit["mask_identical"] and out.audit["drift_within_bound"]

    def test_validation(self):
        with pytest.raises(ValueError, match="chunk_block"):
            CleanConfig(backend="numpy", chunk_block=2)
        with pytest.raises(ValueError, match="chunk_block"):
            CleanConfig(backend="torch", chunk_block=-1)
        with pytest.raises(ValueError, match="fused"):
            CleanConfig(backend="numpy", fused=True)
        D, w0 = _cube(5, 33, 100, 0)
        with pytest.raises(ValueError, match="block"):
            ChunkedTorchCleaner(D, w0, CleanConfig(backend="torch"), block=0, device="cpu")

    def test_no_card_raises_on_every_route(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present; the default device is valid here")
        D, w0 = _cube(5, 33, 100, 0)
        for cfg in (CleanConfig(backend="torch", chunk_block=2),
                    CleanConfig(backend="torch", fused=True),
                    CleanConfig(backend="torch")):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                clean_cube(D, w0, cfg)


class TestPreprocessedCube:
    """``make_preprocessed_cube``, the device-side generator of the north-star
    cube, at a small size on the CPU."""

    def test_seeded_and_shaped(self):
        a = make_preprocessed_cube(6, 32, 128, seed=4, device="cpu")
        b = make_preprocessed_cube(6, 32, 128, seed=4, device="cpu")
        c = make_preprocessed_cube(6, 32, 128, seed=5, device="cpu")
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert not torch.equal(a[0], c[0])
        D, w0 = a
        assert D.shape == (6, 32, 128) and w0.shape == (6, 32)
        assert D.dtype == w0.dtype == torch.float32 and bool(torch.isfinite(D).all())
        assert 0 < int((w0 == 0).sum()) <= 2

    @pytest.mark.parametrize("route", [{}, {"fused": True}, {"chunk_block": 3}])
    def test_routes_match_the_oracle(self, route):
        D, w0 = (t.numpy() for t in make_preprocessed_cube(8, 64, 256, seed=2, device="cpu"))
        port = clean_cube(D, w0, CleanConfig(backend="torch", **route), device="cpu")
        oracle = jax_clean_cube(D, w0, JaxConfig(backend="numpy"))
        np.testing.assert_array_equal(port.weights, oracle.weights)
        assert (port.loops, port.converged) == (oracle.loops, oracle.converged)
        # The injected bad subint or channel and the spikes get zapped.
        assert int((port.weights == 0).sum()) > int((w0 == 0).sum())
