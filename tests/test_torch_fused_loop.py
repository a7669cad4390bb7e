"""The port's fused loop and warm-up against the JAX package, on the CPU.

The same seeded cubes go through JAX ``run_fused`` (the Pallas kernel in
interpret mode where ``pallas=True``, as tests/test_pallas.py runs it) and
the port's ``run_fused`` on ``device="cpu"`` (where a forced kernel runs its
plain version): masks, ``loops``, ``converged``, the iteration count and the
history prefix must be identical, scores within the documented 5e-5
envelope (unit-floored relative drift).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from iterative_cleaner_tpu.backends.jax_backend import run_fused as jax_run_fused
from iterative_cleaner_tpu.config import CleanConfig as JaxConfig
from iterative_cleaner_tpu.core.cleaner import LoopState as JaxLoopState
from iterative_cleaner_tpu.core.cleaner import clean_cube as jax_clean_cube
from iterative_cleaner_tpu.io.synthetic import make_archive as jax_make_archive
from iterative_cleaner_tpu.ops.preprocess import preprocess as jax_preprocess
from iterative_cleaner_tpu_torch import cli
from iterative_cleaner_tpu_torch.backends import torch_backend
from iterative_cleaner_tpu_torch.backends.torch_backend import (
    precompile_for,
    run_fused,
    start_precompile,
)
from iterative_cleaner_tpu_torch.config import CleanConfig
from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
from iterative_cleaner_tpu_torch.driver import run
from iterative_cleaner_tpu_torch.io.npz import NpzIO

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


def _same_fused(port, ref):
    """(test, weights, loops, converged, iters, history[, residual])."""
    np.testing.assert_array_equal(port[1], ref[1])
    assert port[2:5] == tuple(ref[2:5])
    assert port[5].shape == ref[5].shape
    np.testing.assert_array_equal(port[5], ref[5])
    assert _drift(port[0], ref[0]) <= DRIFT_BOUND


def _pair(D, w0, *, kernel=True, incremental=True, max_iter=5, want_residual=False):
    port = run_fused(D, w0, CleanConfig(backend="torch", kernel=kernel, max_iter=max_iter,
                                        incremental_template=incremental),
                     want_residual=want_residual, device="cpu")
    ref = jax_run_fused(D, w0, JaxConfig(backend="jax", fused=True, pallas=kernel,
                                         max_iter=max_iter, incremental_template=incremental),
                        want_residual=want_residual)
    return port, ref


class TestRunFused:
    @pytest.mark.parametrize("shape", SHAPES)
    @pytest.mark.parametrize("seed", SEEDS)
    def test_matches_jax_and_oracle(self, seed, shape):
        D, w0 = _cube(*shape, seed)
        port, ref = _pair(D, w0)
        _same_fused(port, ref)
        oracle = jax_clean_cube(D, w0, JaxConfig(backend="numpy"))
        np.testing.assert_array_equal(port[1], oracle.weights)
        assert (port[2], port[3]) == (oracle.loops, oracle.converged)
        assert _drift(port[0], oracle.test_results) <= DRIFT_BOUND

    @pytest.mark.parametrize("kernel,incremental", [(True, False), (False, True),
                                                    (False, False)])
    @pytest.mark.parametrize("seed", [0, 11, 42])
    def test_kernel_and_incremental_variants(self, seed, kernel, incremental):
        D, w0 = _cube(8, 64, 256, seed)
        _same_fused(*_pair(D, w0, kernel=kernel, incremental=incremental))

    @pytest.mark.parametrize("shape", SHAPES)
    def test_want_residual(self, shape):
        D, w0 = _cube(*shape, 7)
        port, ref = _pair(D, w0, kernel=False, want_residual=True)
        _same_fused(port[:6], ref[:6])
        assert port[6].shape == D.shape
        np.testing.assert_allclose(port[6], ref[6], rtol=1e-5, atol=1e-4)

    def test_kernel_with_residual_raises(self):
        D, w0 = _cube(5, 33, 100, 0)
        Dt, wt = torch.from_numpy(D.copy()), torch.from_numpy(w0.copy())
        with pytest.raises(ValueError, match="residual"):
            torch_backend.fused_clean(Dt, wt, wt != 0, 5.0, 5.0, max_iter=3,
                                      pulse_region=(0.0, 0.0, 1.0), want_residual=True,
                                      use_kernel=True)

    @pytest.mark.parametrize("seed", [3, 42])
    def test_max_iter_stop(self, seed):
        D, w0 = _cube(8, 64, 256, seed)
        port, ref = _pair(D, w0, max_iter=1)
        _same_fused(port, ref)
        assert port[2:5] == (1, False, 1)

    def test_accepts_device_tensors(self):
        """``fused_clean`` on tensors already on the device (how a timing
        loop keeps the upload out) gives ``run_fused``'s result."""
        D, w0 = _cube(5, 33, 100, 5)
        cfg = CleanConfig(backend="torch")
        a = run_fused(D, w0, cfg, device="cpu")
        Dt, wt = torch.from_numpy(D.copy()), torch.from_numpy(w0.copy())
        test, w, loops, done, x, _r, history = torch_backend.fused_clean(
            Dt, wt, wt != 0, cfg.chanthresh, cfg.subintthresh, max_iter=cfg.max_iter,
            pulse_region=tuple(cfg.pulse_region), incremental=cfg.incremental_template)
        b = (test.numpy(), w.numpy(), loops, done, x, history[: x + 1].numpy())
        _same_fused(a, b)


class TestFusedRoute:
    @pytest.mark.parametrize("seed", [0, 5, 42])
    def test_clean_cube_fused_equals_stepwise(self, seed):
        D, w0 = _cube(8, 64, 256, seed)
        lines = []
        fused = clean_cube(D, w0, CleanConfig(backend="torch", fused=True),
                           progress=lines.append, device="cpu")
        step = clean_cube(D, w0, CleanConfig(backend="torch"), device="cpu")
        np.testing.assert_array_equal(fused.weights, step.weights)
        assert (fused.loops, fused.converged, fused.termination) == (
            step.loops, step.converged, step.termination)
        assert len(fused.history) == len(step.history) == fused.loops + 1
        for a, b in zip(fused.history, step.history):
            np.testing.assert_array_equal(a, b)
        assert [i.diff_weights for i in fused.iterations] == [
            i.diff_weights for i in step.iterations]
        assert [i.index for i in lines] == list(range(1, fused.loops + 1))
        assert not fused.timed and all(i.duration_s == 0 for i in fused.iterations)
        jres = jax_clean_cube(D, w0, JaxConfig(backend="jax", fused=True))
        assert fused.termination == jres.termination

    def test_fused_residual_route(self):
        D, w0 = _cube(5, 33, 100, 7)
        port = clean_cube(D, w0, CleanConfig(backend="torch", fused=True), device="cpu",
                          want_residual=True)
        ref = jax_clean_cube(D, w0, JaxConfig(backend="jax", fused=True), want_residual=True)
        np.testing.assert_array_equal(port.weights, ref.weights)
        np.testing.assert_allclose(port.residual, ref.residual, rtol=1e-5, atol=1e-4)

    def test_forced_oscillation_terminates_as_cycle(self, monkeypatch):
        """A step that alternates between two masks must stop on the
        repeat of the older one, as the stepwise loop (and the JAX one)
        does: termination ``cycle``."""
        D, w0 = _cube(5, 33, 100, 0)
        a = w0.copy()
        a[0, 0] = 0
        b = w0.copy()
        b[1, 2] = 0
        script = [a, b, a, b, a]
        calls = {"n": 0}

        def scripted(D, w0, valid, template, *args, **kw):
            m = torch.from_numpy(script[calls["n"]].copy())
            calls["n"] += 1
            return torch.zeros_like(m), m, None

        monkeypatch.setattr(torch_backend, "step_from_template", scripted)
        res = clean_cube(D, w0, CleanConfig(backend="torch", fused=True, max_iter=5),
                         device="cpu")

        class Scripted:
            masks = list(script)

            def step(self, w_prev):
                m = self.masks.pop(0)
                return np.zeros_like(m), m

        ref = JaxLoopState.start(w0)
        ref.run(Scripted(), 5)
        assert (res.loops, res.converged, res.termination) == (ref.loops, ref.converged,
                                                               ref.termination)
        assert res.termination == "cycle" and res.loops == 3
        assert len(res.history) == len(ref.history) == 4

    def test_cli_fused_flag_and_empty_iteration_times(self, tmp_path, monkeypatch):
        NpzIO().save(jax_make_archive(nsub=8, nchan=64, nbin=256, seed=42),
                     str(tmp_path / "a.npz"))
        monkeypatch.chdir(tmp_path)
        assert cli.main(["a.npz", "--device", "cpu", "-q", "-l", "--fused",
                         "--dump_masks"]) == 0
        served = NpzIO().load("a.npz_cleaned.npz").weights
        oracle = jax_clean_cube(*_cube(8, 64, 256, 42), JaxConfig(backend="numpy"))
        np.testing.assert_array_equal(served, oracle.weights)
        with np.load("a.npz_cleaned.npz_masks.npz") as z:
            assert z["history"].shape == (3, 8, 64) and int(z["loops"]) == 2
        reports = run(["a.npz"], CleanConfig(backend="torch", fused=True, quiet=True,
                                             no_log=True), device="cpu")
        assert reports[0].error is None and reports[0].iteration_s == []
        assert reports[0].loops == 2


class TestSparseTemplate:
    @pytest.mark.parametrize("nflip,poison", [(0, False), (3, False), (40, False),
                                              (600, False), (3, True)])
    def test_matches_jax_incremental_template(self, nflip, poison):
        """The sync-free sparse candidate (with its dense fallback) equals
        the JAX package's ``_incremental_template`` under and over the
        512-profile budget and with a non-finite profile flipping."""
        from iterative_cleaner_tpu.backends.jax_backend import _incremental_template

        D, w0 = _cube(8, 128, 64, 3)
        D = np.array(D)
        rng = np.random.default_rng(nflip)
        new_w = w0.copy().reshape(-1)
        flips = rng.choice(new_w.size, size=nflip, replace=False)
        new_w[flips] = 0.0
        new_w = new_w.reshape(w0.shape)
        if poison:
            s, c = np.unravel_index(flips[0], w0.shape)
            D[s, c, 7] = np.inf
        Dt, wt, nt = (torch.from_numpy(a.copy()) for a in (D, w0, new_w))
        T = torch_backend.build_template(Dt, wt)
        got = torch_backend.incremental_template(Dt, T, wt, nt).numpy()
        want = np.asarray(_incremental_template(D, T.numpy(), w0, new_w))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
        _cand, ok = torch_backend.sparse_template_candidate(Dt, T, wt, nt)
        assert bool(ok) == (nflip <= 512 and not poison)
        if not bool(ok):  # the dense rebuild, exactly
            np.testing.assert_array_equal(got, torch_backend.build_template(Dt, nt).numpy())


class TestWarmup:
    @pytest.mark.parametrize("fused,incremental,want_residual", [
        (True, True, False), (False, True, False), (False, False, False),
        (True, False, True)])
    def test_precompile_for_runs_each_route(self, fused, incremental, want_residual):
        cfg = CleanConfig(backend="torch", fused=fused, incremental_template=incremental)
        precompile_for((4, 16, 64), cfg, want_residual=want_residual, device="cpu")

    @pytest.mark.parametrize("cfg,device,env", [
        (CleanConfig(backend="numpy"), "cuda", {}),
        (CleanConfig(backend="torch"), "cpu", {}),
        (CleanConfig(backend="torch", chunk_block=2), "cuda", {}),
        (CleanConfig(backend="torch"), "cuda", {"ICT_NO_PRECOMPILE": "1"})])
    def test_start_precompile_declines(self, cfg, device, env, monkeypatch):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert start_precompile((4, 16, 64), cfg, device=device) is None

    def test_start_precompile_without_card_declines(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present; the warm-up would run")
        assert start_precompile((4, 16, 64), CleanConfig(backend="torch")) is None
