"""The fit/moments kernel's plain version against the JAX kernel, on the CPU.

``iterative_cleaner_tpu.ops.pallas_kernels.fused_fit_moments`` runs in Pallas
interpret mode, as tests/test_pallas.py runs it off the TPU;
``iterative_cleaner_tpu_torch.ops.fused_kernels.fused_fit_moments`` takes
its plain PyTorch version because the tensors lie on the CPU (the CUDA
kernel itself is held against the same plain version on the card by
chip_smoke.py).  Tolerances are test_pallas.py's: the f32 sum order differs.
Also here: the routing, and the incremental template against
``jax_backend.advance_template``.
"""

from __future__ import annotations

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterative_cleaner_tpu.backends.jax_backend import advance_template
from iterative_cleaner_tpu.io.synthetic import RFISpec
from iterative_cleaner_tpu.io.synthetic import make_archive as jax_make_archive
from iterative_cleaner_tpu.ops.pallas_kernels import fused_fit_moments as jax_fused
from iterative_cleaner_tpu.ops.preprocess import preprocess as jax_preprocess
from iterative_cleaner_tpu.ops.template import build_template as jax_build_template
from iterative_cleaner_tpu_torch.backends import torch_backend
from iterative_cleaner_tpu_torch.config import CleanConfig
from iterative_cleaner_tpu_torch.ops import cuda_build
from iterative_cleaner_tpu_torch.ops import fused_kernels as fk
from iterative_cleaner_tpu_torch.ops.template import build_template


def _cube(nsub=8, nchan=64, nbin=256, seed=42, **rfi):
    ar = jax_make_archive(nsub=nsub, nchan=nchan, nbin=nbin, seed=seed,
                          **({"rfi": RFISpec(**rfi)} if rfi else {}))
    return jax_preprocess(ar, prefer_native=False)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _both(D, w0, template, valid=None, region=(0.0, 0.0, 1.0)):
    want = jax_fused(jnp.asarray(D), jnp.asarray(template), jnp.asarray(w0),
                     None if valid is None else jnp.asarray(valid),
                     pulse_region=region, interpret=True)
    got = fk.fused_fit_moments(_t(D), _t(template), _t(w0),
                               None if valid is None else _t(valid), pulse_region=region)
    return [np.asarray(a) for a in want], [g.numpy() for g in got]


def _assert_close(want, got):
    c, m, s, p = want
    np.testing.assert_allclose(got[0], c, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1], m, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[2], s, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[3], p, rtol=1e-5, atol=1e-5)


def _template(D, w0):
    return np.asarray(jax_build_template(jnp.asarray(D), jnp.asarray(w0)))


SHAPES = [(8, 64, 256), (5, 33, 100), (8, 128, 96)]


class TestPlainMatchesJaxKernel:
    @pytest.mark.parametrize("shape", SHAPES)
    @pytest.mark.parametrize("with_valid", [False, True])
    def test_moments(self, shape, with_valid):
        D, w0 = _cube(*shape)
        valid = (w0 != 0) if with_valid else None
        want, got = _both(D, w0, _template(D, w0), valid)
        _assert_close(want, got)

    @pytest.mark.parametrize("with_valid", [False, True])
    def test_pulse_region(self, with_valid):
        D, w0 = _cube(8, 64, 256)
        valid = (w0 != 0) if with_valid else None
        want, got = _both(D, w0, _template(D, w0), valid, region=(0.25, 40.0, 90.0))
        _assert_close(want, got)

    @pytest.mark.parametrize("with_valid", [False, True])
    def test_prezapped_profiles_exact_zero(self, with_valid):
        D, w0 = _cube(8, 64, 256, seed=3, n_prezapped=6)
        zapped = w0 == 0
        assert zapped.any()
        want, got = _both(D, w0, _template(D, w0), (~zapped) if with_valid else None)
        _assert_close(want, got)
        c, m, s, p = got
        assert np.all(c[zapped] == 0.0)
        assert np.all(m[zapped] == 0.0)
        assert np.all(s[zapped] == 0.0)
        if with_valid:
            assert np.all(p[zapped] == np.float32(1e20))
        else:
            assert np.all(p[zapped] == 0.0)

    @pytest.mark.parametrize("fill", [0.0, np.nan])
    def test_degenerate_template(self, fill):
        """tt == 0 or not finite -> amp = 1: the residual is t - D."""
        D, w0 = _cube(8, 64, 256)
        t = np.full(D.shape[-1], fill, np.float32)
        want, got = _both(D, w0, t, w0 != 0)
        if fill == 0.0:
            _assert_close(want, got)
            m_ref = (-D * w0[..., None]).mean(axis=-1)
            np.testing.assert_allclose(got[1], m_ref, rtol=1e-5, atol=1e-6)
        else:
            for a, b in zip(want, got):
                np.testing.assert_array_equal(np.isnan(a), np.isnan(b))

    def test_nan_profile_propagates(self):
        D, w0 = _cube(4, 16, 64, seed=1)
        D = D.copy()
        D[1, 2, 5] = np.nan
        w0 = w0.copy()
        w0[1, 2] = 1.0
        want, got = _both(D, w0, _template(np.nan_to_num(D), w0), w0 != 0)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        assert np.isnan(got[3][1, 2])


class TestWrapper:
    def test_cpu_runs_plain_and_counts_nothing(self):
        D, w0 = _cube(4, 16, 64)
        before = fk.fused_fit_moments.launches
        out = fk.fused_fit_moments(_t(D), build_template(_t(D), _t(w0)), _t(w0))
        plain = fk.fused_fit_moments_plain(_t(D), build_template(_t(D), _t(w0)), _t(w0))
        for a, b in zip(out, plain):
            assert torch.equal(a, b)
        assert fk.fused_fit_moments.launches == before

    def test_input_checks(self):
        D = torch.zeros((2, 3, 8))
        t = torch.zeros(8)
        w = torch.zeros((2, 3))
        assert fk._check_inputs(D, t, w, w != 0) == (2, 3, 8)
        with pytest.raises(TypeError, match="float32"):
            fk._check_inputs(D.double(), t, w, None)
        with pytest.raises(ValueError, match="template"):
            fk._check_inputs(D, torch.zeros(7), w, None)
        with pytest.raises(ValueError, match="contiguous"):
            fk._check_inputs(D.transpose(0, 1).contiguous().transpose(0, 1), t,
                             torch.zeros((3, 2)).t(), None)
        with pytest.raises(TypeError, match="valid"):
            fk._check_inputs(D, t, w, w)

    def test_meta_device_refused(self):
        with pytest.raises(ValueError, match="cuda or cpu"):
            fk.fused_fit_moments(torch.zeros((2, 3, 8), device="meta"),
                                 torch.zeros(8, device="meta"),
                                 torch.zeros((2, 3), device="meta"))


class TestRouting:
    def test_auto_off_on_cpu(self):
        ok, why = fk.kernel_route_status(1024, "cpu")
        assert not ok and "cpu" in why
        assert fk.resolve_use_kernel(CleanConfig(backend="torch"), 1024, "cpu") is False

    @pytest.mark.parametrize("nbin", [3, 100, 1024, 4096, 9685])
    def test_viable_on_cuda(self, nbin):
        ok, why = fk.kernel_route_status(nbin, "cuda")
        assert ok and why.startswith("cuda:")
        assert fk.resolve_use_kernel(CleanConfig(backend="torch"), nbin, "cuda") is True

    def test_shared_memory_limit(self):
        # The widest profile a block takes: two stages of one row beside the
        # template and the bin scale.
        ok, why = fk.kernel_route_status(14513, "cuda")
        assert not ok and "shared memory" in why
        assert (fk.kernel_smem_bytes(14513, fk.MIN_STAGES, 1) > fk.SMEM_PER_BLOCK
                >= fk.kernel_smem_bytes(14512, fk.MIN_STAGES, 1))
        assert fk.kernel_route_status(14512, "cuda")[0]

    def test_forced_and_residual(self):
        on = CleanConfig(backend="torch", kernel=True)
        off = CleanConfig(backend="torch", kernel=False)
        assert fk.resolve_use_kernel(on, 256, "cpu") is True
        assert fk.resolve_use_kernel(off, 256, "cuda") is False
        assert fk.resolve_use_kernel(CleanConfig(backend="torch"), 256, "cuda",
                                     want_residual=True) is False

    def test_config_guards(self):
        with pytest.raises(ValueError, match="backend='torch'"):
            CleanConfig(backend="numpy", kernel=True)
        with pytest.raises(ValueError, match="residual"):
            CleanConfig(backend="torch", kernel=True, unload_res=True)


class TestLaunchPlan:
    """``launch_plan``: the load path, the ring, the persistent grid."""

    @pytest.mark.parametrize("nbin, offset, path", [
        (1024, 0, "aligned"),        # the main path's cube
        (100, 0, "aligned"),         # a 400-byte pitch
        (96, 0, "aligned"),
        (257, 0, "unaligned"),       # a 1028-byte pitch
        (31, 0, "unaligned"),
        (3, 0, "unaligned"),
        (64, 4, "unaligned"),        # a base off 16 bytes by 4
        (64, 8, "unaligned"),
        (64, 16, "aligned"),
    ])
    def test_path_from_base_and_pitch(self, nbin, offset, path):
        assert fk.launch_plan(40, nbin, 2, (1 << 20) + offset).path == path

    @pytest.mark.parametrize("nprof", [1, 3, 5, 40, 262144])
    @pytest.mark.parametrize("narch", [1, 3, 8])
    def test_aligned_path_has_every_archive_on_16_bytes(self, nprof, narch):
        # The archive offset is nprof * nbin floats: with the pitch on 16
        # bytes every archive's base (and every row's) is too, whatever nprof.
        base = 1 << 20
        for nbin in (4, 100, 1024):
            plan = fk.launch_plan(nprof, nbin, narch, base)
            assert plan.path == "aligned"
            assert all((base + 4 * a * nprof * nbin) % 16 == 0 for a in range(narch))

    @pytest.mark.parametrize("narch, nprof, nbin, stages, rows, blocks", [
        (1, 256 * 1024, 1024, 4, 4, 3 * 132),     # LOFAR
        (1, 32 * 1024, 1024, 4, 4, 3 * 132),      # the online slab
        (8, 256 * 1024, 1024, 4, 4, 3 * 132),     # the batch of 8
        (1, 366 * 4096, 1024, 4, 4, 3 * 132),     # a north-star chunk slab
        (1, 64 * 128, 96, 8, 4, 3 * 132),
        (1, 16 * 32, 4096, 2, 2, 2 * 132),        # stages and rows shrink with nbin
        (1, 16 * 32, 9685, 2, 1, 132),
        (2, 8 * 64, 257, 8, 4, 256),              # fewer tiles than the card holds
        (3, 5, 100, 8, 4, 6),
    ])
    def test_grid_and_stages(self, narch, nprof, nbin, stages, rows, blocks):
        plan = fk.launch_plan(nprof, nbin, narch, 0)
        assert (plan.stages, plan.rows_per_stage) == (stages, rows)
        assert plan.tiles == narch * -(-nprof // rows)
        assert plan.blocks == min(blocks, plan.tiles)
        assert plan.threads == fk.KERNEL_THREADS and plan.threads % 32 == 0
        assert plan.smem_bytes == fk.kernel_smem_bytes(nbin, stages, rows)
        # As many blocks as the SMs' shared memory holds at once: one wave.
        per_sm = -(-plan.blocks // fk.H100_SMS)
        assert per_sm * (plan.smem_bytes + fk.SMEM_RESERVED_PER_BLOCK) <= fk.SMEM_PER_SM

    def test_sms_of_the_card(self):
        assert fk.launch_plan(256 * 1024, 1024, 1, 0, sms=114).blocks == 3 * 114

    def test_shared_memory_fits_every_accepted_nbin(self):
        accepted = [n for n in range(1, 16384) if fk.kernel_route_status(n, "cuda")[0]]
        assert accepted == list(range(1, 14513))
        for nbin in accepted:
            stages, rows = fk.ring_shape(nbin)
            plan = fk.launch_plan(64, nbin, 1, 0)
            assert fk.MIN_STAGES <= stages <= fk.KERNEL_MAX_STAGES
            assert 1 <= rows <= fk.KERNEL_CONSUMER_WARPS
            assert plan.smem_bytes <= fk.SMEM_PER_BLOCK, nbin
        assert fk.ring_shape(14513) is None
        with pytest.raises(ValueError, match="shared memory"):
            fk.launch_plan(64, 14513, 1, 0)

    def test_overrides(self):
        plan = fk.launch_plan(262144, 1024, 1, 0, stages=1, rows=4, blocks=65536,
                              path="unaligned")
        assert (plan.stages, plan.rows_per_stage, plan.blocks, plan.path) == (
            1, 4, 65536, "unaligned")
        assert fk.launch_plan(262144, 1024, 1, 0, blocks_per_sm=1).blocks == 132
        with pytest.raises(ValueError, match="shared memory"):
            fk.launch_plan(64, 4096, 1, 0, stages=8)
        for bad in ({"stages": 9}, {"stages": 0}, {"rows": 129}, {"rows": 0}):
            with pytest.raises(ValueError, match="stages"):
                fk.launch_plan(64, 64, 1, 0, **{"stages": 2, "rows": 4, **bad})

    @pytest.mark.parametrize("nprof, nbin, narch", [(0, 1024, 1), (100, 0, 1), (100, 64, 0),
                                                    (0, 0, 3)])
    def test_an_empty_cube_launches_nothing(self, nprof, nbin, narch):
        assert fk.launch_plan(nprof, nbin, narch, 0).blocks == 0

    def test_plan_for_a_tensor(self):
        D = torch.zeros(3, 5, 7, 100)
        plan = fk.plan_for(D)
        assert (plan.narch, plan.nprof, plan.nbin) == (3, 35, 100)
        assert fk.plan_for(torch.zeros(5, 7, 100)).narch == 1
        assert fk.plan_for(torch.zeros(0, 7, 100)).blocks == 0

    def test_a_plan_for_another_cube_is_refused(self):
        D, t, w = torch.zeros(2, 3, 8), torch.zeros(8), torch.ones(2, 3)
        with pytest.raises(ValueError, match="not for a cube"):
            fk.launch(fk.plan_for(torch.zeros(2, 4, 8)), D, t, w)

    def test_tile_counters_one_pair_per_stream(self, monkeypatch):
        # Launches on one stream run one after another and share a pair of
        # counters (each leaves them at 0); another stream gets its own.
        monkeypatch.setattr(fk, "_COUNTERS", {})
        dev = torch.device("cpu")
        first = fk._tile_counters(dev, 11)
        assert first.dtype == torch.int64 and first.tolist() == [0, 0]
        assert fk._tile_counters(dev, 11) is first
        assert fk._tile_counters(dev, 12) is not first

    def test_binding_matches_the_launch_signature(self):
        # bind() declares the C entry point's arguments; each must have the
        # width and kind the source gives it.
        class Fn:
            def __call__(self, *args):
                return None

        lib = type("Lib", (), {})()
        for name in ("fused_fit_moments_launch", "fused_fit_moments_error_string",
                     "fused_fit_moments_constants"):
            setattr(lib, name, Fn())
        fk.bind(lib)
        src = (cuda_build.CSRC_DIR / "fused_fit_moments.cu").read_text()
        params = re.search(r"int fused_fit_moments_launch\((.*?)\)\s*\{", src, re.S).group(1)
        want = [ctypes.c_void_p if "*" in q else
                ctypes.c_longlong if "long long" in q else ctypes.c_int
                for q in params.split(",")]
        assert lib.fused_fit_moments_launch.argtypes == want

    def test_constants_mirror_the_source(self):
        src = (cuda_build.CSRC_DIR / "fused_fit_moments.cu").read_text()
        defines = dict(re.findall(r"#define ICT_FIT_(\w+) (\d+)", src))
        assert {k: int(v) for k, v in defines.items()} == {"COPY": fk.KERNEL_COPY}
        consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
        assert consts["kConsumerWarps"] == fk.KERNEL_CONSUMER_WARPS
        assert consts["kMaxStages"] == fk.KERNEL_MAX_STAGES
        assert consts["kMaxSmemBytes"] == fk.SMEM_PER_BLOCK
        assert consts["kMaxRows"] == fk.KERNEL_MAX_ROWS
        assert consts["kBlocksPerSM"] == fk.BLOCKS_PER_SM
        assert "kHeaderBytes = 3 * kMaxStages * 8" in src
        assert fk.KERNEL_HEADER_BYTES == 3 * fk.KERNEL_MAX_STAGES * 8
        assert "kThreads = 32 * (kConsumerWarps + 1)" in src
        assert fk.KERNEL_THREADS == 32 * (fk.KERNEL_CONSUMER_WARPS + 1)


class TestIncrementalTemplate:
    """The port's incremental_template vs jax_backend.advance_template."""

    @staticmethod
    def _run(D, w_prev, new_w):
        T_prev = jax_build_template(jnp.asarray(D), jnp.asarray(w_prev))
        want = np.asarray(advance_template(jnp.asarray(D), jnp.array(T_prev),
                                           jnp.asarray(w_prev), jnp.asarray(new_w)))
        got = torch_backend.incremental_template(
            _t(D), _t(np.asarray(T_prev)), _t(w_prev), _t(new_w)).numpy()
        dense = build_template(_t(D), _t(new_w)).numpy()
        return want, got, dense

    def test_sparse_update(self):
        D, w0 = _cube(8, 64, 256, seed=5)
        new_w = w0.copy()
        rng = np.random.default_rng(0)
        flip = rng.choice(w0.size, 20, replace=False)
        new_w.reshape(-1)[flip[:15]] = 0.0
        w_prev = w0.copy()
        w_prev.reshape(-1)[flip[15:]] = 0.0   # some restored too
        want, got, dense = self._run(D, w_prev, new_w)
        scale = np.abs(dense).max()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
        np.testing.assert_allclose(got, dense, rtol=1e-5, atol=1e-5 * scale)

    def test_no_flips_keeps_template(self):
        D, w0 = _cube(4, 16, 64, seed=2)
        want, got, _ = self._run(D, w0, w0.copy())
        np.testing.assert_array_equal(got, want)

    def test_over_budget_rebuilds_densely(self):
        D, w0 = _cube(8, 128, 32, seed=4)
        assert w0.size > torch_backend.INCREMENTAL_TEMPLATE_BUDGET
        new_w = w0.copy()
        new_w.reshape(-1)[: torch_backend.INCREMENTAL_TEMPLATE_BUDGET + 20] = 0.0
        assert (new_w != w0).sum() > torch_backend.INCREMENTAL_TEMPLATE_BUDGET
        want, got, dense = self._run(D, w0, new_w)
        np.testing.assert_array_equal(got, dense)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(dense).max())

    def test_non_finite_candidate_rebuilds_densely(self):
        """An inf in profile 0 (the padded gather slots repeat it with a
        zero weight, 0*inf = NaN) makes every sparse candidate NaN; the
        dense rebuild carries the inf, as the JAX package's does."""
        D, w0 = _cube(4, 16, 64, seed=6)
        D = D.copy()
        D[0, 0, 7] = np.inf
        w0 = w0.copy()
        w0[0, 0] = 1.0
        new_w = w0.copy()
        new_w[2, 3] = 0.0
        want, got, dense = self._run(D, w0, new_w)
        assert np.isinf(got[7]) and not np.isnan(got).any()
        np.testing.assert_array_equal(got, dense)
        fin = np.isfinite(want)
        np.testing.assert_array_equal(fin, np.isfinite(got))
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5,
                                   atol=1e-5 * np.abs(dense[fin]).max())
