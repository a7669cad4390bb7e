"""The port's torch ops against their JAX twins, on the CPU.

Inputs come from numpy seeds and go through both
``iterative_cleaner_tpu.ops.*`` and ``iterative_cleaner_tpu_torch.ops.*``:

- template build and fit: rtol 1e-5 (the f32 sum order differs);
- every median selection: bit-identical, on the adversarial values of
  tests/test_selection_medians.py (NaN of both signs, ±inf, −0.0, heavy
  ties, the 1e20 fill, all-masked lines) — both sides pick exact elements;
- the scalers: bit-identical scores on the adversarial stacks, and
  identical ``>= 1`` decisions with close scores on RFI-shaped data.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterative_cleaner_tpu.io.synthetic import RFISpec
from iterative_cleaner_tpu.io.synthetic import make_archive as jax_make_archive
from iterative_cleaner_tpu.ops import masked as jmasked
from iterative_cleaner_tpu.ops import stats as jstats
from iterative_cleaner_tpu.ops import template as jtemplate
from iterative_cleaner_tpu.ops.preprocess import preprocess as jax_preprocess
from iterative_cleaner_tpu_torch.ops import masked as tmasked
from iterative_cleaner_tpu_torch.ops import stats as tstats
from iterative_cleaner_tpu_torch.ops import template as ttemplate

ADVERSARIAL = np.array(
    [np.nan, -np.nan, np.inf, -np.inf, -0.0, 0.0,
     1.0, 1.0, -1.0, 2.0, 1e20], np.float32)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _adversarial(rng, shape):
    return rng.choice(ADVERSARIAL, size=shape).astype(np.float32)


def _cube(nsub, nchan, nbin, seed, **rfi):
    ar = jax_make_archive(nsub=nsub, nchan=nchan, nbin=nbin, seed=seed,
                          **({"rfi": RFISpec(**rfi)} if rfi else {}))
    return jax_preprocess(ar, prefer_native=False)


SHAPES = [(8, 64, 256), (5, 33, 100), (8, 128, 96)]


class TestTemplate:
    @pytest.mark.parametrize("shape", SHAPES)
    def test_build_template(self, shape):
        D, w0 = _cube(*shape, seed=1)
        want = np.asarray(jtemplate.build_template(jnp.asarray(D), jnp.asarray(w0)))
        got = ttemplate.build_template(_t(D), _t(w0)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())

    @pytest.mark.parametrize("shape", SHAPES)
    @pytest.mark.parametrize("region", [(0.0, 0.0, 1.0), (0.25, 40.0, 90.0),
                                        (3.0, -20.0, 500.0)])
    def test_fit_and_subtract(self, shape, region):
        D, w0 = _cube(*shape, seed=2)
        t = np.asarray(jtemplate.build_template(jnp.asarray(D), jnp.asarray(w0)))
        amp_j, res_j = jtemplate.fit_and_subtract(jnp.asarray(D), jnp.asarray(t), region)
        amp_t, res_t = ttemplate.fit_and_subtract(_t(D), _t(t), region)
        np.testing.assert_allclose(amp_t.numpy(), np.asarray(amp_j), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(res_t.numpy(), np.asarray(res_j), rtol=1e-5, atol=1e-4)

    @pytest.mark.parametrize("fill", [0.0, np.inf, np.nan])
    def test_degenerate_template_amp_one(self, fill):
        D, _ = _cube(4, 16, 64, seed=3)
        t = np.full(D.shape[-1], fill, np.float32)
        amp_j, res_j = jtemplate.fit_and_subtract(jnp.asarray(D), jnp.asarray(t),
                                                  (0.0, 0.0, 1.0))
        amp_t, res_t = ttemplate.fit_and_subtract(_t(D), _t(t), (0.0, 0.0, 1.0))
        assert np.all(amp_t.numpy() == 1.0)
        np.testing.assert_array_equal(amp_t.numpy(), np.asarray(amp_j))
        np.testing.assert_array_equal(res_t.numpy(), np.asarray(res_j))


class TestSortPrefix:
    @pytest.mark.parametrize("seed", range(6))
    @pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 16])
    def test_adversarial_bitwise(self, seed, n):
        rng = np.random.default_rng(seed * 100 + n)
        x = _adversarial(rng, (6, n))
        k = n // 2 + 1
        want = np.asarray(jmasked.sort_prefix(jnp.asarray(x), k, mode="sort"))
        got = tmasked.sort_prefix(_t(x), k).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))

    def test_keys_order_like_jnp_sort(self):
        x = ADVERSARIAL.copy()
        keys = tmasked._totalorder_keys(_t(x)).numpy()
        want = np.asarray(jmasked._totalorder_keys(jnp.asarray(x)))
        np.testing.assert_array_equal(keys, want)


class TestMedians:
    @pytest.mark.parametrize("seed", range(4))
    @pytest.mark.parametrize("n", [1, 2, 5, 8])
    def test_masked_median_bitwise(self, seed, n):
        rng = np.random.default_rng(seed * 10 + n)
        x = _adversarial(rng, (6, n))
        valid = rng.random((6, n)) > 0.3
        valid[0, :] = False  # all-masked line -> NaN via n == 0
        m_j, n_j = jmasked.masked_median(jnp.asarray(x), jnp.asarray(valid), axis=1,
                                         mode="sort")
        m_t, n_t = tmasked.masked_median(_t(x), _t(valid), axis=1)
        np.testing.assert_array_equal(_bits(m_t.numpy()), _bits(m_j))
        np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))

    @pytest.mark.parametrize("axis", [0, 1])
    def test_masked_median_axis(self, axis):
        rng = np.random.default_rng(7)
        x = rng.normal(size=(9, 12)).astype(np.float32)
        valid = rng.random((9, 12)) > 0.4
        m_j, _ = jmasked.masked_median(jnp.asarray(x), jnp.asarray(valid), axis=axis,
                                       mode="sort")
        m_t, _ = tmasked.masked_median(_t(x), _t(valid), axis=axis)
        np.testing.assert_array_equal(_bits(m_t.numpy()), _bits(m_j))

    @pytest.mark.parametrize("seed", range(6))
    @pytest.mark.parametrize("shape,axis", [((7, 10), 0), ((7, 10), 1), ((4, 8), 1)])
    def test_nan_propagating_median_bitwise(self, seed, shape, axis):
        x = _adversarial(np.random.default_rng(seed), shape)
        want = np.asarray(jmasked.nan_propagating_median(jnp.asarray(x), axis=axis))
        got = tmasked.nan_propagating_median(_t(x), axis=axis).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))

    @pytest.mark.parametrize("seed", range(6))
    def test_median4_nonneg_bitwise(self, seed):
        pool = np.array([np.nan, np.inf, 0.0, 0.5, 1.0, 1.0, 2.0, 1e20], np.float32)
        x = np.random.default_rng(seed).choice(pool, size=(4, 11, 7)).astype(np.float32)
        want = np.asarray(jmasked.median4_nonneg(jnp.asarray(x)))
        got = tmasked.median4_nonneg(_t(x)).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))

    def test_even_count_averages(self):
        # torch.median would return the lower middle (3); np.median gives 5.
        x = _t(np.array([[9.0, 1.0, 3.0, 7.0]], np.float32))
        assert float(tmasked.nan_propagating_median(x, axis=1)[0]) == 5.0
        m, n = tmasked.masked_median(x, torch.ones_like(x, dtype=torch.bool), axis=1)
        assert float(m[0]) == 5.0 and int(n[0]) == 4


class TestScalers:
    @staticmethod
    def _stack(seed, nsub, nchan, all_masked=False):
        rng = np.random.default_rng(seed)
        stack4 = _adversarial(rng, (4, nsub, nchan))
        valid = rng.random((nsub, nchan)) > 0.25
        if all_masked:
            valid[1, :] = False
            valid[:, 2] = False
        return stack4, valid

    @pytest.mark.parametrize("seed", range(4))
    @pytest.mark.parametrize("axis", [0, 1])
    @pytest.mark.parametrize("nsub,nchan", [(9, 12), (8, 13)])
    @pytest.mark.parametrize("all_masked", [False, True])
    def test_select_medians_bitwise(self, seed, axis, nsub, nchan, all_masked):
        stack4, valid = self._stack(seed, nsub, nchan, all_masked)
        filled = np.concatenate(
            (np.where(valid[None], stack4[:3], np.inf), stack4[3:]), axis=0
        ).astype(np.float32)
        n = valid.sum(axis=axis)
        want = np.asarray(jstats._select_medians_via(
            jnp.asarray(filled), jnp.asarray(n), axis + 1, mode="sort"))
        got = tstats._select_medians_via(_t(filled), _t(n), axis + 1).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))

    @pytest.mark.parametrize("seed", range(4))
    @pytest.mark.parametrize("axis,thresh", [(0, 5.0), (1, 2.5), (0, 3.0)])
    def test_scale_axis_bitwise(self, seed, axis, thresh):
        stack4, valid = self._stack(seed, 13, 17, all_masked=seed % 2 == 1)
        want = np.asarray(jstats._scale_axis(jnp.asarray(stack4), jnp.asarray(valid),
                                             axis=axis, thresh=thresh))
        got = tstats._scale_axis(_t(stack4), _t(valid), axis=axis, thresh=thresh).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))

    @pytest.mark.parametrize("seed", [0, 3, 11, 42])
    def test_scale_and_combine_decisions(self, seed):
        """On RFI-shaped data the diagnostics differ by f32 sum order, the
        zap decisions not at all."""
        D, w0 = _cube(8, 64, 256, seed=seed, n_prezapped=4)
        t = jtemplate.build_template(jnp.asarray(D), jnp.asarray(w0))
        _amp, resid = jtemplate.fit_and_subtract(jnp.asarray(D), t, (0.0, 0.0, 1.0))
        weighted = np.asarray(resid * jnp.asarray(w0)[..., None])
        valid = w0 != 0
        jd = jstats.diagnostics(jnp.asarray(weighted), jnp.asarray(valid))
        td = tstats.diagnostics(_t(weighted), _t(valid))
        for a, b in zip(td, jd):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)
        # The same diagnostics into both scalers: bit-identical scores.
        want = np.asarray(jstats.scale_and_combine(*jd, jnp.asarray(valid), 5.0, 5.0))
        got = tstats.scale_and_combine(*(_t(np.asarray(d)) for d in jd), _t(valid),
                                       5.0, 5.0).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))
        # Each package's own diagnostics: identical decisions.
        own = tstats.comprehensive_stats(_t(weighted), _t(valid), 5.0, 5.0).numpy()
        np.testing.assert_array_equal(own >= 1, want >= 1)
        assert (want >= 1).any()

    def test_fft_diagnostic(self):
        x = np.random.default_rng(5).normal(size=(6, 10, 100)).astype(np.float32)
        want = np.asarray(jstats.fft_diagnostic(jnp.asarray(x)))
        got = tstats.fft_diagnostic(_t(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    def test_fft_diagnostic_nan_row(self):
        x = np.zeros((2, 3, 8), np.float32)
        x[1, 2, 4] = np.nan
        got = tstats.fft_diagnostic(_t(x)).numpy()
        assert np.isnan(got[1, 2]) and np.all(got[0] == 0)

    def test_true_divide_is_a_division(self):
        x = _t(np.array([1.0, 3.0, 7.0, 1e-30], np.float32))
        np.testing.assert_array_equal(tstats.true_divide(x, 3.0).numpy(),
                                      x.numpy() / np.float32(3.0))
