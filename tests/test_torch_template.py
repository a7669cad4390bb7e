"""The ordered template's launch plan and wrapper, on the CPU.

The kernel ``csrc/ordered_template.cu`` runs only on the card, where
``chip_smoke.py`` phase 3 holds it bit for bit against
``build_template_plain``.  Held here: the launch plan (the load path from
the pitch and the base, the grid, the archive strides, shared memory, empty
launches), the constants the wrapper mirrors from the source, the operand
checks, and the batched and broadcast (stride-0) templates through the
plain version — bit for bit against the port's numpy oracle, and against
the JAX package's template within float32 summation-order tolerance.
"""

from __future__ import annotations

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterative_cleaner_tpu.ops.template import build_template as jax_build_template
from iterative_cleaner_tpu_torch.backends import numpy_backend as nb
from iterative_cleaner_tpu_torch.ops import cuda_build
from iterative_cleaner_tpu_torch.ops import template as tp

#: A block's dynamic shared memory on an H100 (NVIDIA's tuning guide).
H100_SMEM_PER_BLOCK = 232448


def _cube(shape, seed):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal(shape, dtype=np.float32) * 5
    w = rng.random(shape[:-1]).astype(np.float32)
    w[rng.random(shape[:-1]) < 0.2] = 0.0
    return D, w


class TestLaunchPlan:
    @pytest.mark.parametrize("nbin, offset, d_stride, path", [
        (1024, 0, 256 * 1024, "aligned"),      # the main path's cube
        (100, 0, 33 * 100, "aligned"),         # a 400-byte pitch, a partial bin group
        (31, 0, 7 * 31, "unaligned"),          # a 124-byte pitch
        (257, 0, 64 * 257, "unaligned"),
        (64, 4, 40 * 64, "unaligned"),         # a base off 16 bytes by 4
        (64, 16, 40 * 64, "aligned"),
        (1024, 0, 0, "aligned"),               # the sweep's broadcast cube
        (64, 0, 2, "unaligned"),               # an archive stride off 16 bytes
    ])
    def test_path_from_pitch_and_base(self, nbin, offset, d_stride, path):
        plan = tp.launch_plan(40, nbin, 2, 1 << 20 | offset, d_stride, 40)
        assert plan.path == path

    @pytest.mark.parametrize("layout", ["batch", "pairs", "pairs, broadcast weights", "single",
                                        "continued"])
    def test_grid_and_archive_strides(self, layout):
        nsub, nchan, nbin = 4, 5, 100
        groups = -(-nbin // tp.TEMPLATE_BINS_PER_BLOCK)
        cube = torch.zeros(nsub, nchan, nbin)
        if layout == "batch":
            D, w = torch.zeros(3, nsub, nchan, nbin), torch.zeros(3, nsub, nchan)
            want = (3, nsub * nchan * nbin, nsub * nchan)
        elif layout.startswith("pairs"):
            D = cube.expand(9, nsub, nchan, nbin)
            w = (torch.zeros(nsub, nchan).expand(9, nsub, nchan) if "broadcast" in layout
                 else torch.zeros(9, nsub, nchan))
            want = (9, 0, 0 if "broadcast" in layout else nsub * nchan)
        elif layout == "single":
            D, w = cube, torch.zeros(nsub, nchan)
            want = (1, nsub * nchan * nbin, nsub * nchan)
        else:
            D, w = cube[1:], torch.zeros(nsub, nchan)[1:]
            want = (1, (nsub - 1) * nchan * nbin, (nsub - 1) * nchan)
        plan, wk = tp.plan_for(D, w)
        assert (plan.narch, plan.d_arch_stride, plan.w_arch_stride) == want
        assert plan.blocks == groups * plan.narch
        assert plan.nprof == (nsub - (layout == "continued")) * nchan and plan.nbin == nbin
        # The kernel reads the caller's weights where they lie: no copy.
        assert wk.data_ptr() == w.data_ptr() and wk.stride(-1) == 1
        assert wk.shape == (plan.narch, plan.nprof)

    def test_weights_with_a_strided_profile_axis_are_made_contiguous(self):
        D, w = torch.zeros(4, 5, 8), torch.zeros(5, 4).t()
        plan, wk = tp.plan_for(D, w)
        assert wk.is_contiguous() and torch.equal(wk.reshape(4, 5), w)
        assert plan.w_arch_stride == 20

    def test_shared_memory_fits_a_block(self):
        plan = tp.launch_plan(262144, 1024, 1, 0, 262144 * 1024, 262144)
        assert plan.smem_bytes == tp.TEMPLATE_SMEM_BYTES <= H100_SMEM_PER_BLOCK
        per_stage = 16 + 4 * plan.rows_per_stage * (plan.bins_per_block + 1)
        assert plan.smem_bytes == plan.stages * per_stage
        assert plan.threads == tp.TEMPLATE_THREADS and plan.threads % 32 == 0

    @pytest.mark.parametrize("nprof, nbin, narch", [(0, 1024, 1), (100, 0, 1), (100, 64, 0),
                                                    (0, 0, 3)])
    def test_an_empty_cube_launches_nothing(self, nprof, nbin, narch):
        assert tp.launch_plan(nprof, nbin, narch, 0, nprof * nbin, nprof).blocks == 0

    def test_constants_mirror_the_source(self):
        src = (cuda_build.CSRC_DIR / "ordered_template.cu").read_text()
        defaults = dict(re.findall(r"#define ICT_TEMPLATE_(\w+) (\d+)", src))
        assert {k: int(v) for k, v in defaults.items()} == {
            "BINS": tp.TEMPLATE_BINS_PER_BLOCK, "ROWS": tp.TEMPLATE_ROWS_PER_STAGE,
            "STAGES": tp.TEMPLATE_STAGES}
        warps = int(re.search(r"constexpr int kProducerWarps = (\d+);", src).group(1))
        assert tp.TEMPLATE_THREADS == 32 * (1 + warps)


class TestOperands:
    @pytest.mark.parametrize("case", ["profiles strided", "batch profiles strided", "float64",
                                      "weights elsewhere", "weights short", "init short"])
    def test_wrapper_rejects(self, case):
        D, w, init = torch.zeros(5, 4, 8), torch.zeros(5, 4), None
        err, match = ValueError, "weights must hold one value per profile on cpu"
        if case == "profiles strided":
            D, err, match = torch.zeros(4, 5, 8).transpose(0, 1), ValueError, "D must be contiguous"
        elif case == "batch profiles strided":
            D = torch.zeros(2, 4, 5, 8).transpose(1, 2)
            w, err, match = torch.zeros(2, 5, 4), ValueError, "D must be contiguous"
        elif case == "float64":
            D, err, match = D.double(), TypeError, "D must be float32"
        elif case == "weights elsewhere":
            w = torch.zeros(5, 4, device="meta")
        elif case == "weights short":
            w = torch.zeros(5, 3)
        else:
            init, match = torch.zeros(7), "init must be a contiguous float32 template"
        with pytest.raises(err, match=match):
            tp.plan_for(D, w, init)

    def test_batch_entry_wants_a_batch(self):
        with pytest.raises(ValueError, match="a batch is"):
            tp.build_templates(torch.zeros(5, 4, 8), torch.zeros(5, 4))

    def test_no_profiles_give_init_or_zeros(self):
        init = torch.arange(8, dtype=torch.float32)
        assert torch.equal(tp.build_template(torch.zeros(0, 4, 8), torch.zeros(0, 4), init=init),
                           init)
        assert torch.equal(tp.build_template(torch.zeros(0, 4, 8), torch.zeros(0, 4)),
                           torch.zeros(8))


class TestBroadcastPairs:
    """The sweep's pair axis: one cube broadcast with ``expand`` (stride 0)
    under a weight map per pair, or under one broadcast map (the first
    iteration)."""

    @pytest.mark.parametrize("shape", [(5, 33, 100), (3, 7, 31), (8, 64, 257), (4, 16, 2)])
    def test_each_pair_is_the_oracle(self, shape):
        D, _ = _cube(shape, sum(shape))
        ws = np.stack([_cube(shape, sum(shape) + 1 + j)[1] for j in range(9)])
        Dt = torch.from_numpy(D)
        got = tp.build_templates(Dt.expand(9, *shape), torch.from_numpy(ws))
        for j in range(9):
            assert np.array_equal(got[j].numpy(), nb.build_template(D, ws[j])), j
        w0 = torch.from_numpy(ws[0]).expand(9, *shape[:2])
        got0 = tp.build_templates(Dt.expand(9, *shape), w0)
        want0 = nb.build_template(D, ws[0])
        assert all(np.array_equal(t.numpy(), want0) for t in got0)

    @pytest.mark.parametrize("shape", [(5, 33, 100), (8, 64, 257)])
    def test_contiguous_batch_is_each_oracle(self, shape):
        parts = [_cube(shape, 50 + j) for j in range(3)]
        got = tp.build_templates(torch.from_numpy(np.stack([d for d, _ in parts])),
                                 torch.from_numpy(np.stack([w for _, w in parts])))
        for j, (d, w) in enumerate(parts):
            assert np.array_equal(got[j].numpy(), nb.build_template(d, w)), j

    @pytest.mark.parametrize("shape", [(5, 33, 100), (8, 64, 257), (3, 7, 31)])
    def test_against_the_jax_template(self, shape):
        # The JAX package sums in XLA's order, the port in numpy's: equal to
        # float32 rounding of a sum of nprof terms, so the tolerance is
        # relative to the sum of their magnitudes.
        D, w = _cube(shape, 7 * sum(shape))
        got = tp.build_template(torch.from_numpy(D), torch.from_numpy(w)).numpy()
        want = np.asarray(jax_build_template(jnp.asarray(D), jnp.asarray(w)))
        scale = np.abs(w[..., None] * D).sum(axis=(0, 1))
        np.testing.assert_array_less(np.abs(got - want), 1e-5 * scale + 1e-30)
