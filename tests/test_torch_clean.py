"""The port's whole slice against the JAX package, on the CPU.

The same seeded inputs go through ``iterative_cleaner_tpu`` (the jax backend
and the numpy oracle) and ``iterative_cleaner_tpu_torch`` (torch on
``device="cpu"``, and its copy of the oracle): masks, ``loops`` and
``converged`` must be identical, scores within the documented 5e-5 envelope
(unit-floored relative drift, as obs/audit.py measures it).  Also: the CLI,
config and state transfer, synthetic data and preprocessing, the no-hidden-
device rule, and import hygiene.
"""

from __future__ import annotations

import ast
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from iterative_cleaner_tpu.cli import main as jax_main
from iterative_cleaner_tpu.config import CleanConfig as JaxConfig
from iterative_cleaner_tpu.core.cleaner import LoopState as JaxLoopState
from iterative_cleaner_tpu.core.cleaner import clean_cube as jax_clean_cube
from iterative_cleaner_tpu.core.cleaner import find_bad_parts as jax_find_bad_parts
from iterative_cleaner_tpu.io.npz import NpzIO as JaxNpzIO
from iterative_cleaner_tpu.io.synthetic import RFISpec as JaxRFISpec
from iterative_cleaner_tpu.io.synthetic import make_archive as jax_make_archive
from iterative_cleaner_tpu.models.surgical import SurgicalCleaner as JaxSurgical
from iterative_cleaner_tpu.ops.preprocess import preprocess as jax_preprocess
from iterative_cleaner_tpu_torch import cli
from iterative_cleaner_tpu_torch.backends import torch_backend
from iterative_cleaner_tpu_torch.backends.numpy_backend import NumpyCleaner
from iterative_cleaner_tpu_torch.config import CleanConfig
from iterative_cleaner_tpu_torch.convert import config_from_jax, state_from_numpy
from iterative_cleaner_tpu_torch.core.cleaner import LoopState, clean_cube, find_bad_parts
from iterative_cleaner_tpu_torch.driver import output_name, residual_name, run
from iterative_cleaner_tpu_torch.io.base import get_io
from iterative_cleaner_tpu_torch.io.npz import NpzIO
from iterative_cleaner_tpu_torch.io.synthetic import RFISpec, make_archive
from iterative_cleaner_tpu_torch.models.surgical import SurgicalCleaner
from iterative_cleaner_tpu_torch.ops.preprocess import preprocess

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "iterative_cleaner_tpu_torch"
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


def _same_clean(a, b):
    np.testing.assert_array_equal(a.weights, b.weights)
    assert a.loops == b.loops
    assert a.converged == b.converged
    assert len(a.history) == len(b.history)
    for x, y in zip(a.history, b.history):
        np.testing.assert_array_equal(x, y)


class TestWholeSlice:
    @pytest.mark.parametrize("shape", SHAPES)
    @pytest.mark.parametrize("seed", SEEDS)
    def test_masks_match_jax_and_oracle(self, seed, shape):
        D, w0 = _cube(*shape, seed)
        port = clean_cube(D, w0, CleanConfig(backend="torch"), device="cpu")
        jres = jax_clean_cube(D, w0, JaxConfig(backend="jax"))
        oracle = jax_clean_cube(D, w0, JaxConfig(backend="numpy"))
        _same_clean(port, jres)
        _same_clean(port, oracle)
        assert _drift(port.test_results, jres.test_results) <= DRIFT_BOUND
        assert _drift(port.test_results, oracle.test_results) <= DRIFT_BOUND

    @pytest.mark.parametrize("seed", [0, 11, 42])
    def test_kernel_forced_on_cpu_runs_plain_version(self, seed):
        D, w0 = _cube(8, 64, 256, seed)
        port = clean_cube(D, w0, CleanConfig(backend="torch", kernel=True), device="cpu")
        oracle = jax_clean_cube(D, w0, JaxConfig(backend="numpy"))
        _same_clean(port, oracle)
        assert _drift(port.test_results, oracle.test_results) <= DRIFT_BOUND

    @pytest.mark.parametrize("seed", [3, 42])
    def test_dense_template_route(self, seed):
        D, w0 = _cube(8, 64, 256, seed)
        port = clean_cube(D, w0, CleanConfig(backend="torch", incremental_template=False),
                          device="cpu")
        oracle = jax_clean_cube(D, w0, JaxConfig(backend="numpy"))
        _same_clean(port, oracle)

    def test_seed42_reference_numbers(self):
        D, w0 = _cube(8, 64, 256, 42)
        res = clean_cube(D, w0, CleanConfig(backend="torch"), device="cpu")
        assert res.loops == 2 and res.converged and res.termination == "fixed_point"
        assert int((res.weights == 0).sum()) == 76   # 74 zapped + 2 pre-zapped
        assert res.timed and len(res.iterations) == 2

    @pytest.mark.parametrize("region", [(0.25, 40.0, 90.0), (0.0, 100.0, 140.0)])
    def test_pulse_region(self, region):
        D, w0 = _cube(8, 64, 256, 5)
        port = clean_cube(D, w0, CleanConfig(backend="torch", pulse_region=region),
                          device="cpu")
        oracle = jax_clean_cube(D, w0, JaxConfig(backend="numpy", pulse_region=region))
        _same_clean(port, oracle)

    def test_heavy_rfi_and_prezapped(self):
        ar = jax_make_archive(nsub=8, nchan=64, nbin=256, seed=11, rfi=JaxRFISpec(
            n_profile_spikes=6, n_dc_profiles=3, n_bad_channels=2, n_bad_subints=1,
            n_prezapped=4))
        D, w0 = jax_preprocess(ar, prefer_native=False)
        port = clean_cube(D, w0, CleanConfig(backend="torch", max_iter=5), device="cpu")
        oracle = jax_clean_cube(D, w0, JaxConfig(backend="numpy", max_iter=5))
        _same_clean(port, oracle)

    def test_residual_matches_jax(self):
        D, w0 = _cube(5, 33, 100, 7)
        port = clean_cube(D, w0, CleanConfig(backend="torch"), device="cpu",
                          want_residual=True)
        jres = jax_clean_cube(D, w0, JaxConfig(backend="jax"), want_residual=True)
        _same_clean(port, jres)
        np.testing.assert_allclose(port.residual, jres.residual, rtol=1e-5, atol=1e-4)

    def test_parity_domain_warnings(self):
        D, w0 = _cube(3, 8, 2, 0)
        with pytest.warns(UserWarning, match="below 3"):
            clean_cube(D, w0, CleanConfig(backend="torch"), device="cpu")
        D, w0 = _cube(3, 8, 16, 0)
        D = D * np.float32(1e18)
        with pytest.warns(UserWarning, match="dynamic"):
            clean_cube(D, w0, CleanConfig(backend="torch"), device="cpu")

    @pytest.mark.parametrize("seed", [0, 5])
    def test_numpy_oracle_copy_is_bitwise(self, seed):
        D, w0 = _cube(8, 64, 256, seed)
        port = clean_cube(D, w0, CleanConfig(backend="numpy"))
        oracle = jax_clean_cube(D, w0, JaxConfig(backend="numpy"))
        _same_clean(port, oracle)
        np.testing.assert_array_equal(port.test_results, oracle.test_results)


class TestLoopAndSweep:
    class _Scripted:
        def __init__(self, masks):
            self.masks = list(masks)

        def step(self, w_prev):
            m = self.masks.pop(0)
            return np.zeros_like(m), m

        def residual(self):
            return None

    @pytest.mark.parametrize("script", ["fixed", "cycle", "max_iter"])
    def test_cycle_detection_matches_jax(self, script):
        w0 = np.ones((2, 3), np.float32)
        a = w0.copy()
        a[0, 0] = 0
        b = w0.copy()
        b[1, 2] = 0
        c = a * b
        masks = {"fixed": [a, a],
                 "cycle": [a, b, w0],          # back to the pre-loop weights
                 "max_iter": [a, b, c, w0 * 0]}[script]
        mine, ref = LoopState.start(w0), JaxLoopState.start(w0)
        mine.run(self._Scripted(masks), 4)
        ref.run(self._Scripted(masks), 4)
        assert (mine.loops, mine.converged, mine.termination) == (
            ref.loops, ref.converged, ref.termination)
        assert len(mine.history) == len(ref.history)

    @pytest.mark.parametrize("bad_chan,bad_subint", [(0.1, 1.0), (1.0, 0.05), (0.2, 0.2)])
    def test_find_bad_parts(self, bad_chan, bad_subint):
        rng = np.random.default_rng(3)
        w = (rng.random((8, 16)) > 0.15).astype(np.float32)
        got = find_bad_parts(w, CleanConfig(bad_chan=bad_chan, bad_subint=bad_subint))
        want = jax_find_bad_parts(w, JaxConfig(bad_chan=bad_chan, bad_subint=bad_subint))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


class TestSurgical:
    def test_audit_and_residual(self):
        ar = make_archive(nsub=5, nchan=33, nbin=100, seed=3)
        cfg = CleanConfig(backend="torch", audit=True, unload_res=True)
        out = SurgicalCleaner(cfg, device="cpu").clean(ar)
        assert out.audit["mask_identical"] and out.audit["n_mask_diffs"] == 0
        assert out.audit["max_score_drift"] <= DRIFT_BOUND
        ref = JaxSurgical(JaxConfig(backend="jax", unload_res=True)).clean(ar)
        np.testing.assert_array_equal(out.cleaned.weights, ref.cleaned.weights)
        np.testing.assert_allclose(out.residual.data, ref.residual.data, rtol=1e-5, atol=1e-4)

    def test_output_policy_pscrunch_and_bad_parts(self):
        ar = make_archive(nsub=6, nchan=16, nbin=64, npol=2, seed=9)
        cfg = CleanConfig(backend="torch", pscrunch=True, bad_chan=0.3, bad_subint=0.3)
        out = SurgicalCleaner(cfg, device="cpu").clean(ar)
        ref = JaxSurgical(JaxConfig(backend="numpy", pscrunch=True, bad_chan=0.3,
                                    bad_subint=0.3)).clean(ar)
        assert out.cleaned.data.shape == ref.cleaned.data.shape == (6, 1, 16, 64)
        np.testing.assert_array_equal(out.cleaned.data, ref.cleaned.data)
        np.testing.assert_array_equal(out.cleaned.weights, ref.cleaned.weights)
        assert (out.n_bad_subints, out.n_bad_channels) == (ref.n_bad_subints,
                                                           ref.n_bad_channels)


class TestCLI:
    def test_cli_matches_jax_cli_numpy(self, tmp_path, monkeypatch):
        ar = jax_make_archive(nsub=8, nchan=64, nbin=256, seed=42)
        for sub in ("port", "jax"):
            (tmp_path / sub).mkdir()
            JaxNpzIO().save(ar, str(tmp_path / sub / "obs.npz"))
        monkeypatch.chdir(tmp_path / "port")
        assert cli.main(["obs.npz", "--device", "cpu", "-q", "--dump_masks"]) == 0
        monkeypatch.chdir(tmp_path / "jax")
        assert jax_main(["obs.npz", "--backend", "numpy", "-q"]) == 0
        got = NpzIO().load(str(tmp_path / "port" / "obs.npz_cleaned.npz"))
        want = JaxNpzIO().load(str(tmp_path / "jax" / "obs.npz_cleaned.npz"))
        np.testing.assert_array_equal(got.weights, want.weights)
        np.testing.assert_array_equal(got.data, want.data)
        log = (tmp_path / "port" / "clean.log").read_text()
        assert "Cleaned obs.npz with Namespace(archive=['obs.npz']" in log
        assert "backend='torch'" in log and log.rstrip().endswith("required loops=2")
        with np.load(tmp_path / "port" / "obs.npz_cleaned.npz_masks.npz") as z:
            assert z["history"].shape == (3, 8, 64) and int(z["loops"]) == 2

    def test_cli_prints_reference_strings(self, tmp_path, monkeypatch, capsys):
        NpzIO().save(make_archive(seed=42), str(tmp_path / "a.npz"))
        monkeypatch.chdir(tmp_path)
        assert cli.main(["a.npz", "--device", "cpu", "--backend", "numpy"]) == 0
        out = capsys.readouterr().out
        for s in ("Total number of profiles: 512", "Loop: 1",
                  "Differences to previous weights: 74  RFI fraction: 0.1484375",
                  "RFI removal stops after 2 loops.", "Cleaned archive: a.npz_cleaned.npz"):
            assert s in out

    def test_cli_failure_isolation(self, tmp_path, monkeypatch, capsys):
        NpzIO().save(make_archive(nsub=4, nchan=16, nbin=64, seed=1), str(tmp_path / "a.npz"))
        monkeypatch.chdir(tmp_path)
        assert cli.main(["missing.npz", "a.npz", "--device", "cpu", "-q", "-l"]) == 1
        assert "ERROR cleaning missing.npz" in capsys.readouterr().err
        assert os.path.exists("a.npz_cleaned.npz") and not os.path.exists("clean.log")
        reports = run(["a.npz", "missing.npz"], CleanConfig(backend="torch", quiet=True),
                      device="cpu")
        assert reports[0].error is None and reports[0].loops >= 1
        assert reports[1].error and reports[1].out_path is None

    @pytest.mark.parametrize("flag", ["-z", "--x64"])
    def test_unported_flags_rejected(self, flag):
        with pytest.raises(SystemExit):
            cli.build_parser().parse_args(["a.npz", flag])

    @pytest.mark.parametrize("argv,field,value", [
        (["--fused"], "fused", True), (["--chunk_block", "4"], "chunk_block", 4),
        (["--no_auto_shard"], "auto_shard", False),
        (["--no_incremental_template"], "incremental_template", False),
        (["--sharded_batch"], "sharded_batch", True),
        (["--sharded_batch", "--stream"], "stream", True),
        (["--resume"], "resume", True)])
    def test_ported_flags_parse(self, argv, field, value):
        args = cli.build_parser().parse_args(["a.npz", *argv])
        cfg = cli.config_from_args(args)
        assert getattr(cfg, field) == value
        assert getattr(cli.config_from_args(cli.build_parser().parse_args(["a.npz"])),
                       field) != value

    def test_naming(self):
        ar = make_archive(seed=0)
        assert output_name(CleanConfig(), ar, "d/obs.npz") == "d/obs.npz_cleaned.npz"
        mjd = 0.5 * (ar.mjd_start + ar.mjd_end)
        assert output_name(CleanConfig(output="std"), ar, "x.npz") == \
            "%s.%.3f.%f.npz" % (ar.source, 149.0, mjd)
        assert residual_name("obs.npz", 3) == "obs.npz_residual_3.npz"


class TestConfigAndState:
    def test_config_from_jax_defaults_round_trip(self):
        assert config_from_jax(dataclasses.asdict(JaxConfig())) == CleanConfig()

    def test_config_from_jax_maps_backend_and_kernel(self):
        jc = JaxConfig(backend="jax", pallas=False, chanthresh=4.0, max_iter=3,
                       pulse_region=(0.5, 10, 20), incremental_template=False)
        got = config_from_jax(dataclasses.asdict(jc))
        assert got == CleanConfig(backend="torch", kernel=False, chanthresh=4.0,
                                  max_iter=3, pulse_region=(0.5, 10.0, 20.0),
                                  incremental_template=False)

    @pytest.mark.parametrize("field,value", [("x64", True), ("print_zap", True)])
    def test_unported_options_raise(self, field, value):
        fields = dataclasses.asdict(JaxConfig(backend="jax"))
        fields[field] = value
        with pytest.raises(ValueError, match="not yet ported"):
            config_from_jax(fields)

    def test_trace_dir_maps_across(self):
        # The directory of a jax.profiler capture names the port's
        # torch.profiler capture.
        jc = JaxConfig(backend="jax", trace_dir="t")
        assert config_from_jax(dataclasses.asdict(jc)) == CleanConfig(
            backend="torch", trace_dir="t")

    @pytest.mark.parametrize("field,value", [("fused", True), ("chunk_block", 3),
                                             ("auto_shard", False), ("sharded_batch", True),
                                             ("resume", True)])
    def test_ported_options_map_across_and_run(self, field, value):
        jc = JaxConfig(backend="jax", **{field: value})
        cfg = config_from_jax(dataclasses.asdict(jc))
        assert getattr(cfg, field) == value and cfg.backend == "torch"
        D, w0 = _cube(8, 64, 256, 42)
        port = clean_cube(D, w0, cfg, device="cpu")
        _same_clean(port, jax_clean_cube(D, w0, jc))
        _same_clean(port, jax_clean_cube(D, w0, JaxConfig(backend="numpy")))

    def test_stream_rejected(self):
        # stream is a mode of the batch: without sharded_batch it is refused,
        # as in the JAX package; with it, it maps across.
        with pytest.raises(ValueError, match="only applies to sharded_batch"):
            CleanConfig(stream=True)
        jc = JaxConfig(backend="jax", sharded_batch=True, stream=True)
        assert config_from_jax(dataclasses.asdict(jc)) == CleanConfig(
            backend="torch", sharded_batch=True, stream=True)

    @pytest.mark.parametrize("kw,match", [
        ({"backend": "numpy", "sharded_batch": True}, "requires backend='torch'"),
        ({"backend": "torch", "sharded_batch": True, "chunk_block": 4}, "chunk_block"),
        ({"backend": "torch", "stream": True}, "only applies to sharded_batch")])
    def test_batch_option_rules(self, kw, match):
        with pytest.raises(ValueError, match=match):
            CleanConfig(**kw)

    def test_namespace_repr_shape(self):
        jr = JaxConfig(backend="jax").namespace_repr(["a.npz"])
        pr = CleanConfig(backend="torch").namespace_repr(["a.npz"])
        assert pr == jr.replace("'jax'", "'torch'").replace("pallas=", "kernel=")

    def test_state_from_numpy(self):
        D, w0 = _cube(5, 33, 100, 0)
        t = np.ones(100, np.float32)
        Dt, wt, vt, tt = state_from_numpy(D, w0, t, device="cpu")
        assert Dt.dtype == wt.dtype == tt.dtype == torch.float32 and vt.dtype == torch.bool
        np.testing.assert_array_equal(Dt.numpy(), D)
        np.testing.assert_array_equal(vt.numpy(), w0 != 0)
        assert state_from_numpy(D, w0, device="cpu")[3] is None


class TestDataAndIO:
    @pytest.mark.parametrize("seed,npol,dispersed", [(0, 1, True), (42, 1, True),
                                                     (7, 2, True), (5, 4, False)])
    def test_make_archive_bytes_identical(self, seed, npol, dispersed):
        kw = dict(nsub=4, nchan=16, nbin=64, npol=npol, seed=seed, dispersed=dispersed)
        a, b = make_archive(**kw), jax_make_archive(**kw)
        for f in ("data", "weights", "freqs"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
        for f in ("centre_frequency", "dm", "period", "source", "mjd_start", "mjd_end",
                  "state", "dedispersed", "filename"):
            assert getattr(a, f) == getattr(b, f)

    def test_rfispec_fields_match(self):
        assert dataclasses.asdict(RFISpec()) == dataclasses.asdict(JaxRFISpec())

    @pytest.mark.parametrize("npol,dispersed", [(1, True), (2, True), (4, False)])
    @pytest.mark.parametrize("native", [False, True])
    def test_preprocess_bitwise(self, npol, dispersed, native):
        ar = make_archive(nsub=4, nchan=16, nbin=64, npol=npol, seed=2, dispersed=dispersed)
        D, w0 = preprocess(ar)
        Dj, wj = jax_preprocess(ar, prefer_native=native)
        assert D.tobytes() == Dj.tobytes() and w0.tobytes() == wj.tobytes()

    def test_npz_cross_package(self, tmp_path):
        ar = make_archive(nsub=3, nchan=8, nbin=32, seed=4)
        NpzIO().save(ar, str(tmp_path / "p.npz"))
        back = JaxNpzIO().load(str(tmp_path / "p.npz"))
        assert back.data.tobytes() == ar.data.tobytes() and back.source == ar.source

    @pytest.mark.parametrize("path", ["x.ar", "x.fits"])
    def test_unported_formats_raise(self, path):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            get_io(path).load(path)


class TestNoHiddenDevice:
    @pytest.fixture(autouse=True)
    def _no_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present; the default device is valid here")

    def test_torch_cleaner_default_raises(self):
        D, w0 = _cube(5, 33, 100, 0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            torch_backend.TorchCleaner(D, w0, CleanConfig(backend="torch"))

    def test_clean_cube_default_raises(self):
        D, w0 = _cube(5, 33, 100, 0)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            clean_cube(D, w0, CleanConfig(backend="torch"))

    def test_surgical_default_raises(self):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SurgicalCleaner(CleanConfig(backend="torch")).clean(
                make_archive(nsub=3, nchan=8, nbin=32))

    def test_cli_default_device_fails(self, tmp_path, monkeypatch, capsys):
        NpzIO().save(make_archive(nsub=3, nchan=8, nbin=32), str(tmp_path / "a.npz"))
        monkeypatch.chdir(tmp_path)
        assert cli.main(["a.npz", "-q"]) == 1
        assert "no CUDA device" in capsys.readouterr().err
        assert not os.path.exists("a.npz_cleaned.npz")

    def test_numpy_backend_needs_no_device(self):
        D, w0 = _cube(5, 33, 100, 0)
        assert isinstance(clean_cube(D, w0, CleanConfig(backend="numpy")).loops, int)
        assert NumpyCleaner(D, w0, CleanConfig()).step(w0)[1].shape == w0.shape


class TestFp32Guard:
    def test_tf32_precision_refused(self):
        prev = torch.get_float32_matmul_precision()
        try:
            torch.set_float32_matmul_precision("high")
            with pytest.raises(RuntimeError, match="float32"):
                torch_backend.check_fp32_matmul()
        finally:
            torch.set_float32_matmul_precision(prev)
        torch_backend.check_fp32_matmul()   # the default passes


def _py_files():
    # _build/ holds build outputs, never sources of the package.
    return sorted(p for p in PKG.rglob("*.py") if "_build" not in p.relative_to(PKG).parts) \
        + [REPO / "chip_smoke.py"]


class TestImportHygiene:
    @pytest.mark.parametrize("path", _py_files(), ids=lambda p: str(p.relative_to(REPO)))
    def test_no_jax_imports(self, path):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "iterative_cleaner_tpu"), \
                    f"{path.name}:{node.lineno} imports {name}"

    @staticmethod
    def _no_jax_after_importing(mods):
        """Import ``mods`` in a fresh interpreter; no module of JAX or of the
        JAX package may be in ``sys.modules`` afterwards."""
        code = ("import importlib, sys\n"
                f"for m in {mods!r}:\n    importlib.import_module(m)\n"
                "bad = [m for m in sys.modules if m.split('.')[0] in "
                "('jax', 'jaxlib', 'iterative_cleaner_tpu')]\n"
                "print(bad)\nsys.exit(1 if bad else 0)\n")
        env = dict(os.environ, PYTHONPATH=str(REPO))
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              env=env, cwd=str(REPO), timeout=120)
        assert proc.returncode == 0, proc.stdout + proc.stderr

    def test_cli_import_leaves_no_jax_in_sys_modules(self):
        # Every module of the port, the CLI's among them.
        mods = sorted(".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(
            ".__init__") for p in _py_files() if p.name not in ("chip_smoke.py", "__main__.py"))
        assert "iterative_cleaner_tpu_torch.obs.profiling" in mods
        self._no_jax_after_importing(mods)

    def test_service_import_leaves_no_jax_in_sys_modules(self):
        # The serving daemon and the native runtime alone, as ``serve``
        # imports them.
        self._no_jax_after_importing(["iterative_cleaner_tpu_torch.service.daemon",
                                      "iterative_cleaner_tpu_torch.native"])
