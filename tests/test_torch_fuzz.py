"""The port's fuzz and repro-replay tools on the CPU.

- ``tools_torch/fuzz_sweep.draw_case`` is the JAX test's generator copied
  into a module that imports no JAX: on 24 seeds it draws the same archive
  (data, weights, frequencies and metadata bit for bit) and the same
  keyword arguments as ``tests/test_fuzz_equivalence.draw_case``;
- the tool's modes on ``cpu`` for a few seeds, float32 and ``--x64``: every
  mask, loop count and convergence identical to the oracle; a mismatch
  writes a repro bundle and makes the tool exit 1;
- its ``sharded`` mode (one cube over 8 logical CPU devices) on the JAX
  test's seeds 12-15, against the oracle and the JAX package's
  ``sharded_clean_single`` on its 8 CPU devices;
- ``tools_torch/replay_repro.py`` on bundles the port writes: cleared
  (rc 0) when the live route agrees with the oracle, whatever the recorded
  served mask says; unusable (rc 2) for a directory that is no bundle.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from test_fuzz_equivalence import draw_case as jax_draw_case

REPO = Path(__file__).resolve().parent.parent


def _tool(name):
    spec = importlib.util.spec_from_file_location(f"tools_torch_{name}",
                                                  REPO / "tools_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


fuzz = _tool("fuzz_sweep")
replay = _tool("replay_repro")


@pytest.mark.parametrize("seed", [*range(12), *range(1000, 1012)])
def test_draw_case_is_the_jax_tests(seed):
    (ar, kw), (ref, ref_kw) = fuzz.draw_case(seed), jax_draw_case(seed)
    assert kw == ref_kw
    for f in ("data", "weights", "freqs"):
        a, b = getattr(ar, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for f in ("centre_frequency", "dm", "period", "source", "mjd_start", "mjd_end", "state",
              "dedispersed"):
        assert getattr(ar, f) == getattr(ref, f)


@pytest.mark.parametrize("x64", [False, True], ids=["f32", "x64"])
@pytest.mark.parametrize("seed", [1000, 1003])
def test_every_mode_matches_the_oracle(seed, x64):
    stats = {}
    bad, results, _inputs = fuzz.run_seed(seed, x64, "cpu", stats)
    assert bad == []
    want = {"stepwise", "stepwise_dense", "fused", "fused_dense", "chunked", "chunked_serial",
            "chunked_dense", "online"}
    if not x64:
        want |= {"kernel", "sharded", "coalesced(k=3)"}
    assert set(stats) == want
    assert all(st["drift"] < 5e-5 for st in stats.values())
    assert all(st["identical"] == st["seeds"] == 1 for st in stats.values())
    assert stats["stepwise_dense"]["sparse_seeds"] == 0


def _bundle(tmp_path, flip: bool, route="stepwise"):
    from iterative_cleaner_tpu_torch.config import CleanConfig
    from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
    from iterative_cleaner_tpu_torch.io.synthetic import make_archive
    from iterative_cleaner_tpu_torch.obs import audit
    from iterative_cleaner_tpu_torch.ops.preprocess import preprocess

    D, w0 = preprocess(make_archive(nsub=6, nchan=16, nbin=32, seed=5))
    cfg = CleanConfig(backend="torch", max_iter=3)
    served = clean_cube(D, w0, cfg.replace(backend="numpy")).weights.copy()
    if flip:
        served[2, 3] = 0.0 if served[2, 3] else 1.0
    path = audit.write_repro_bundle(str(tmp_path), D=D, w0=w0, cfg=cfg, reason="test",
                                    weights_served=served, route=route)
    assert path
    return path


@pytest.mark.parametrize("seed", range(12, 16))
def test_sharded_matches_jax_and_numpy_fuzzed(seed):
    """The fuzz's sharded mode: one cube over 8 logical CPU devices
    (``dp=4 x sp=2``) against the port's numpy oracle and the JAX package's
    ``sharded_clean_single`` on its 8 CPU devices (``dp=2 x sp=2 x tp=2``),
    masks and loop counts bit for bit, as ``tests/test_fuzz_equivalence.py``
    holds the JAX package's."""
    import jax

    from iterative_cleaner_tpu.config import CleanConfig as JaxConfig
    from iterative_cleaner_tpu.ops.preprocess import preprocess as jax_preprocess
    from iterative_cleaner_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from iterative_cleaner_tpu.parallel.sharded import sharded_clean_single as jax_sharded
    from iterative_cleaner_tpu_torch.config import CleanConfig
    from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
    from iterative_cleaner_tpu_torch.ops.preprocess import preprocess
    from iterative_cleaner_tpu_torch.parallel.mesh import make_mesh
    from iterative_cleaner_tpu_torch.parallel.sharded import sharded_clean_single

    archive, kw = fuzz.draw_case(seed)
    D, w0 = preprocess(archive)
    ora = clean_cube(D, w0, CleanConfig(backend="numpy", **kw))
    mesh = make_mesh(8, devices=["cpu"] * 8)
    assert mesh.shape == {"dp": 4, "sp": 2, "tp": 1}
    _t, w, loops, done = sharded_clean_single(D, w0, CleanConfig(backend="torch", **kw), mesh)
    assert w.tobytes() == ora.weights.tobytes()
    assert (loops, done) == (ora.loops, ora.converged)

    jax_archive, jax_kw = jax_draw_case(seed)
    Dj, w0j = jax_preprocess(jax_archive)
    _tj, wj, loops_j, done_j = jax_sharded(
        Dj, w0j, JaxConfig(backend="jax", **jax_kw), jax_make_mesh(8, devices=jax.devices("cpu")))
    assert w.tobytes() == np.asarray(wj).tobytes()
    assert (loops, done) == (loops_j, done_j)


@pytest.mark.parametrize("route", ["stepwise", "coalesced(k=3)", "sharded"])
def test_replay_clears_a_transient_divergence(tmp_path, capsys, route):
    rc = replay.main([_bundle(tmp_path, flip=True, route=route), "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["repro"] == "cleared"
    assert out["recorded_mask_matches_oracle"] is False and out["n_recorded_diffs"] == 1
    assert out["live_mask_identical"] is True
    assert ("sharded" in out["live_diffs_by_route"]) == (route != "stepwise")


def test_replay_of_an_unusable_bundle_is_rc_2(tmp_path, capsys):
    (tmp_path / "junk").mkdir()
    assert replay.main([str(tmp_path / "junk"), "--device", "cpu"]) == 2
    assert json.loads(capsys.readouterr().out)["repro"] == "error"
    assert replay.main([]) == 2


def test_a_mismatch_writes_a_bundle_and_fails(tmp_path, monkeypatch, capsys):
    """A route that serves a wrong mask: the tool names the seed, the mode
    and the first differing element, writes a bundle that replays as
    cleared (the defect was injected, not in the code), and exits 1."""
    from iterative_cleaner_tpu_torch.core import cleaner

    real = cleaner.clean_cube

    def faulty(D, w0, cfg, *args, **kw):
        res = real(D, w0, cfg, *args, **kw)
        if cfg.chunk_block and not cfg.incremental_template:
            res.weights = res.weights.copy()
            res.weights[0, 0] = -1.0
        return res

    monkeypatch.setattr(cleaner, "clean_cube", faulty)
    monkeypatch.setenv("ICT_REPRO_DIR", str(tmp_path))
    assert fuzz.main(["1", "1000", "--device", "cpu"]) == 1
    text = capsys.readouterr().out
    assert "mode chunked_dense(b=" in text and "first differing element [0, 0]" in text
    assert "FAIL chunked_dense" in text and "0/1 seeds identical" in text
    bundles = [p for p in os.listdir(tmp_path) if p.startswith("repro-")]
    assert len(bundles) == 1
    monkeypatch.setattr(cleaner, "clean_cube", real)
    assert replay.main([str(tmp_path / bundles[0]), "--device", "cpu"]) == 0


def test_tools_import_no_jax():
    code = ("import sys, runpy; sys.argv = ['x', '--help']\n"
            "for t in ('fuzz_sweep', 'replay_repro'):\n"
            "    try:\n"
            f"        runpy.run_path({str(REPO / 'tools_torch')!r} + '/' + t + '.py', "
            "run_name='__main__')\n"
            "    except SystemExit:\n"
            "        pass\n"
            "import iterative_cleaner_tpu_torch.cli, iterative_cleaner_tpu_torch.io.psrchive_io\n"
            "import iterative_cleaner_tpu_torch.utils.plotting\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert not any(m.split('.')[0] == 'iterative_cleaner_tpu' for m in sys.modules)\n"
            "print('NO-JAX-OK')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert "NO-JAX-OK" in out.stdout, out.stderr[-3000:]

