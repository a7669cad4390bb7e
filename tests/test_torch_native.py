"""The port's native host runtime against the JAX package's, on the CPU.

``iterative_cleaner_tpu_torch.native`` builds the shared source
``native/ict_native.cc`` into the port's own ``_build/``; its ``.ictb``
writer must give the JAX writer's bytes, each package must read the
other's files, and its preprocess must be bit-identical to the JAX
package's native route and to both packages' numpy paths.  Skipped where
there is no ``g++`` (as ``tests/test_native.py`` is).
"""

from __future__ import annotations

import os
import shutil
import threading

import numpy as np
import pytest

from iterative_cleaner_tpu import native as jax_native
from iterative_cleaner_tpu.io.synthetic import make_archive as jax_make_archive
from iterative_cleaner_tpu.ops.preprocess import preprocess as jax_preprocess
from iterative_cleaner_tpu_torch import native
from iterative_cleaner_tpu_torch.io.base import STATE_COHERENCE, STATE_STOKES, get_io
from iterative_cleaner_tpu_torch.io.ictb import IctbIO
from iterative_cleaner_tpu_torch.io.npz import NpzIO
from iterative_cleaner_tpu_torch.io.synthetic import make_archive
from iterative_cleaner_tpu_torch.obs import tracing
from iterative_cleaner_tpu_torch.ops.preprocess import preprocess

#: (npol, state, dispersed): Intensity, Coherence, Stokes; dispersed and not.
STATES = [(1, None, True), (2, STATE_COHERENCE, True), (4, STATE_STOKES, False),
          (2, STATE_COHERENCE, False)]


@pytest.fixture(autouse=True)
def _toolchain():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native runtime cannot be built here")
    if not native.available():
        pytest.fail(f"g++ is present but the native build failed:\n{native.build_log()}")
    if not jax_native.available():
        pytest.skip("the JAX package's native library did not build")


def _archive(npol, state, dispersed, seed=3, nsub=6, nchan=16, nbin=64):
    ar = make_archive(nsub=nsub, nchan=nchan, nbin=nbin, npol=npol, seed=seed,
                      dispersed=dispersed, state=state)
    ar.source = "J1234+5678"
    return ar


class TestIctbFiles:
    @pytest.mark.parametrize("npol, state, dispersed", STATES)
    def test_byte_identical_to_the_jax_writer(self, tmp_path, npol, state, dispersed):
        ar = _archive(npol, state, dispersed)
        ours, theirs = str(tmp_path / "port.ictb"), str(tmp_path / "jax.ictb")
        native.save_ictb(ours, ar)
        jax_native.save_ictb(theirs, ar)
        with open(ours, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read()

    @pytest.mark.parametrize("npol, state, dispersed", STATES)
    def test_each_reads_the_others(self, tmp_path, npol, state, dispersed):
        ar = _archive(npol, state, dispersed)
        p_port, p_jax = str(tmp_path / "port.ictb"), str(tmp_path / "jax.ictb")
        native.save_ictb(p_port, ar)
        jax_native.save_ictb(p_jax, ar)
        for back in (native.load_ictb(p_jax), jax_native.load_ictb(p_port)):
            for f in ("data", "weights", "freqs"):
                assert getattr(back, f).tobytes() == getattr(ar, f).tobytes()
            for f in ("centre_frequency", "dm", "period", "source", "mjd_start",
                      "mjd_end", "state", "dedispersed"):
                assert getattr(back, f) == getattr(ar, f)

    def test_get_io_routes_ictb(self, tmp_path):
        p = str(tmp_path / "a.ictb")
        io = get_io(p)
        assert isinstance(io, IctbIO)
        ar = _archive(1, None, True)
        io.save(ar, p)
        assert get_io(p).load(p).data.tobytes() == ar.data.tobytes()

    @pytest.mark.parametrize("content", [None, b"\x00" * 4096, b"ICTB"])
    def test_bad_files_raise(self, tmp_path, content):
        p = tmp_path / "bad.ictb"
        if content is not None:
            p.write_bytes(content)
        with pytest.raises(OSError):
            native.load_ictb(str(p))


class TestPreprocess:
    @pytest.mark.parametrize("npol, state, dispersed", STATES)
    @pytest.mark.parametrize("seed", [0, 7])
    def test_bit_identical_to_jax_and_both_numpy_paths(self, npol, state, dispersed, seed):
        ar = _archive(npol, state, dispersed, seed=seed, nsub=5, nchan=33, nbin=100)
        D, w0 = native.preprocess_native(ar)
        for Dr, wr in (jax_native.preprocess_native(ar),
                       jax_preprocess(ar, prefer_native=False),
                       preprocess(ar, prefer_native=False)):
            assert D.tobytes() == Dr.tobytes() and w0.tobytes() == wr.tobytes()
        assert not np.shares_memory(w0, ar.weights)

    def test_the_default_prefers_native_and_counts_the_route(self):
        ar = _archive(1, None, True)
        snap = tracing.snapshot()
        D, _ = preprocess(ar)
        assert tracing.delta(snap, "preprocess_native") == 1
        assert tracing.delta(snap, "preprocess_numpy") == 0
        D_np, _ = preprocess(ar, prefer_native=False)
        assert tracing.delta(snap, "preprocess_numpy") == 1
        assert D.tobytes() == D_np.tobytes()


class TestBuild:
    def test_library_in_the_ports_build_dir(self):
        path = native.library_path()
        assert path.parent == native.BUILD_DIR and path.exists()
        assert "iterative_cleaner_tpu_torch" in str(path.parent)

    def test_missing_source_falls_back_to_numpy(self, monkeypatch, tmp_path):
        monkeypatch.setattr(native, "SOURCE", tmp_path / "none.cc")
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", False)
        monkeypatch.setattr(native, "_build_log", "")
        assert not native.available()
        assert "no native source" in native.build_log()
        assert native.preprocess_native(_archive(1, None, True)) is None
        snap = tracing.snapshot()
        ar = _archive(1, None, True)
        D, _ = preprocess(ar)
        assert tracing.delta(snap, "preprocess_numpy") == 1
        with pytest.raises(RuntimeError, match="unavailable"):
            native.save_ictb(str(tmp_path / "x.ictb"), ar)

    def test_a_failed_build_keeps_its_log(self, monkeypatch, tmp_path):
        bad = tmp_path / "broken.cc"
        bad.write_text("this is not C++\n")
        monkeypatch.setattr(native, "SOURCE", bad)
        monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", False)
        monkeypatch.setattr(native, "_build_log", "")
        assert not native.available()
        assert "g++" in native.build_log() and "error" in native.build_log()
        assert not any(p.suffix == ".so" for p in (tmp_path / "build").iterdir())

    def test_concurrent_first_builds_publish_one_whole_library(self, monkeypatch, tmp_path):
        # Several processes (the suite's workers) may build at once; each
        # writes a temporary file and renames it, so a loader never sees a
        # half-written library.  Threads stand in for the processes here.
        monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(native, "_build_log", "")
        outs, errors = [], []

        def build():
            try:
                outs.append(native._build())
            except Exception as exc:  # noqa: BLE001 — reported below
                errors.append(exc)

        threads = [threading.Thread(target=build) for _ in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        assert not errors and not any(th.is_alive() for th in threads)
        assert len(set(outs)) == 1 and outs[0].exists()
        assert os.listdir(tmp_path / "build") == [outs[0].name]


def test_cli_cleans_an_ictb_like_its_npz(tmp_path, monkeypatch):
    from iterative_cleaner_tpu_torch.cli import main

    ar = make_archive(nsub=8, nchan=32, nbin=64, seed=11)
    assert ar.data.tobytes() == jax_make_archive(nsub=8, nchan=32, nbin=64,
                                                 seed=11).data.tobytes()
    p_i, p_n = str(tmp_path / "obs.ictb"), str(tmp_path / "obs.npz")
    native.save_ictb(p_i, ar)
    NpzIO().save(ar, p_n)
    monkeypatch.chdir(tmp_path)
    for p in (p_i, p_n):
        assert main(["--device", "cpu", "-q", "-l", p]) == 0
    w_i = native.load_ictb(p_i + "_cleaned.ictb").weights
    w_n = NpzIO().load(p_n + "_cleaned.npz").weights
    assert w_i.tobytes() == w_n.tobytes()
