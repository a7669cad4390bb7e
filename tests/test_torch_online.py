"""The port's online subsystem (``--follow``) against the JAX package's, on
the CPU.

The same seeded archives are fed, block by block, into the JAX package's
``OnlineSession`` (``backend="numpy"`` / ``"jax"``, its chunked pass with
Pallas on auto, as tests/test_online.py runs it) and the port's
(``backend="numpy"`` / ``"torch"`` on ``device="cpu"``).  Every
``ZapAlert`` field but the latency must be identical, the slabs and the
provisional inputs too, and ``finalize`` must give the numpy oracle's mask.
Also: ``SessionMeta`` validation and its JSON form across the packages,
rollback on a failed pass, replay without a pass, the file tail
(``io/tail.py``) with torn reads, ``follow_archive`` / ``run_follow``
through an injected ``sleep``, and the CLI's ``--follow``.
"""

from __future__ import annotations

import json
import os
from dataclasses import replace

import numpy as np
import pytest
import torch

from iterative_cleaner_tpu.config import CleanConfig as JaxConfig
from iterative_cleaner_tpu.io.tail import tail_blocks as jax_tail_blocks
from iterative_cleaner_tpu.online import session as jax_session_mod
from iterative_cleaner_tpu.online.session import OnlineSession as JaxSession
from iterative_cleaner_tpu.online.state import CleanState as JaxCleanState
from iterative_cleaner_tpu.online.state import SessionMeta as JaxMeta
from iterative_cleaner_tpu_torch import cli, driver
from iterative_cleaner_tpu_torch.config import CleanConfig
from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
from iterative_cleaner_tpu_torch.io.npz import NpzIO
from iterative_cleaner_tpu_torch.io.synthetic import make_archive
from iterative_cleaner_tpu_torch.io.tail import eos_sentinel, tail_blocks
from iterative_cleaner_tpu_torch.online import session as session_mod
from iterative_cleaner_tpu_torch.online import CleanState, OnlineSession, SessionMeta
from iterative_cleaner_tpu_torch.online.follow import follow_archive
from iterative_cleaner_tpu_torch.ops.preprocess import preprocess
from iterative_cleaner_tpu_torch.parallel import chunked

#: (port backend, JAX backend) of the provisional passes.
BACKENDS = [("numpy", "numpy"), ("torch", "jax")]
UNEVEN = (3, 1, 4)


def _oracle(archive, max_iter=3):
    return clean_cube(*preprocess(archive), CleanConfig(backend="numpy", max_iter=max_iter))


def _alert_fields(alert) -> dict:
    d = alert.to_dict()
    d.pop("latency_s")
    return d


def _feed(sess, archive, blocks):
    lo, alerts = 0, []
    for bs in blocks:
        alerts.append(sess.ingest(archive.data[lo:lo + bs], archive.weights[lo:lo + bs]))
        lo += bs
    return alerts


def _port_session(archive, backend, **kw):
    return OnlineSession(SessionMeta.from_archive(archive),
                         CleanConfig(backend=backend, max_iter=3), device="cpu", **kw)


def _jax_session(archive, backend, **kw):
    return JaxSession(JaxMeta.from_archive(archive), JaxConfig(backend=backend, max_iter=3),
                      **kw)


class TestSessionMeta:
    def test_validation(self):
        with pytest.raises(ValueError, match="missing"):
            SessionMeta.from_dict({"nchan": 4})
        with pytest.raises(ValueError, match="unknown"):
            SessionMeta.from_dict({"nchan": 4, "nbin": 8, "bogus": 1})
        m = SessionMeta.from_dict({"nchan": 4, "nbin": 8, "dedispersed": True})
        assert m.freqs == [0.0] * 4
        with pytest.raises(ValueError, match="alert_iters"):
            OnlineSession(m, CleanConfig(), alert_iters=0)
        with pytest.raises(ValueError, match="positive"):
            SessionMeta.from_dict({"nchan": 4, "nbin": 8, "dm": 50.0})
        SessionMeta.from_dict({"nchan": 4, "nbin": 8, "dm": 50.0, "dedispersed": True})

    @pytest.mark.parametrize("bad", [
        {"nchan": 0, "nbin": 8}, {"nchan": 4, "nbin": 0}, {"nchan": 4, "nbin": 8, "npol": 0},
        {"nchan": 4, "nbin": 8, "freqs": [1.0, 2.0]},
        {"nchan": 2, "nbin": 8, "dm": 5.0, "centre_frequency": 100.0, "freqs": [100.0, -1.0]}])
    def test_rejected_like_jax(self, bad):
        with pytest.raises(ValueError):
            SessionMeta.from_dict(bad)
        with pytest.raises(ValueError):
            JaxMeta.from_dict(bad)

    @pytest.mark.parametrize("dispersed,npol", [(True, 1), (False, 1), (True, 2)])
    def test_jax_meta_json_opens_in_the_port(self, dispersed, npol):
        ar = make_archive(nsub=2, nchan=8, nbin=32, npol=npol, seed=3, dispersed=dispersed)
        spooled = json.dumps(JaxMeta.from_archive(ar).to_dict())
        meta = SessionMeta.from_dict(json.loads(spooled))
        assert meta.to_dict() == SessionMeta.from_archive(ar).to_dict() == json.loads(spooled)
        assert JaxMeta.from_dict(meta.to_dict()).to_dict() == meta.to_dict()


class TestCleanState:
    def test_doubling_and_views(self):
        st = CleanState(SessionMeta(nchan=4, nbin=8, dm=0.0, dedispersed=True))
        caps = []
        for k in range(9):
            st.append_block(np.full((1, 1, 4, 8), float(k), np.float32),
                            np.ones((1, 4), np.float32))
            caps.append(st.capacity)
        assert st.nsub == 9 and caps == [4, 4, 4, 4, 8, 8, 8, 8, 16]
        assert st.raw.shape == (9, 1, 4, 8) and float(st.raw[3, 0, 0, 0]) == 3.0
        with pytest.raises(ValueError):
            st.append_block(np.zeros((1, 1, 5, 8), np.float32), np.ones((1, 5), np.float32))
        with pytest.raises(ValueError):
            st.append_block(np.zeros((2, 1, 4, 8), np.float32), np.ones((1, 4), np.float32))
        with pytest.raises(ValueError, match="empty"):
            st.append_block(np.zeros((0, 1, 4, 8), np.float32), np.ones((0, 4), np.float32))
        with pytest.raises(ValueError, match="no blocks"):
            CleanState(SessionMeta(nchan=4, nbin=8)).provisional_inputs()

    @pytest.mark.parametrize("blocks", [UNEVEN, (1, 1, 1, 1, 1, 1, 1, 1), (8,), (5, 3)])
    @pytest.mark.parametrize("npol,dispersed", [(1, True), (2, True), (4, False)])
    def test_slabs_match_jax(self, blocks, npol, dispersed):
        ar = make_archive(nsub=8, nchan=16, nbin=64, npol=npol, seed=21, dispersed=dispersed)
        port = CleanState(SessionMeta.from_archive(ar))
        jst = JaxCleanState(JaxMeta.from_archive(ar))
        lo = 0
        for bs in blocks:
            data = ar.data[lo:lo + bs] if npol > 1 else ar.data[lo:lo + bs, 0]  # 3-D is npol 1
            assert port.append_block(data, ar.weights[lo:lo + bs]) == \
                jst.append_block(data, ar.weights[lo:lo + bs]) == lo
            lo += bs
            assert port.capacity == jst.capacity
            for a, b in zip((port.raw, port.weights, port.pscrunched),
                            (jst.raw, jst.weights, jst.pscrunched)):
                assert a.tobytes() == b.tobytes()
            for a, b in zip(port.provisional_inputs(), jst.provisional_inputs()):
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        got, want = port.assemble_archive(), jst.assemble_archive()
        assert got.data.tobytes() == ar.data.tobytes() == want.data.tobytes()
        np.testing.assert_array_equal(preprocess(got)[0], preprocess(ar)[0])


class TestSession:
    @pytest.mark.parametrize("blocks", [UNEVEN, (2, 2, 2, 2), (8,)])
    @pytest.mark.parametrize("port_backend,jax_backend", BACKENDS)
    def test_alerts_match_jax_and_finalize_is_the_oracle(self, port_backend, jax_backend,
                                                         blocks):
        ar = make_archive(nsub=8, nchan=16, nbin=64, seed=40)
        port = _port_session(ar, port_backend, alert_iters=2)
        jses = _jax_session(ar, jax_backend, alert_iters=2)
        got, want = _feed(port, ar, blocks), _feed(jses, ar, blocks)
        assert [_alert_fields(a) for a in got] == [_alert_fields(a) for a in want]
        assert all(a.latency_s > 0 for a in got)
        assert [(a.subint_lo, a.subint_hi) for a in got] == \
            [(sum(blocks[:k]), sum(blocks[:k + 1])) for k in range(len(blocks))]
        assert port._pass_block == jses._pass_block
        np.testing.assert_array_equal(port.state.prov_w, jses.state.prov_w)
        fin, jfin = port.finalize(), jses.finalize()
        np.testing.assert_array_equal(fin.result.weights, _oracle(ar).weights)
        np.testing.assert_array_equal(fin.result.weights, jfin.result.weights)
        assert fin.to_dict() == jfin.to_dict()
        assert port.finalized
        with pytest.raises(ValueError, match="finalized"):
            port.ingest(ar.data[:1], ar.weights[:1])
        with pytest.raises(ValueError, match="finalized"):
            port.replay_block(ar.data[:1], ar.weights[:1])

    @pytest.mark.parametrize("seed,alert_iters", [(41, 1), (42, 3), (7, 2)])
    def test_other_seeds_and_pass_lengths(self, seed, alert_iters):
        ar = make_archive(nsub=12, nchan=16, nbin=64, seed=seed)
        blocks = (4, 4, 3, 1)
        got = _feed(_port_session(ar, "torch", alert_iters=alert_iters), ar, blocks)
        want = _feed(_jax_session(ar, "jax", alert_iters=alert_iters), ar, blocks)
        assert [_alert_fields(a) for a in got] == [_alert_fields(a) for a in want]
        assert all(a.pass_iterations <= alert_iters for a in got)

    def test_kernel_forced_on_cpu_runs_the_plain_version(self):
        ar = make_archive(nsub=8, nchan=16, nbin=64, seed=40)
        sess = OnlineSession(SessionMeta.from_archive(ar),
                             CleanConfig(backend="torch", max_iter=3, kernel=True), device="cpu")
        got = _feed(sess, ar, UNEVEN)
        want = _feed(_port_session(ar, "torch"), ar, UNEVEN)
        assert [_alert_fields(a) for a in got] == [_alert_fields(a) for a in want]

    def test_passes_stream_fixed_slabs(self, monkeypatch):
        """Each provisional pass is a chunked cleaner on the session's device
        with the first block's power-of-two slab (or the whole cube while it
        is smaller), as the JAX session builds its ChunkedJaxCleaner."""
        ar = make_archive(nsub=12, nchan=16, nbin=64, seed=44)
        blocks = (3, 2, 4, 3)
        made = []
        real = chunked.ChunkedTorchCleaner

        def spy(D, w0, cfg, block, **kw):
            made.append((D.shape[0], block, str(kw["device"])))
            return real(D, w0, cfg, block, **kw)

        monkeypatch.setattr(chunked, "ChunkedTorchCleaner", spy)
        _feed(_port_session(ar, "torch"), ar, blocks)
        assert made == [(3, 3, "cpu"), (5, 4, "cpu"), (9, 4, "cpu"), (12, 4, "cpu")]
        jmade = []
        from iterative_cleaner_tpu.parallel import chunked as jchunked

        jreal = jchunked.ChunkedJaxCleaner

        def jspy(D, w0, cfg, block, **kw):
            jmade.append((D.shape[0], block, "cpu"))
            return jreal(D, w0, cfg, block, **kw)

        monkeypatch.setattr(jchunked, "ChunkedJaxCleaner", jspy)
        _feed(_jax_session(ar, "jax"), ar, blocks)
        assert jmade == made

    def test_alert_pairs_truncate(self, monkeypatch):
        ar = make_archive(nsub=8, nchan=16, nbin=64, seed=40)
        monkeypatch.setattr(session_mod, "MAX_ALERT_PAIRS", 2)
        monkeypatch.setattr(jax_session_mod, "MAX_ALERT_PAIRS", 2)
        got = _feed(_port_session(ar, "numpy"), ar, UNEVEN)
        want = _feed(_jax_session(ar, "numpy"), ar, UNEVEN)
        assert [_alert_fields(a) for a in got] == [_alert_fields(a) for a in want]
        first = got[0]
        assert first.n_new_zaps > 2 and first.truncated and len(first.new_zaps) == 2

    def test_constants_and_alert_fields_match_jax(self):
        assert session_mod.MAX_ALERT_PAIRS == jax_session_mod.MAX_ALERT_PAIRS
        assert session_mod.DEFAULT_ALERT_ITERS == jax_session_mod.DEFAULT_ALERT_ITERS
        assert list(session_mod.ZapAlert(0, 0, 1, 1, 0).to_dict()) == \
            list(jax_session_mod.ZapAlert(0, 0, 1, 1, 0).to_dict())

    @pytest.mark.parametrize("backend", ["numpy", "torch"])
    def test_failed_pass_rolls_the_append_back(self, monkeypatch, backend):
        ar = make_archive(nsub=6, nchan=16, nbin=64, seed=45)
        sess = _port_session(ar, backend)
        sess.ingest(ar.data[:2], ar.weights[:2])
        prov_before = sess.state.prov_w.copy()

        def boom(lo, hi):
            raise RuntimeError("synthetic backend death")

        monkeypatch.setattr(sess, "_provisional_pass", boom)
        with pytest.raises(RuntimeError, match="synthetic"):
            sess.ingest(ar.data[2:4], ar.weights[2:4])
        assert sess.state.nsub == 2 and sess.blocks_ingested == 1 and len(sess.alerts) == 1
        np.testing.assert_array_equal(sess.state.prov_w, prov_before)
        monkeypatch.undo()
        sess.ingest(ar.data[2:4], ar.weights[2:4])
        sess.ingest(ar.data[4:], ar.weights[4:])
        np.testing.assert_array_equal(sess.finalize().result.weights, _oracle(ar).weights)

    def test_bad_block_leaves_the_session_as_it_was(self):
        ar = make_archive(nsub=4, nchan=16, nbin=64, seed=46)
        sess = _port_session(ar, "torch")
        sess.ingest(ar.data[:2], ar.weights[:2])
        with pytest.raises(ValueError, match="does not match"):
            sess.ingest(np.zeros((1, 1, 5, 64), np.float32), np.ones((1, 5), np.float32))
        assert sess.state.nsub == 2 and sess.blocks_ingested == 1

    def test_replay_block_runs_no_pass(self, monkeypatch):
        ar = make_archive(nsub=6, nchan=16, nbin=64, seed=46)
        sess = _port_session(ar, "torch")
        passes = []
        real = sess._provisional_pass
        monkeypatch.setattr(sess, "_provisional_pass",
                            lambda lo, hi: passes.append((lo, hi)) or real(lo, hi))
        sess.replay_block(ar.data[:3], ar.weights[:3])
        assert sess.blocks_ingested == 1 and sess.state.nsub == 3 and passes == []
        alert = sess.ingest(ar.data[3:], ar.weights[3:])
        assert passes == [(3, 6)] and alert.nsub_total == 6 and alert.block_index == 1
        jses = _jax_session(ar, "jax")
        jses.replay_block(ar.data[:3], ar.weights[:3])
        assert _alert_fields(jses.ingest(ar.data[3:], ar.weights[3:])) == _alert_fields(alert)
        np.testing.assert_array_equal(sess.finalize().result.weights, _oracle(ar).weights)

    def test_finalize_needs_a_block(self):
        sess = _port_session(make_archive(nsub=2, nchan=8, nbin=32, seed=1), "torch")
        with pytest.raises(ValueError, match="no blocks"):
            sess.finalize()


def _write_prefix(full, path, n):
    part = replace(full, data=full.data[:n].copy(), weights=full.weights[:n].copy())
    NpzIO().save(part, f"{path}.tmp")
    os.replace(f"{path}.tmp", path)


def _growth(full, path, sizes):
    """An injected ``sleep`` that grows the file to each size in turn, then
    writes the end-of-stream sentinel."""
    steps = iter([lambda n=n: _write_prefix(full, path, n) for n in sizes]
                 + [lambda: open(eos_sentinel(path), "w").close()])
    return lambda s: next(steps, lambda: None)()


class TestTail:
    @pytest.mark.parametrize("sizes", [(2, 5, 8), (8,), (4, 4, 8)])
    def test_yields_new_ranges_like_jax(self, tmp_path, sizes):
        full = make_archive(nsub=8, nchan=8, nbin=32, seed=51)
        got, want = [], []
        for name, tail, out in (("p", tail_blocks, got), ("j", jax_tail_blocks, want)):
            path = str(tmp_path / f"{name}.npz")
            _write_prefix(full, path, 1)
            for ar, lo, hi in tail(path, poll_s=0.0, idle_timeout_s=60,
                                   sleep=_growth(full, path, sizes)):
                out.append((lo, hi, ar.nsub))
        assert got == want
        assert got[0] == (0, 1, 1) and got[-1][1:] == (8, 8)

    def test_torn_read_is_retried(self, tmp_path):
        full = make_archive(nsub=4, nchan=8, nbin=32, seed=52)
        path = str(tmp_path / "torn.npz")
        with open(path, "wb") as fh:
            fh.write(b"PK\x03\x04half-written")
        steps = iter([lambda: _write_prefix(full, path, 4),
                      lambda: open(eos_sentinel(path), "w").close()])
        got = [(lo, hi) for _, lo, hi in tail_blocks(
            path, poll_s=0.0, idle_timeout_s=60, sleep=lambda s: next(steps, lambda: None)())]
        assert got == [(0, 4)]

    def test_broken_file_after_eos_raises(self, tmp_path):
        path = str(tmp_path / "broken.npz")
        with open(path, "wb") as fh:
            fh.write(b"not a zip")
        open(eos_sentinel(path), "w").close()
        with pytest.raises(Exception):
            list(tail_blocks(path, poll_s=0.0, idle_timeout_s=60))

    def test_missing_file_times_out(self, tmp_path):
        with pytest.raises(TimeoutError, match="no readable archive"):
            list(tail_blocks(str(tmp_path / "never.npz"), poll_s=0.0, idle_timeout_s=0.0))

    def test_idle_timeout_ends_a_stream(self, tmp_path):
        full = make_archive(nsub=3, nchan=8, nbin=32, seed=53)
        path = str(tmp_path / "idle.npz")
        _write_prefix(full, path, 3)
        got = [(lo, hi) for _, lo, hi in tail_blocks(path, poll_s=0.0, idle_timeout_s=0.0)]
        assert got == [(0, 3)]


class TestFollow:
    def test_follow_tails_growth_and_finalizes_oracle_identical(self, tmp_path, monkeypatch,
                                                                capsys):
        monkeypatch.chdir(tmp_path)
        full = make_archive(nsub=8, nchan=16, nbin=64, seed=41)
        path = str(tmp_path / "grow.npz")
        _write_prefix(full, path, 3)
        cfg = CleanConfig(backend="torch", max_iter=3, dump_masks=True)
        reports = driver.run_follow([path], cfg, poll_s=0.0, idle_timeout_s=60,
                                    sleep=_growth(full, path, (5, 8)), device="cpu")
        rep = reports[0]
        assert rep.error is None and rep.out_path == f"{path}_cleaned.npz"
        ora = _oracle(full)
        np.testing.assert_array_equal(NpzIO().load(rep.out_path).weights, ora.weights)
        err = capsys.readouterr().err
        assert err.count("provisional zap") == 3 and "end of stream after 3 block(s)" in err
        assert "session open (nchan=16, nbin=64)" in err
        # The outputs of an offline run of the finished file.
        offline = tmp_path / "offline"
        offline.mkdir()
        NpzIO().save(full, str(offline / "grow.npz"))
        monkeypatch.chdir(offline)
        (off,) = driver.run([str(offline / "grow.npz")], cfg.replace(quiet=True), device="cpu")
        assert (rep.loops, rep.converged, rep.rfi_frac) == (off.loops, off.converged,
                                                           off.rfi_frac)
        assert len(rep.iteration_s) == len(off.iteration_s) == rep.loops
        with np.load(f"{path}_cleaned.npz_masks.npz") as a, \
                np.load(str(offline / "grow.npz_cleaned.npz_masks.npz")) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])
        log = (tmp_path / "clean.log").read_text()
        assert log.count("Cleaned ") == 1 and "required loops=" in log

    def test_follow_archive_writes_the_residual(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        full = make_archive(nsub=4, nchan=16, nbin=64, seed=42)
        path = str(tmp_path / "res.npz")
        NpzIO().save(full, path)
        open(eos_sentinel(path), "w").close()
        cfg = CleanConfig(backend="torch", max_iter=3, unload_res=True, quiet=True,
                          no_log=True)
        rep = follow_archive(path, cfg, poll_s=0.0, device="cpu")
        assert os.path.exists(f"{path}_residual_{rep.loops}.npz")
        assert not os.path.exists("clean.log")

    def test_follow_a_second_archive_after_a_failed_one(self, tmp_path, monkeypatch, capsys):
        monkeypatch.chdir(tmp_path)
        full = make_archive(nsub=4, nchan=16, nbin=64, seed=42)
        good = str(tmp_path / "good.npz")
        NpzIO().save(full, good)
        open(eos_sentinel(good), "w").close()
        cfg = CleanConfig(backend="torch", max_iter=3, quiet=True, no_log=True)
        reports = driver.run_follow([str(tmp_path / "never.npz"), good], cfg, poll_s=0.0,
                                    idle_timeout_s=0.0, device="cpu")
        assert reports[0].error and "no readable archive" in reports[0].error
        assert reports[1].error is None
        np.testing.assert_array_equal(NpzIO().load(reports[1].out_path).weights,
                                      _oracle(full).weights)
        assert "ERROR following" in capsys.readouterr().err

    def test_cli_missing_file_and_usage_errors(self, tmp_path, monkeypatch, capsys):
        monkeypatch.chdir(tmp_path)
        rc = cli.main(["--follow", "--device", "cpu", "--follow_poll", "0.01",
                       "--follow_timeout", "0.05", "-q", "-l", str(tmp_path / "never.npz")])
        assert rc == 1 and "ERROR following" in capsys.readouterr().err

    @pytest.mark.parametrize("argv", [["--follow", "--sharded_batch"],
                                      ["--follow", "--sweep", "5:5"],
                                      ["--follow", "--alert_iters", "0"]])
    def test_cli_usage_errors_exit_2(self, argv, capsys):
        assert cli.main([*argv, "--device", "cpu", "x.npz"]) == 2
        assert "error:" in capsys.readouterr().err

    def test_cli_complete_file_with_eos(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        full = make_archive(nsub=4, nchan=16, nbin=64, seed=42)
        path = str(tmp_path / "done.npz")
        NpzIO().save(full, path)
        open(eos_sentinel(path), "w").close()
        rc = cli.main(["--follow", "--device", "cpu", "--follow_poll", "0.01", "-q", "-l",
                       "-m", "3", "--report", "r.json", path])
        assert rc == 0
        np.testing.assert_array_equal(NpzIO().load(f"{path}_cleaned.npz").weights,
                                      _oracle(full).weights)
        (entry,) = json.load(open("r.json"))
        assert entry["error"] is None and entry["out_path"] == f"{path}_cleaned.npz"
        assert entry["loops"] == _oracle(full).loops


class TestNoHiddenDevice:
    @pytest.fixture(autouse=True)
    def _no_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present; the default device is valid here")

    def test_session_default_device_raises_and_rolls_back(self):
        ar = make_archive(nsub=4, nchan=16, nbin=64, seed=42)
        sess = OnlineSession(SessionMeta.from_archive(ar))
        assert sess.cfg.backend == "torch"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sess.ingest(ar.data[:2], ar.weights[:2])
        assert sess.state.nsub == 0 and sess.blocks_ingested == 0

    def test_cli_follow_default_device_fails(self, tmp_path, monkeypatch, capsys):
        monkeypatch.chdir(tmp_path)
        NpzIO().save(make_archive(nsub=3, nchan=8, nbin=32), "a.npz")
        open("a.npz.eos", "w").close()
        assert cli.main(["--follow", "-q", "a.npz"]) == 1
        assert "no CUDA device" in capsys.readouterr().err
        assert not os.path.exists("a.npz_cleaned.npz")
