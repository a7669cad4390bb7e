"""The port's observability through its entry points, against the JAX
package's, on the CPU: the CLI's ``--telemetry`` event log (with
``ICT_FORENSICS=1``) on the stepwise, ``--fused`` and ``--chunk_block``
routes, ``--report`` with the audit and the quality summary, ``--trace``
and the bounded ``torch.profiler`` captures, the CUDA-initialisation
watchdog and probe, and the online session's counters and
``online_block`` events.  Both packages' registries, sinks and flight
rings are reset around every test.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from iterative_cleaner_tpu.cli import main as jax_main
from iterative_cleaner_tpu.config import CleanConfig as JaxConfig
from iterative_cleaner_tpu.obs import events as jax_events
from iterative_cleaner_tpu.obs import flight as jax_flight
from iterative_cleaner_tpu.obs import tracing as jax_tracing
from iterative_cleaner_tpu.online.session import OnlineSession as JaxSession
from iterative_cleaner_tpu.online.state import SessionMeta as JaxMeta
from iterative_cleaner_tpu_torch import cli
from iterative_cleaner_tpu_torch.config import CleanConfig
from iterative_cleaner_tpu_torch.io.npz import NpzIO
from iterative_cleaner_tpu_torch.io.synthetic import make_archive
from iterative_cleaner_tpu_torch.obs import events, flight, metrics, profiling, quality, tracing
from iterative_cleaner_tpu_torch.online import OnlineSession, SessionMeta
from iterative_cleaner_tpu_torch.utils import device_probe

REPO = Path(__file__).resolve().parents[1]
SHAPE = (16, 64, 128)
#: Per-record fields that differ between any two runs.
VOLATILE = ("ts", "trace_id", "span_id", "parent_span_id", "duration_s", "argv",
            "cache_salt", "path", "latency_s")


def _reset_all():
    for mod in (tracing, jax_tracing):
        mod.reset_counters()
    for mod in (flight, jax_flight):
        mod.reset()
    for mod in (events, jax_events):
        mod.configure(None)


@pytest.fixture(autouse=True)
def _clean_registries():
    _reset_all()
    yield
    _reset_all()


@pytest.fixture
def archive_path(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    NpzIO().save(make_archive(*SHAPE, seed=3), "a.npz")
    return "a.npz"


def _records(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def _stable(rec):
    return {k: v for k, v in rec.items() if k not in VOLATILE}


class TestCliTelemetry:
    @pytest.mark.parametrize("route", [[], ["--fused"], ["--chunk_block", "4"]],
                             ids=["stepwise", "fused", "chunked"])
    def test_events_match_jax(self, archive_path, monkeypatch, route):
        monkeypatch.setenv("ICT_FORENSICS", "1")
        args = [archive_path, "-q", "-l"] + route
        assert jax_main(args + ["--telemetry", "jax.jsonl"]) == 0
        assert cli.main(args + ["--telemetry", "port.jsonl", "--device", "cpu"]) == 0
        got, want = _records("port.jsonl"), _records("jax.jsonl")
        assert [r["event"] for r in got] == [r["event"] for r in want] == [
            "cli_run_start", "job_submitted", "clean_archive_start", "clean_route",
            "iteration", "iteration", "clean_archive_end", "cli_run_end"]
        assert [_stable(r) for r in got] == [_stable(r) for r in want]
        iters = [r for r in got if r["event"] == "iteration"]
        assert all(r["zaps_by_diagnostic"] for r in iters)
        # One invocation, one trace id.
        assert len({r["trace_id"] for r in got}) == 1

    def test_no_sink_no_file_but_the_flight_ring(self, archive_path):
        assert cli.main([archive_path, "-q", "-l", "--device", "cpu"]) == 0
        assert not glob.glob("*.jsonl")
        assert "cli_run_end" in [r["event"] for r in flight.snapshot()]

    def test_report_carries_audit_and_quality(self, archive_path):
        assert cli.main([archive_path, "-q", "-l", "--device", "cpu", "--audit",
                         "--report", "r.json"]) == 0
        rep = json.load(open("r.json"))[0]
        assert rep["audit"]["mask_identical"] and rep["audit"]["drift_within_bound"]
        assert rep["audit"]["route"] == "stepwise"
        served = NpzIO().load(rep["out_path"]).weights
        assert rep["quality"] == quality.quality_summary(served, termination="fixed_point")
        assert tracing.counters_snapshot()["audit_runs"] == 1
        metrics.parse_exposition(metrics.render_prometheus())

    def test_numpy_backend_sees_no_watchdog(self, archive_path, monkeypatch):
        seen = []
        monkeypatch.setattr(device_probe, "init_watchdog",
                            lambda *a, **k: seen.append(a) or device_probe.contextlib.nullcontext())
        assert cli.main([archive_path, "-q", "-l", "--backend", "numpy"]) == 0
        assert cli.main([archive_path, "-q", "-l", "--device", "cpu"]) == 0
        assert seen == []


# --- torch.profiler captures ---


def _trace_events(directory):
    files = glob.glob(os.path.join(directory, "*" + profiling.TRACE_SUFFIX))
    assert len(files) == 1, files
    with open(files[0]) as fh:
        return json.load(fh)["traceEvents"]


class TestProfiling:
    def test_cli_trace_writes_a_capture(self, archive_path):
        assert cli.main([archive_path, "-q", "-l", "--device", "cpu", "--trace", "tdir"]) == 0
        names = {e.get("name") for e in _trace_events("tdir")}
        assert names and profiling.active() is None

    def test_bounded_capture_refuses_an_overlap(self, tmp_path):
        rec = profiling.start(str(tmp_path), duration_s=30, tag="one", device="cpu")
        assert profiling.active()["dir"] == rec["dir"]
        with pytest.raises(RuntimeError, match="already running"):
            profiling.start(str(tmp_path), duration_s=1, tag="two", device="cpu")
        with pytest.raises(RuntimeError, match="already running"):
            with profiling.profile_trace(str(tmp_path / "t"), device="cpu"):
                pass
        with profiling.maybe_capture(str(tmp_path), "job", device="cpu") as d:
            assert d is None   # busy: skipped, not failed
        with torch.profiler.record_function("held_span"):
            torch.ones(8) @ torch.ones(8)
        assert profiling.stop(expected_dir="/elsewhere") is None
        out = profiling.stop(expected_dir=rec["dir"])
        assert out["trace"] and os.path.exists(out["trace"])
        # The capture runs on a thread of its own and records this one's ops.
        assert "held_span" in {e.get("name") for e in _trace_events(rec["dir"])}
        assert profiling.active() is None and profiling.stop() is None
        assert [p["name"] for p in profiling.list_profiles(str(tmp_path))] == [
            os.path.basename(rec["dir"])]

    def test_deadline_ends_a_capture(self, tmp_path, monkeypatch):
        monkeypatch.setenv("ICT_PROFILE_MAX_S", "0.3")
        assert profiling.max_capture_s() == 0.3
        rec = profiling.start(str(tmp_path), duration_s=60, tag="d", device="cpu")
        assert rec["duration_s"] == 0.3
        deadline = time.monotonic() + 30
        while profiling.active() is not None and time.monotonic() < deadline:
            time.sleep(0.05)
        assert profiling.active() is None
        _trace_events(rec["dir"])
        assert "profile_stop" in [r["event"] for r in flight.snapshot()]

    def test_first_capture_of_a_process_prints_nothing(self, tmp_path):
        # Kineto writes from C++ to file descriptor 2, which a fresh process
        # shows whole.  Its one-time set-up runs at a process's first
        # capture: on the thread that calls start, it says nothing; on the
        # capture's own thread it printed "External init callback must run
        # in same thread as registerClient".
        script = (
            "import sys, torch\n"
            "from iterative_cleaner_tpu_torch.obs import profiling\n"
            "rec = profiling.start(sys.argv[1], duration_s=30, tag='first', device='cpu')\n"
            "with torch.profiler.record_function('first_span'):\n"
            "    torch.ones(8) @ torch.ones(8)\n"
            "print(profiling.stop(expected_dir=rec['dir'])['trace'])\n")
        run = subprocess.run([sys.executable, "-c", script, str(tmp_path)], capture_output=True,
                             text=True, timeout=120, cwd=str(tmp_path),
                             env=dict(os.environ, PYTHONPATH=str(REPO)))
        assert run.returncode == 0, run.stderr
        assert "External init callback" not in run.stderr, run.stderr
        with open(run.stdout.strip().splitlines()[-1]) as fh:
            names = {e.get("name") for e in json.load(fh)["traceEvents"]}
        assert "first_span" in names

    def test_maybe_capture_and_one_shot(self, tmp_path):
        with profiling.maybe_capture(str(tmp_path), "job", device="cpu") as d:
            assert d is not None
        _trace_events(d)
        with profiling.maybe_capture(str(tmp_path), "job", want=False) as d:
            assert d is None
        with profiling.profile_trace(None):
            pass
        with profiling.profile_trace(str(tmp_path / "one"), device="cpu"):
            assert profiling.active()["until_s"] is None
        _trace_events(str(tmp_path / "one"))


# --- the CUDA-initialisation watchdog and probe ---


class TestWatchdog:
    def test_fires_on_a_blocking_stub(self, monkeypatch, capsys):
        monkeypatch.setenv("ICT_INIT_TIMEOUT_S", "0.2")
        with device_probe.init_watchdog("stub init"):
            time.sleep(0.8)      # CUDA never comes up on this host
        err = capsys.readouterr().err
        line = next(ln for ln in err.splitlines() if "backend_init_watchdog" in ln)
        assert json.loads(line.split("warning: ", 1)[1])["label"] == "stub init"
        assert tracing.counters_snapshot()["backend_init_watchdog_fired"] == 1
        assert "backend_init_watchdog" in [r["event"] for r in flight.snapshot()]

    def test_silent_when_init_completes(self, monkeypatch, capsys):
        monkeypatch.setenv("ICT_INIT_TIMEOUT_S", "0.3")
        state = {"live": "not_live"}
        monkeypatch.setattr(device_probe, "_backend_liveness", lambda: state["live"])
        threading.Timer(0.05, lambda: state.update(live="live")).start()
        with device_probe.init_watchdog():
            time.sleep(0.8)
        assert "backend_init_watchdog" not in capsys.readouterr().err
        assert "backend_init_watchdog_fired" not in tracing.counters_snapshot()

    def test_silent_for_a_short_block_and_when_disabled(self, monkeypatch, capsys):
        monkeypatch.setenv("ICT_INIT_TIMEOUT_S", "0.5")
        with device_probe.init_watchdog():
            pass
        monkeypatch.setenv("ICT_INIT_TIMEOUT_S", "0")
        with device_probe.init_watchdog():
            time.sleep(0.2)
        time.sleep(0.6)
        assert "backend_init_watchdog" not in capsys.readouterr().err

    def test_probe_verdicts(self, monkeypatch, capsys):
        # On this host the real probe fails fast (no CUDA): "error".
        assert device_probe.probe_default_backend(120) in ("error", "ok")
        monkeypatch.setenv("ICT_NO_DEVICE_PROBE", "1")
        assert device_probe.ensure_responsive_backend(5) == "skipped"
        monkeypatch.delenv("ICT_NO_DEVICE_PROBE")
        assert device_probe.ensure_responsive_backend(0) == "skipped"
        verdicts = iter(["hang", "ok"])
        monkeypatch.setattr(device_probe, "probe_default_backend", lambda t: next(verdicts))
        assert device_probe.ensure_responsive_backend(1) == "ok"
        monkeypatch.setattr(device_probe, "probe_default_backend", lambda t: "hang")
        assert device_probe.ensure_responsive_backend(1) == "hang"
        assert "may hang" in capsys.readouterr().err


# --- the online session ---


class TestOnlineSession:
    @pytest.mark.parametrize("backends", [("numpy", "numpy"), ("torch", "jax")])
    def test_counters_and_events_match_jax(self, tmp_path, backends):
        ar = make_archive(nsub=12, nchan=32, nbin=64, seed=11)
        port = OnlineSession(SessionMeta.from_archive(ar),
                             CleanConfig(backend=backends[0], max_iter=3), device="cpu")
        jses = JaxSession(JaxMeta.from_archive(ar), JaxConfig(backend=backends[1], max_iter=3))
        events.configure(str(tmp_path / "port.jsonl"))
        jax_events.configure(str(tmp_path / "jax.jsonl"))
        lo = 0
        for bs in (3, 1, 4, 4):
            port.ingest(ar.data[lo:lo + bs], ar.weights[lo:lo + bs])
            jses.ingest(ar.data[lo:lo + bs], ar.weights[lo:lo + bs])
            lo += bs
        got = [_stable(r) for r in _records(tmp_path / "port.jsonl")]
        want = [_stable(r) for r in _records(tmp_path / "jax.jsonl")]
        assert got == want
        assert [r["event"] for r in got].count("online_block") == 4
        snap, jsnap = tracing.counters_snapshot(), jax_tracing.counters_snapshot()
        for key in ("online_blocks_ingested", "online_zap_alerts", "online_block_n",
                    "online_pass_n"):
            assert snap[key] == jsnap[key], key
        assert snap["online_blocks_ingested"] == 4

    def test_follow_cli_events_share_the_run_trace(self, archive_path):
        open(archive_path + ".eos", "w").close()
        assert cli.main([archive_path, "-q", "-l", "--device", "cpu", "--follow",
                         "--follow_poll", "0.01", "--telemetry", "f.jsonl"]) == 0
        recs = _records("f.jsonl")
        names = [r["event"] for r in recs]
        assert names[0] == "cli_run_start" and names[-1] == "cli_run_end"
        assert "online_block" in names and len({r["trace_id"] for r in recs}) == 1
