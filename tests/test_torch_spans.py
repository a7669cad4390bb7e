"""The port's program spans: ``obs/tracing.phase`` as a profiler span, the
phases of a clean on its main path (preprocess, warm-up, parity scan,
upload, loop, finalize), the bytes uploaded, the route gauges read from
the allocator alone, and the operator's capture of every thread.  On the
CPU, at a tiny shape."""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from iterative_cleaner_tpu_torch.backends import torch_backend
from iterative_cleaner_tpu_torch.config import CleanConfig
from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
from iterative_cleaner_tpu_torch.ingest import pipeline
from iterative_cleaner_tpu_torch.io.synthetic import make_archive
from iterative_cleaner_tpu_torch.models.surgical import SurgicalCleaner
from iterative_cleaner_tpu_torch.models.sweep import sweep_thresholds
from iterative_cleaner_tpu_torch.obs import flight, memory, profiling, tracing
from iterative_cleaner_tpu_torch.ops.preprocess import preprocess

SHAPE = dict(nsub=8, nchan=32, nbin=64)
PAIRS = [(4.0, 5.0), (5.0, 5.0)]
CFG = CleanConfig(backend="torch", max_iter=4)


def _reset():
    tracing.reset_counters()
    flight.reset()
    pipeline.reset_stats()   # the chunked route's streamed blocks


@pytest.fixture(autouse=True)
def _fresh_registries():
    _reset()
    yield
    _reset()


@pytest.fixture(scope="module")
def archive():
    return make_archive(seed=5, **SHAPE)


def _clean(route, archive):
    """One call of ``route`` on ``archive`` (the sweep and the fused
    ``clean_cube`` on its cube, preprocessed before the call): a function
    that returns (masks, scores, loops)."""
    if route == "surgical":
        def call():
            out = SurgicalCleaner(CFG, device="cpu").clean(archive)
            return out.cleaned.weights, out.result.test_results, out.result.loops
        return call
    D, w0 = preprocess(archive)
    return lambda: _clean_cube(route, D, w0)


def _clean_cube(route, D, w0):
    if route == "fused":
        res = clean_cube(D, w0, CFG.replace(fused=True), device="cpu")
        return res.weights, res.test_results, res.loops
    points = sweep_thresholds(D, w0, CFG, PAIRS, device="cpu")
    return (np.stack([p.weights for p in points]), None, [p.loops for p in points])


#: The program's spans of each call, in order.
ROWS = {
    "surgical": ["clean_preprocess", "clean_parity_scan", "clean_upload", "clean_loop",
                 "clean_finalize"],
    "fused": ["clean_parity_scan", "clean_upload", "clean_loop"],
    "sweep": ["clean_upload", "clean_loop", "clean_finalize"],
}


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("caller"):
            out = fn()
    return out, prof.events()


@pytest.mark.parametrize("error", [False, True])
def test_phase_is_a_profiler_span_and_keeps_its_counters(error):
    def body():
        try:
            with tracing.phase("unit_phase"):
                time.sleep(0.002)
                if error:
                    raise RuntimeError("boom")
        except RuntimeError:
            pass

    _, evs = _profiled(body)
    found = {e.name: e for e in evs if e.name in ("caller", "unit_phase")}
    caller, span = found["caller"], found["unit_phase"]
    assert span.thread == caller.thread
    assert caller.time_range.start <= span.time_range.start
    assert span.time_range.end <= caller.time_range.end
    assert span.time_range.elapsed_us() >= 2000
    snap = tracing.counters_snapshot()
    assert snap["unit_phase_n"] == 1 and snap["unit_phase_s"] >= 0.002
    assert snap["unit_phase_max_s"] == snap["unit_phase_s"]
    assert snap.get("unit_phase_err_n", 0) == (1 if error else 0)
    assert sum(tracing.registry_snapshot()[4]["unit_phase"]) == 1
    ring = [r for r in flight.snapshot() if r["event"] == "phase"]
    assert ring[-1]["phase"] == "unit_phase" and ring[-1].get("error", False) == error


@pytest.mark.parametrize("route", sorted(ROWS))
def test_clean_spans_in_order_on_the_calling_thread(route, archive):
    _, evs = _profiled(_clean(route, archive))
    caller = next(e for e in evs if e.name == "caller")
    rows = sorted((e for e in evs if e.name.startswith("clean_")),
                  key=lambda e: e.time_range.start)
    assert [e.name for e in rows] == ROWS[route]
    for e in rows:
        assert e.thread == caller.thread, e.name
        assert caller.time_range.start <= e.time_range.start
        assert e.time_range.end <= caller.time_range.end
    # Top-level: no program span holds another.
    for a, b in zip(rows, rows[1:]):
        assert a.time_range.end <= b.time_range.start, (a.name, b.name)
    snap = tracing.counters_snapshot()
    assert all(snap[f"{name}_n"] == 1 for name in ROWS[route])


def test_the_audits_oracle_replay_is_no_loop_phase(archive):
    out = SurgicalCleaner(CFG.replace(audit=True), device="cpu").clean(archive)
    assert out.audit["mask_identical"]
    snap = tracing.counters_snapshot()
    assert snap["clean_loop_n"] == 1 and snap["clean_finalize_n"] == 1


@pytest.mark.parametrize("route", sorted(ROWS))
def test_spans_change_no_mask_or_score(route, archive):
    call = _clean(route, archive)
    plain = call()
    traced, _ = _profiled(call)
    assert np.array_equal(plain[0], traced[0])
    assert plain[2] == traced[2]
    if plain[1] is not None:
        assert np.array_equal(plain[1], traced[1], equal_nan=True)


@pytest.mark.parametrize("route", ["stepwise", "fused", "chunked", "sweep"])
def test_upload_bytes_count_the_cube_and_its_weights(route, archive):
    D, w0 = preprocess(archive)
    before = tracing.snapshot()
    if route == "sweep":
        sweep_thresholds(D, w0, CFG, PAIRS, device="cpu")
    else:
        cfg = CFG.replace(fused=route == "fused", chunk_block=3 if route == "chunked" else 0)
        clean_cube(D, w0, cfg, device="cpu")
    # The chunked route streams its cube in slabs (``ingest_upload``): only
    # its weights go up whole.
    want = w0.nbytes + (0 if route == "chunked" else D.nbytes)
    assert tracing.delta(before, "clean_upload_bytes") == want
    assert tracing.delta(before, "clean_upload_n") == 1


def test_upload_bytes_count_the_converted_type(archive):
    D, w0 = preprocess(archive)
    before = tracing.snapshot()
    clean_cube(D, w0, CFG.replace(x64=True, kernel=False), device="cpu")
    assert tracing.delta(before, "clean_upload_bytes") == 2 * (D.nbytes + w0.nbytes)


def test_warmup_thread_and_its_join_are_phases(archive, monkeypatch, tmp_path):
    """A stand-in warm-up: the real thread body of ``start_precompile``
    with its device work replaced by a sleep, started as on the card."""
    monkeypatch.setenv("ICT_HBM_BYTES", str(10**12))
    monkeypatch.setattr(torch_backend, "precompile_for", lambda *a, **k: time.sleep(0.3))
    real = torch_backend.start_precompile
    started = []

    def start(shape, cfg, want_residual=False, device="cuda"):
        with pytest.MonkeyPatch.context() as m:
            m.setattr(torch.cuda, "is_available", lambda: True)
            th = real(shape, cfg.replace(kernel=False), want_residual, device="cuda")
        started.append(th)
        return th

    monkeypatch.setattr(torch_backend, "start_precompile", start)
    with profiling.profile_trace(str(tmp_path / "trace"), device="cpu"):
        SurgicalCleaner(CFG, device="cpu").clean(archive)
    (th,) = started
    th.join(timeout=30)
    assert not th.is_alive() and th.error is None
    snap = tracing.counters_snapshot()
    assert snap["clean_warmup_n"] == 1 and snap["clean_warmup_wait_n"] == 1
    assert snap["clean_warmup_s"] >= 0.3 and snap["clean_warmup_wait_s"] > 0
    assert {"clean_warmup", "clean_warmup_wait"} <= {
        r.get("phase") for r in flight.snapshot()}
    # The operator's capture records every thread: the warm-up's span on
    # its own thread, the join on the caller's.
    (name,) = os.listdir(tmp_path / "trace")
    with open(tmp_path / "trace" / name) as fh:
        evs = json.load(fh)["traceEvents"]
    tids = {e["name"]: e["tid"] for e in evs if e.get("cat") == "user_annotation"
            and e.get("name") in ("clean_warmup", "clean_warmup_wait", "clean_preprocess")}
    assert set(tids) == {"clean_warmup", "clean_warmup_wait", "clean_preprocess"}
    assert tids["clean_warmup"] != tids["clean_warmup_wait"] == tids["clean_preprocess"]


def test_operator_capture_records_other_threads(tmp_path):
    def work():
        with tracing.phase("unit_thread_phase"):
            time.sleep(0.001)

    with profiling.profile_trace(str(tmp_path), device="cpu"):
        th = threading.Thread(target=work)
        th.start()
        th.join(timeout=30)
    assert not th.is_alive()
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert "unit_thread_phase" in names


def test_route_gauges_read_the_allocator_alone(monkeypatch):
    cards = [{"allocated_bytes.all.peak": 7_000, "allocated_bytes.all.current": 3_000},
             {"allocated_bytes.all.peak": 9_000, "allocated_bytes.all.current": 1_000}]

    def no_mem_get_info(*_a, **_k):
        raise AssertionError("observe_route called mem_get_info")

    monkeypatch.setattr(memory, "backend_live", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: len(cards))
    monkeypatch.setattr(torch.cuda, "memory_stats",
                        lambda d: dict(cards[d if isinstance(d, int) else d.index]))
    monkeypatch.setattr(torch.cuda, "mem_get_info", no_mem_get_info)
    memory.observe_route("stepwise")
    cards[1]["allocated_bytes.all.peak"] = 8_000   # a lower peak: the gauge ratchets
    memory.observe_route("stepwise")
    _flat, labeled = tracing.gauges_snapshot()
    labels = (("route", "stepwise"),)
    assert labeled[("route_hbm_peak_bytes", labels)] == 9_000
    assert labeled[("route_hbm_bytes_in_use", labels)] == 3_000
    # The device view keeps the card's capacity for /metrics.
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d: (1, 80_000))
    assert [r["bytes_limit"] for r in memory.device_snapshot()] == [80_000, 80_000]
