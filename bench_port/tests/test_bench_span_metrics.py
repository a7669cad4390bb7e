"""The per-layer readers of the program's spans and upload counter, on
hand-built captures and registry values: what each reads, and nothing
where the program lacks the span or counter."""

from types import SimpleNamespace

import pytest

from bench_port import harness
from bench_port import trace as tr

MAIN, OTHER = 1, 2
SPAN_READERS = {"preprocess_span_s": "clean_preprocess", "parity_scan_s": "clean_parity_scan",
                "warmup_wait_s": "clean_warmup_wait"}


def span(name, start, end, tid=MAIN):
    return tr.Event("user_annotation", name, start, end - start, tid)


def device(start, end, cat="kernel"):
    return tr.Event(cat, "k", start, end - start, 7)


def inputs():
    """Two inputs: [0, 1] and [1, 2] seconds."""
    return [span(tr.INPUT_SPAN, 0.0, 1.0), span(tr.INPUT_SPAN, 1.0, 2.0)]


def read(name, events):
    return harness.reader(name)(SimpleNamespace(trace=tr.Trace(events), entry=None))


@pytest.mark.parametrize("metric", sorted(SPAN_READERS))
def test_span_readers_take_the_mean_per_input(metric):
    name = SPAN_READERS[metric]
    events = inputs() + [
        span(name, 0.1, 0.5), span(name, 1.1, 1.4),
        span(name, 0.2, 0.9, tid=OTHER),    # another thread's
        span(name, 2.5, 3.0),               # outside the window
        span("clean_upload", 0.5, 0.6),
    ]
    assert read(metric, events) == pytest.approx((0.4 + 0.3) / 2)


@pytest.mark.parametrize("metric", sorted(SPAN_READERS) + ["loop_idle_share"])
def test_span_readers_read_nothing_without_their_span(metric):
    events = inputs() + [span("clean_upload", 0.5, 0.6), device(0.5, 0.6)]
    assert read(metric, events) is None


def test_loop_idle_share_clips_the_card_to_the_loops():
    events = inputs() + [
        span("clean_loop", 0.5, 0.9), span("clean_loop", 1.5, 1.7),
        span("clean_loop", 0.0, 2.0, tid=OTHER),
        device(0.4, 0.6), device(0.7, 0.8, "gpu_memcpy"), device(0.75, 0.8),
        device(1.6, 1.65, "gpu_memset"), device(1.0, 1.4),
    ]
    busy = 0.1 + 0.1 + 0.05
    assert read("loop_idle_share", events) == pytest.approx(100.0 * (1 - busy / 0.6))


def test_loop_idle_share_needs_device_records():
    assert read("loop_idle_share", inputs() + [span("clean_loop", 0.5, 0.9)]) is None


def registry(monkeypatch, counters):
    from iterative_cleaner_tpu_torch.obs import tracing

    monkeypatch.setattr(tracing, "counters_snapshot", lambda: dict(counters))


def test_upload_host_GBps_reads_the_counter_over_the_phase(monkeypatch):
    registry(monkeypatch, {"clean_upload_bytes": 3.0e9, "clean_upload_s": 0.5,
                           "clean_upload_n": 5.0})
    assert read("upload_host_GBps", inputs()) == pytest.approx(6.0)


@pytest.mark.parametrize("counters", [{}, {"clean_upload_s": 0.5},
                                      {"clean_upload_bytes": 3.0e9},
                                      {"clean_upload_bytes": 3.0e9, "clean_upload_s": 0.0}])
def test_upload_host_GBps_reads_nothing_without_its_counters(monkeypatch, counters):
    registry(monkeypatch, counters)
    assert read("upload_host_GBps", inputs()) is None
