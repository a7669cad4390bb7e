"""The ``batch`` entry's inputs and the readers of its two per-layer
metrics, on the CPU: the archive pool cut into batches, the mean per input
of ``clean_batch_preprocess``, and the batch's peak over its sizing, with
the gauge planted; each reads nothing where the program lacks its span or
gauge."""

from types import SimpleNamespace

import pytest

from bench_port import harness
from bench_port import trace as tr
from bench_port.tests.conftest import make_tiny_root

CELL = "lofar.batch8"
MAIN, OTHER = 1, 2


@pytest.fixture(scope="module")
def entry(tmp_path_factory):
    root = make_tiny_root(tmp_path_factory.mktemp("batch"))
    _cell, config, traffic = harness.find_cell(harness.load_spec(root), CELL, root)
    return harness.make_entry(config, traffic, "cpu", root)


def test_every_seed_cleans_the_pool_in_batches(entry):
    a, b = entry.sources(5), entry.sources(2**31 + 7)
    assert a == entry.sources(5) and a != b
    for src in (a, b):
        assert len(src) == entry.traffic["inputs"]
        assert all(len(batch) == entry.batch for batch in src)
        assert sorted(s for batch in src for s, _ in batch) == sorted(entry.traffic["archive_pool"])
    shuffles = [sh for batch in a for _, sh in batch]
    assert len(set(shuffles)) == len(shuffles)


def test_one_launch_covers_the_batch(entry):
    kernels = entry.kernels()
    assert set(kernels) == {"fused_fit_moments", "ordered_template"}
    assert all(k == {"narch": entry.batch, "shape": entry.shape} for k in kernels.values())


def span(name, start, end, tid=MAIN):
    return tr.Event("user_annotation", name, start, end - start, tid)


def test_batch_preprocess_s_is_the_mean_per_input():
    events = [span(tr.INPUT_SPAN, 0.0, 1.0), span(tr.INPUT_SPAN, 1.0, 2.0),
              span("clean_batch_preprocess", 0.1, 0.5), span("clean_batch_preprocess", 1.1, 1.4),
              span("clean_preprocess", 0.1, 0.3, tid=OTHER),
              span("clean_batch_preprocess", 0.2, 0.9, tid=OTHER)]
    got = harness.reader("batch_preprocess_s")(SimpleNamespace(trace=tr.Trace(events)))
    assert got == pytest.approx((0.4 + 0.3) / 2)
    events = [e for e in events if e.name != "clean_batch_preprocess" or e.tid == OTHER]
    assert harness.reader("batch_preprocess_s")(SimpleNamespace(trace=tr.Trace(events))) is None


def gauges(monkeypatch, labeled):
    from iterative_cleaner_tpu_torch.obs import tracing

    monkeypatch.setattr(tracing, "gauges_snapshot", lambda: ({}, labeled))


def test_batch_peak_over_model(monkeypatch, entry):
    from iterative_cleaner_tpu_torch.parallel.autoshard import batch_working_set_bytes

    gauges(monkeypatch, {("route_hbm_peak_bytes", (("route", "sharded_batch"),)): 3.0e6,
                         ("route_hbm_peak_bytes", (("route", "stepwise"),)): 9.0e9})
    got = harness.reader("batch_peak_over_model")(SimpleNamespace(entry=entry))
    # Off the card the batch resolves the plain route.
    want = batch_working_set_bytes(entry.shape, entry.cfg, False, entry.batch)
    assert got == pytest.approx(100.0 * 3.0e6 / want)


def test_batch_peak_over_model_reads_nothing_without_its_route(monkeypatch, entry):
    gauges(monkeypatch, {("route_hbm_peak_bytes", (("route", "stepwise"),)): 3.0e6})
    assert harness.reader("batch_peak_over_model")(SimpleNamespace(entry=entry)) is None
