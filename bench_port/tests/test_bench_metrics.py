"""The per-layer readers that read the program's counters, on the CPU with
the counters planted."""

from types import SimpleNamespace

import pytest

from bench_port import harness

SHAPE = (16, 64, 128)


def entry(**clean):
    from iterative_cleaner_tpu_torch.config import CleanConfig

    return SimpleNamespace(cfg=CleanConfig(backend="torch", **clean), shape=SHAPE,
                           device="cpu")


def gauges(monkeypatch, labeled):
    from iterative_cleaner_tpu_torch.obs import tracing

    monkeypatch.setattr(tracing, "gauges_snapshot", lambda: ({}, labeled))


@pytest.mark.parametrize("fused", [False, True])
def test_route_peak_over_model(monkeypatch, fused):
    from iterative_cleaner_tpu_torch.parallel.autoshard import clean_working_set_bytes

    e = entry(fused=fused)
    route = "fused" if fused else "stepwise"
    other = "stepwise" if fused else "fused"
    gauges(monkeypatch, {("route_hbm_peak_bytes", (("route", route),)): 3.0e6,
                         ("route_hbm_peak_bytes", (("route", other),)): 9.0e9})
    got = harness.reader("route_peak_over_model")(SimpleNamespace(entry=e))
    # Off the card the router plans the plain route.
    assert got == pytest.approx(100.0 * 3.0e6 / clean_working_set_bytes(SHAPE, e.cfg, False))


def test_route_peak_over_model_reads_nothing_without_its_route(monkeypatch):
    gauges(monkeypatch, {("route_hbm_peak_bytes", (("route", "chunked"),)): 3.0e6})
    assert harness.reader("route_peak_over_model")(SimpleNamespace(entry=entry())) is None
