"""The port's observability layer (``iterative_cleaner_tpu_torch/obs/``,
``utils/device_probe.py``, ``ingest/cas.py``) against the JAX package's, on
the CPU.

The same sequences of registry calls, the same seeded cubes and the same
masks go through both packages: snapshots and the Prometheus exposition
must be equal byte for byte, the quality summary, the forensics counts and
the audit record equal (drift to 1e-6), and a divergence bundle must have
the JAX writer's file set and manifest keys.  Both packages' registries,
event sinks and flight rings are reset around every test.  Also: the
ordered template against the oracle's ``np.einsum`` (bit for bit),
``ICT_HBM_BYTES`` in ``obs.memory`` and ``autoshard``, and the content
addresses of ``ingest/cas.py``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

from iterative_cleaner_tpu.config import CleanConfig as JaxConfig
from iterative_cleaner_tpu.core.cleaner import clean_cube as jax_clean_cube
from iterative_cleaner_tpu.io.synthetic import make_archive as jax_make_archive
from iterative_cleaner_tpu.obs import audit as jax_audit
from iterative_cleaner_tpu.obs import events as jax_events
from iterative_cleaner_tpu.obs import flight as jax_flight
from iterative_cleaner_tpu.obs import forensics as jax_forensics
from iterative_cleaner_tpu.obs import memory as jax_memory
from iterative_cleaner_tpu.obs import metrics as jax_metrics
from iterative_cleaner_tpu.obs import quality as jax_quality
from iterative_cleaner_tpu.obs import tracing as jax_tracing
from iterative_cleaner_tpu.ops.preprocess import preprocess as jax_preprocess
from iterative_cleaner_tpu_torch.backends import numpy_backend as nb
from iterative_cleaner_tpu_torch.backends.torch_backend import TorchCleaner
from iterative_cleaner_tpu_torch.config import CleanConfig
from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
from iterative_cleaner_tpu_torch.ingest import cas
from iterative_cleaner_tpu_torch.models.surgical import SurgicalCleaner
from iterative_cleaner_tpu_torch.obs import (
    audit,
    events,
    flight,
    forensics,
    memory,
    metrics,
    quality,
    tracing,
)
from iterative_cleaner_tpu_torch.ops.template import (
    build_template,
    build_template_plain,
    build_templates,
)
from iterative_cleaner_tpu_torch.parallel import autoshard
from iterative_cleaner_tpu_torch.parallel.chunked import ChunkedTorchCleaner

SEEDS = [3, 42]


@functools.lru_cache(maxsize=None)
def _cube(nsub, nchan, nbin, seed):
    D, w0 = jax_preprocess(jax_make_archive(nsub=nsub, nchan=nchan, nbin=nbin, seed=seed),
                           prefer_native=False)
    D.setflags(write=False)
    w0.setflags(write=False)
    return D, w0


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


# --- tracing + metrics ---


def _drive(mod):
    """One fixed sequence of registry calls."""
    mod.count("service_jobs_done")
    mod.count("service_jobs_done", 2.0)
    mod.count("rfi_zap_fraction_sum", 0.125)
    mod.count_labeled("compiles_total", {"shape_bucket": "8x64x256"})
    mod.count_labeled("compiles_total", {"shape_bucket": "8x64x256"}, 2)
    mod.count_labeled("audit_drift_total", {"route": "stepwise", "le": "+Inf"})
    mod.count_labeled("odd", {"label": 'a"b\\c\nd'})
    mod.set_gauge("host_rss_bytes", 12345678)
    mod.set_gauge("rfi_last_job_zap_frac", 0.0625)
    mod.set_gauge_labeled("hbm_bytes_in_use", {"device": "cuda:0"}, 1 << 30)
    mod.max_gauge_labeled("route_hbm_peak_bytes", {"route": "fused"}, 5.0)
    mod.max_gauge_labeled("route_hbm_peak_bytes", {"route": "fused"}, 3.0)
    for s in (0.0004, 0.003, 0.5, 1.0, 7.25, 100.0):
        mod.observe_phase("online_block", s)
    mod.observe_phase("ingest_upload", 0.02, error=True)
    with pytest.raises(RuntimeError):
        with mod.phase("online_pass"):
            raise RuntimeError("boom")
    with mod.phase("online_pass"):
        pass


class TestTracingAndMetrics:
    def test_registries_and_exposition_equal_jax(self, monkeypatch):
        # phase() reads the wall clock: pin both packages' clocks.
        ticks = iter(np.arange(0.0, 100.0, 0.25))
        clock = lambda: float(next(ticks))  # noqa: E731
        monkeypatch.setattr(tracing.time, "perf_counter", clock)
        _drive(tracing)
        ticks = iter(np.arange(0.0, 100.0, 0.25))
        monkeypatch.setattr(jax_tracing.time, "perf_counter", clock)
        _drive(jax_tracing)
        assert tracing.registry_snapshot() == jax_tracing.registry_snapshot()
        assert tracing.snapshot("online") == jax_tracing.snapshot("online")
        text = metrics.render_prometheus()
        assert text == jax_metrics.render_prometheus()
        fams = metrics.parse_exposition(text)
        assert metrics.render_exposition(fams) == text
        jfams = jax_metrics.parse_exposition(text)
        assert jax_metrics.render_exposition(jfams) == metrics.render_exposition(fams)
        assert [f.name for f in fams] == [f.name for f in jfams]

    def test_constants_match_jax(self):
        assert tracing.HIST_BOUNDS == jax_tracing.HIST_BOUNDS
        assert quality.FRACTION_BOUNDS == jax_quality.FRACTION_BOUNDS
        assert audit.DRIFT_BOUNDS == jax_audit.DRIFT_BOUNDS
        assert audit.AUDIT_DRIFT_BOUND == jax_audit.AUDIT_DRIFT_BOUND == 5e-5
        assert forensics.DIAGNOSTIC_NAMES == jax_forensics.DIAGNOSTIC_NAMES
        assert tracing.shape_bucket_label((8, 64, 256)) == jax_tracing.shape_bucket_label(
            (8, 64, 256)) == "8x64x256"

    def test_delta_and_step_timer(self):
        before = tracing.snapshot()
        tracing.count("x", 3)
        assert tracing.delta(before, "x") == 3 and tracing.delta(before, "y") == 0
        timer = tracing.StepTimer()
        assert timer.lap() >= 0 and len(timer.durations) == 1

    def test_kernel_build_accounting(self):
        # The nvcc build's counterpart of the JAX compile listener.
        with tracing.compile_scope("8x64x256"):
            tracing.observe_kernel_build(2.5)
        tracing.observe_kernel_build(1.0)
        snap = tracing.counters_snapshot()
        assert snap["kernel_build_n"] == 2 and snap["kernel_build_s"] == 3.5
        lab = tracing.labeled_snapshot()
        assert lab[("compiles_total", (("shape_bucket", "8x64x256"),))] == 1
        assert lab[("compile_seconds_total", (("shape_bucket", "unscoped"),))] == 1.0
        assert "ict_phase_duration_seconds_bucket{phase=\"kernel_build\"" in (
            metrics.render_prometheus())

    def test_flight_ring_records_phases_and_events(self, tmp_path):
        tracing.observe_phase("p", 0.5)
        events.emit("something", k=1)
        ring = flight.snapshot()
        assert [r["event"] for r in ring] == ["phase", "something"]
        path = flight.dump("test", str(tmp_path))
        assert json.load(open(path))["reason"] == "test"


# --- events ---


class TestEvents:
    def test_span_nesting_and_sink_like_jax(self, tmp_path):
        def run(mod, sink):
            mod.configure(str(sink))
            with mod.trace_scope("t" * 16):
                with mod.span("outer", a=1):
                    mod.emit("inner", b=2)
            mod.configure(None)
            return [json.loads(line) for line in open(sink)]

        got = run(events, tmp_path / "port.jsonl")
        want = run(jax_events, tmp_path / "jax.jsonl")
        keys = lambda recs: [sorted(r) for r in recs]  # noqa: E731
        assert [r["event"] for r in got] == [r["event"] for r in want] == [
            "outer_start", "inner", "outer_end"]
        assert keys(got) == keys(want)
        assert all(r["trace_id"] == "t" * 16 for r in got)
        assert got[1]["span_id"] == got[0]["span_id"] == got[2]["span_id"]

    def test_disabled_sink_is_a_no_op_but_flight_records(self, tmp_path):
        assert not events.enabled() and events.active()
        events.emit("quiet")
        assert flight.snapshot()[-1]["event"] == "quiet"


# --- quality + forensics on cleaned cubes ---


class TestQualityAndForensics:
    @pytest.mark.parametrize("seed", SEEDS)
    def test_quality_summary_matches_jax(self, seed):
        D, w0 = _cube(16, 64, 128, seed)
        got = clean_cube(D, w0, CleanConfig(backend="torch"), device="cpu")
        want = jax_clean_cube(D, w0, JaxConfig(backend="jax"))
        assert got.quality_summary() == want.quality_summary()
        assert got.quality_summary()["termination"] == got.termination

    def test_record_job_quality_matches_jax(self):
        D, w0 = _cube(16, 64, 128, 42)
        res = clean_cube(D, w0, CleanConfig(backend="numpy"))
        timeline = [{"zaps_by_diagnostic": {"std": 3, "fft": 1}}]
        quality.record_job_quality(res.quality_summary(), timeline)
        jax_quality.record_job_quality(res.quality_summary(), timeline)
        assert tracing.registry_snapshot() == jax_tracing.registry_snapshot()

    @pytest.mark.parametrize("route", [{}, {"fused": True}, {"chunk_block": 4}])
    def test_attribution_on_every_route_matches_jax(self, monkeypatch, route):
        monkeypatch.setenv("ICT_FORENSICS", "1")
        D, w0 = _cube(16, 64, 128, 3)
        got = clean_cube(D, w0, CleanConfig(backend="torch", **route), device="cpu")
        want = jax_clean_cube(D, w0, JaxConfig(backend="jax", **route))
        assert [i.zaps_by_diagnostic for i in got.iterations] == [
            i.zaps_by_diagnostic for i in want.iterations]
        assert all(i.zaps_by_diagnostic for i in got.iterations)
        assert ([forensics.iteration_record(i) | {"duration_s": 0} for i in got.iterations]
                == [jax_forensics.iteration_record(i) | {"duration_s": 0}
                    for i in want.iterations])

    @pytest.mark.parametrize("backend_cls", ["torch", "chunked", "numpy"])
    def test_attribute_from_backend_reaches_every_cube(self, backend_cls):
        # The torch backends hold their cube as a tensor (on the card, the
        # same code copies it to the host) or as a host array.
        D, w0 = _cube(16, 64, 128, 42)
        cfg = CleanConfig(backend="numpy" if backend_cls == "numpy" else "torch")
        be = {"torch": lambda: TorchCleaner(D, w0, cfg, device="cpu"),
              "chunked": lambda: ChunkedTorchCleaner(D, w0, cfg, block=4, device="cpu"),
              "numpy": lambda: nb.NumpyCleaner(D, w0, cfg)}[backend_cls]()
        _, new_w = be.step(w0)
        got = forensics.attribute_from_backend(be, w0, new_w)
        assert got is not None and got == jax_forensics.attribute_zaps(
            D, w0, w0, new_w, JaxConfig())

    def test_no_cube_no_attribution(self):
        assert forensics.attribute_from_backend(object(), None, None) is None

    def test_termination_reasons(self):
        a, b = np.zeros(2), np.ones(2)
        for hist, conv in (([a, b, b], True), ([a, b, a], True), ([a, b], False)):
            assert forensics.termination_reason(conv, hist) == \
                jax_forensics.termination_reason(conv, hist)


# --- audit + repro bundles ---


def _route_cfgs(route):
    return (CleanConfig(backend="torch", audit=True, **route),
            JaxConfig(backend="jax", audit=True, **route))


class TestAudit:
    @pytest.mark.parametrize("route,name", [({}, "stepwise"), ({"fused": True}, "fused"),
                                            ({"chunk_block": 4}, "chunked")])
    def test_record_matches_jax(self, route, name):
        # Both audits judge the port's served mask and scores: the records
        # are the two implementations' verdicts on the same inputs.
        D, w0 = _cube(16, 64, 128, 42)
        pcfg, jcfg = _route_cfgs(route)
        res = clean_cube(D, w0, pcfg, device="cpu")
        assert np.array_equal(res.weights, jax_clean_cube(D, w0, jcfg).weights)
        got, ow = audit.run_audit(D, w0, pcfg, res.weights, res.test_results, route=name)
        want, jow = jax_audit.run_audit(D, w0, jcfg, res.weights, res.test_results,
                                        route=name)
        assert np.array_equal(ow, jow)
        assert sorted(got) == sorted(want)
        for key in set(got) - {"ts", "duration_s", "max_score_drift"}:
            assert got[key] == want[key], key
        assert got["max_score_drift"] == pytest.approx(want["max_score_drift"], abs=1e-6)
        assert got["mask_identical"] and got["drift_within_bound"]
        lab = tracing.labeled_snapshot()
        assert lab[("audit_drift_total", (("le", "+Inf"), ("route", name)))] == 1
        assert tracing.counters_snapshot()["audit_runs"] == 1

    def test_flipped_bit_writes_the_jax_bundle(self, tmp_path, monkeypatch):
        D, w0 = _cube(16, 64, 128, 42)
        pcfg, jcfg = _route_cfgs({})
        res = clean_cube(D, w0, pcfg, device="cpu")
        served = res.weights.copy()
        served[3, 5] = 0.0 if served[3, 5] else 1.0
        rec, ow = audit.run_audit(D, w0, pcfg, served, res.test_results, route="stepwise")
        jrec, jow = jax_audit.run_audit(D, w0, jcfg, served, res.test_results,
                                        route="stepwise")
        assert not rec["mask_identical"] and rec["n_mask_diffs"] == 1
        assert rec["mask_diff_coords"] == jrec["mask_diff_coords"] == [[3, 5]]
        assert tracing.counters_snapshot()["audit_divergences"] == 1
        kw = dict(D=D, w0=w0, reason="flip", weights_served=served, weights_oracle=ow,
                  scores_served=res.test_results, route="stepwise")
        got = audit.write_repro_bundle(str(tmp_path / "port"), cfg=pcfg, record=rec, **kw)
        want = jax_audit.write_repro_bundle(str(tmp_path / "jax"), cfg=jcfg, record=jrec, **kw)
        assert sorted(os.listdir(got)) == sorted(os.listdir(want)) == [
            "arrays.npz", "flight.json", "manifest.json"]
        man, arrays = audit.load_repro_bundle(got)
        jman, jarrays = jax_audit.load_repro_bundle(want)
        assert sorted(man) == sorted(jman)
        assert sorted(arrays) == sorted(jarrays) == man["arrays"]
        assert np.array_equal(arrays["weights_served"], served)
        assert audit.config_from_manifest(man) == pcfg
        assert [b["reason"] for b in audit.list_bundles(str(tmp_path / "port"))] == ["flip"]
        assert audit.audit_report()["divergences"] == 1

    def test_cli_audit_divergence_writes_a_bundle(self, tmp_path, monkeypatch):
        # --audit through SurgicalCleaner: a served mask one bit off the
        # oracle's (the clean made to flip it) is a divergence.
        from iterative_cleaner_tpu_torch.io.synthetic import make_archive
        from iterative_cleaner_tpu_torch.models import surgical

        monkeypatch.setenv("ICT_REPRO_DIR", str(tmp_path / "repro"))
        real = surgical.clean_cube

        def flip_one(*args, **kwargs):
            res = real(*args, **kwargs)
            res.weights = res.weights.copy()
            res.weights[0, 0] = 0.0 if res.weights[0, 0] else 1.0
            return res

        monkeypatch.setattr(surgical, "clean_cube", flip_one)
        out = SurgicalCleaner(CleanConfig(backend="torch", audit=True), device="cpu").clean(
            make_archive(nsub=8, nchan=32, nbin=64, seed=1))
        assert not out.audit["mask_identical"] and out.audit["bundle"]
        assert os.path.isdir(out.audit["bundle"])
        assert audit.list_bundles(str(tmp_path / "repro"))[0]["route"] == "stepwise"

    def test_sampling_knobs_match_jax(self, monkeypatch):
        for val in ("0.25", "7", "-1", "junk"):
            monkeypatch.setenv("ICT_AUDIT_RATE", val)
            assert audit.audit_rate() == jax_audit.audit_rate()
        monkeypatch.setenv("ICT_REPRO_DIR", "/x/y")
        assert audit.default_repro_dir() == jax_audit.default_repro_dir() == "/x/y"


# --- memory ---


class TestMemory:
    def test_hbm_override_is_one_owner(self, monkeypatch):
        monkeypatch.setenv("ICT_HBM_BYTES", str(9 * 10**9))
        assert (memory.device_memory_bytes() == autoshard.device_memory_bytes("cuda")
                == autoshard.device_memory_bytes("cpu") == jax_memory.device_memory_bytes()
                == 9 * 10**9)
        assert memory.hbm_override_bytes() == jax_memory.hbm_override_bytes()
        monkeypatch.delenv("ICT_HBM_BYTES")
        assert memory.device_memory_bytes("cpu") is None
        assert autoshard.device_memory_bytes("cpu") is None

    def test_no_card_no_device_view(self):
        assert not memory.backend_live() and memory.device_snapshot() == []
        memory.observe_route("stepwise")   # a no-op, never raises
        memory.update_process_gauges()
        gauges, labeled = tracing.gauges_snapshot()
        assert gauges["host_rss_bytes"] > 0 and labeled == {}
        assert memory.memory_report()["host_rss_bytes"] > 0
        assert memory.device_stats("cpu") is None


# --- the ordered template ---


class TestOrderedTemplate:
    @pytest.mark.parametrize("shape", [(5, 33, 100), (8, 64, 257), (3, 7, 31), (16, 32, 2)])
    def test_bit_identical_to_the_oracle(self, shape):
        rng = np.random.default_rng(sum(shape))
        D = rng.standard_normal(shape, dtype=np.float32) * 5
        w = rng.random(shape[:2]).astype(np.float32)
        w[rng.random(shape[:2]) < 0.2] = 0.0
        want = nb.build_template(D, w)
        got = build_template(torch.from_numpy(D), torch.from_numpy(w)).numpy()
        assert np.array_equal(got, want)
        cut = shape[0] // 2
        half = build_template_plain(torch.from_numpy(D[:cut]), torch.from_numpy(w[:cut]))
        rest = build_template(torch.from_numpy(D[cut:]), torch.from_numpy(w[cut:]), init=half)
        assert np.array_equal(rest.numpy(), want)

    def test_non_finite_profiles_as_the_oracle(self):
        D, w0 = _cube(8, 64, 128, 42)
        D = D.copy()
        D[1, 2, 7], D[3, 4, 9] = np.inf, np.nan
        got = build_template(torch.from_numpy(D), torch.from_numpy(w0)).numpy()
        np.testing.assert_array_equal(got, nb.build_template(D, w0))

    def test_batch_is_each_archive_alone(self):
        D, w0 = _cube(8, 64, 128, 3)
        Db = torch.from_numpy(np.stack([D, 2 * D, -D]))
        wb = torch.from_numpy(np.stack([w0, w0, np.ones_like(w0)]))
        tb = build_templates(Db, wb)
        for j in range(3):
            assert torch.equal(tb[j], build_template(Db[j], wb[j]))
        assert torch.equal(build_template(Db, wb), tb)
        # The sweep's stride-0 pair axis goes archive by archive.
        assert torch.equal(build_templates(Db[:1].expand(2, *Db.shape[1:]), wb[:2])[1],
                           build_template(Db[0], wb[1]))

    def test_chunked_template_is_the_in_memory_one(self):
        D, w0 = _cube(16, 64, 128, 42)
        be = ChunkedTorchCleaner(D, w0, CleanConfig(backend="torch"), block=3, device="cpu")
        got = be._template(torch.from_numpy(w0.copy()))
        assert np.array_equal(got.numpy(), nb.build_template(D, w0))

    def test_plain_version_counts_no_launch(self):
        before = build_template.launches
        D, w0 = _cube(8, 64, 128, 3)
        build_template(torch.from_numpy(D), torch.from_numpy(w0))
        assert build_template.launches == before

    def test_wrapper_rejects_other_devices(self):
        with pytest.raises(ValueError, match="cuda or cpu"):
            build_template(torch.zeros((2, 3, 4), device="meta"),
                             torch.zeros((2, 3), device="meta"))


# --- content addressing ---


class TestCas:
    def test_salt_covers_the_mask_fields_only(self, monkeypatch):
        base = CleanConfig()
        salt = cas.cache_salt(base)
        assert salt == cas.cache_salt(CleanConfig()) and len(salt) == 16
        assert salt != cas.cache_salt(CleanConfig(chanthresh=4.0))
        assert salt == cas.cache_salt(CleanConfig(backend="torch", fused=True))
        monkeypatch.setenv("ICT_CACHE_SALT", "flush")
        assert cas.cache_salt(base) != salt

    def test_cube_key_and_file_digest(self, tmp_path):
        D, w0 = _cube(8, 64, 128, 3)
        cfg = CleanConfig()
        assert cas.cube_key(D, w0, cfg) == cas.cube_key(D.copy(), w0.copy(), cfg)
        assert cas.cube_key(D, w0, cfg) != cas.cube_key(D.reshape(4, 128, 128), w0, cfg)
        p = tmp_path / "f.bin"
        p.write_bytes(b"abc")
        import hashlib

        assert cas.file_digest(str(p)) == hashlib.sha256(b"abc").hexdigest()
        assert cas.file_digest(str(tmp_path / "missing")) == ""


def test_config_fields_cover_the_jax_bundle_config():
    # A JAX bundle's config maps onto the port's CleanConfig field for field
    # (pallas -> kernel), trace_dir included.
    jax_fields = {f.name for f in dataclasses.fields(JaxConfig)}
    port_fields = {f.name for f in dataclasses.fields(CleanConfig)}
    assert jax_fields - {"pallas"} == port_fields - {"kernel"}
