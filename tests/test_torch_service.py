"""The port's serving replica against the JAX package's, on the CPU.

``iterative_cleaner_tpu_torch.service`` runs with ``device="cpu"`` here
(the kernels' plain versions): jobs over real HTTP come back with masks
bit-identical to the numpy oracle and to the JAX daemon's (its jax backend
on the CPU); a session's alerts and final mask equal the JAX
``SessionManager``'s; one daemon's spool replays in the other's; the fault
ladder, the admission cap, ``--root``, the single-daemon lock and restart
resume behave as the JAX daemon's tests pin them; and the pieces under the
daemon (scheduler, spool, backoff, result cache, costs, the shadow auditor)
match their JAX counterparts case for case.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from iterative_cleaner_tpu.config import CleanConfig as JaxConfig
from iterative_cleaner_tpu.obs import costs as jax_costs
from iterative_cleaner_tpu.online.blocks import encode_block as jax_encode_block
from iterative_cleaner_tpu.parallel.mesh import make_mesh as jax_make_mesh
from iterative_cleaner_tpu.service import CleaningService as JaxService
from iterative_cleaner_tpu.service import ServeConfig as JaxServeConfig
from iterative_cleaner_tpu.service import jobs as jax_jobs
from iterative_cleaner_tpu.service import results_cache as jax_results_cache
from iterative_cleaner_tpu.service import scheduler as jax_scheduler
from iterative_cleaner_tpu.service.pool import warm_batch_sizes as jax_warm_batch_sizes
from iterative_cleaner_tpu.service.sessions import SessionManager as JaxSessionManager
from iterative_cleaner_tpu.utils import backoff as jax_backoff
from iterative_cleaner_tpu_torch.config import CleanConfig
from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
from iterative_cleaner_tpu_torch.io.npz import NpzIO
from iterative_cleaner_tpu_torch.io.synthetic import make_archive
from iterative_cleaner_tpu_torch.models.surgical import finalize_weights
from iterative_cleaner_tpu_torch.obs import audit as obs_audit
from iterative_cleaner_tpu_torch.obs import costs as obs_costs
from iterative_cleaner_tpu_torch.obs import memory as obs_memory
from iterative_cleaner_tpu_torch.obs import tracing
from iterative_cleaner_tpu_torch.online.blocks import encode_block
from iterative_cleaner_tpu_torch.online.state import SessionMeta
from iterative_cleaner_tpu_torch.ops import fused_kernels as fk
from iterative_cleaner_tpu_torch.ops.preprocess import preprocess
from iterative_cleaner_tpu_torch.parallel.autoshard import batch_working_set_bytes
from iterative_cleaner_tpu_torch.service import CleaningService, ServeConfig
from iterative_cleaner_tpu_torch.service import daemon, results_cache, scheduler
from iterative_cleaner_tpu_torch.service.jobs import TERMINAL, Job, JobSpool
from iterative_cleaner_tpu_torch.service.pool import WarmPool, warm_batch_sizes
from iterative_cleaner_tpu_torch.service.sessions import SessionManager
from iterative_cleaner_tpu_torch.utils import backoff

REPO = Path(__file__).resolve().parent.parent
MAX_ITER = 3


def _write(tmp_path, name, nsub=8, seed=0):
    p = str(tmp_path / name)
    NpzIO().save(make_archive(nsub=nsub, nchan=16, nbin=64, seed=seed), p)
    return p


def _clean_cfg(**kw):
    return CleanConfig(backend="torch", max_iter=MAX_ITER, quiet=True, no_log=True, **kw)


def _serve_cfg(tmp_path, **kw):
    defaults = dict(spool_dir=str(tmp_path / "spool"), port=0, deadline_s=0.2, quiet=True,
                    retry_backoff_s=0.01, device="cpu", clean=_clean_cfg())
    defaults.update(kw)
    return ServeConfig(**defaults)


def _start(tmp_path, **kw):
    svc = CleaningService(_serve_cfg(tmp_path, **kw))
    svc.start()
    return svc


def _start_jax(tmp_path, **kw):
    defaults = dict(spool_dir=str(tmp_path / "spool"), port=0, deadline_s=0.2, quiet=True,
                    retry_backoff_s=0.01,
                    clean=JaxConfig(backend="jax", max_iter=MAX_ITER, quiet=True, no_log=True))
    defaults.update(kw)
    svc = JaxService(JaxServeConfig(**defaults),
                     mesh=jax_make_mesh(1, devices=jax.devices("cpu")[:1]))
    svc.start()
    return svc


def _request(svc, route, body=None, method=None):
    data = None if body is None else (body if isinstance(body, bytes)
                                      else json.dumps(body).encode())
    req = urllib.request.Request(f"http://127.0.0.1:{svc.port}{route}", data=data,
                                 method=method)
    return json.load(urllib.request.urlopen(req, timeout=30))


def _status(svc, route, body=None):
    """The HTTP error code of a request expected to fail."""
    with pytest.raises(urllib.error.HTTPError) as exc_info:
        _request(svc, route, body)
    return exc_info.value


def _oracle(path):
    """The oracle's final mask, loops and converged for an archive."""
    cfg = CleanConfig(backend="numpy", max_iter=MAX_ITER)
    res = clean_cube(*preprocess(NpzIO().load(path)), cfg)
    return finalize_weights(res.weights, cfg)[0], res.loops, res.converged


def _counters_delta(before):
    """``d(key)``: how far the counter ``key`` moved since ``before``."""
    return lambda k: tracing.counters_snapshot().get(k, 0) - before.get(k, 0)


# --- units, each against its JAX counterpart ---


@pytest.mark.parametrize("cap", [1, 2, 3, 4, 8])
def test_pow2_chunks_and_warm_sizes_match_jax(cap):
    assert warm_batch_sizes(cap) == jax_warm_batch_sizes(cap)
    for n in range(1, 3 * cap + 2):
        chunks = scheduler.pow2_chunks(n, cap)
        assert chunks == jax_scheduler.pow2_chunks(n, cap)
        assert sum(chunks) == n and set(chunks) <= set(warm_batch_sizes(cap))


class TestScheduler:
    def _entry(self, nsub=4):
        D = np.zeros((nsub, 3, 8), np.float32)
        return (Job(id="j", path="x"), None, D, np.zeros((nsub, 3), np.float32))

    def test_full_bucket_flushes_immediately(self):
        flushed = []
        s = scheduler.ShapeBucketScheduler(2, 999.0, flushed.append)
        s.offer(*self._entry())
        assert flushed == [] and s.pending_count() == 1
        assert s.pending_by_bucket() == {"4x3x8": 1}
        s.offer(*self._entry())
        assert len(flushed) == 1 and len(flushed[0]) == 2
        assert s.pending_count() == 0

    def test_deadline_flush_chunks_pow2(self):
        flushed = []
        s = scheduler.ShapeBucketScheduler(4, 1.0, flushed.append)
        for _ in range(3):
            s.offer(*self._entry())
        t0 = s._buckets[(4, 3, 8)][0].arrived_s
        s.tick(now=t0 + 0.5)
        assert flushed == []
        s.tick(now=t0 + 2.0)
        assert [len(g) for g in flushed] == [2, 1]

    def test_shapes_never_mix(self):
        flushed = []
        s = scheduler.ShapeBucketScheduler(2, 999.0, flushed.append)
        s.offer(*self._entry(nsub=4))
        s.offer(*self._entry(nsub=6))
        assert flushed == [] and s.pending_count() == 2
        s.flush_all()
        assert sorted(e.D.shape[0] for g in flushed for e in g) == [4, 6]

    @pytest.mark.parametrize("cap, coalesce", [(1, 1), (3, 1), (3, 3), (4, 2), (5, 7)])
    def test_clamps_match_jax(self, cap, coalesce):
        ours = scheduler.ShapeBucketScheduler(cap, 1.0, list, coalesce=coalesce)
        theirs = jax_scheduler.ShapeBucketScheduler(cap, 1.0, list, coalesce=coalesce)
        assert (ours.dp_cap, ours.coalesce, ours.bucket_cap) == \
            (theirs.dp_cap, theirs.coalesce, theirs.bucket_cap)


class TestJobSpool:
    def test_foreign_json_never_crashes_the_replay(self, tmp_path):
        spool = JobSpool(str(tmp_path / "spool"))
        ok = spool.create("good.npz")
        for name, text in (("note.json", '{"comment": "hi"}'), ("list.json", "[]"),
                           ("junk.json", "not json"),
                           ("evil.json", '{"id": "../escape", "path": "x", "state": "running"}'),
                           ("alias.json", '{"id": "other", "path": "x", "state": "running"}')):
            (tmp_path / "spool" / name).write_text(text + "\n")
        assert [j.id for j in JobSpool(str(tmp_path / "spool")).recover()] == [ok.id]

    def test_job_id_cannot_escape_the_spool(self, tmp_path):
        (tmp_path / "secret.json").write_text('{"id": "x", "path": "leak"}\n')
        spool = JobSpool(str(tmp_path / "spool"))
        for bad in ("../secret", "a/../../secret", "/etc/passwd", ".hidden"):
            assert spool.get(bad) is None
        with pytest.raises(ValueError):
            spool.save(Job(id="../escape", path="x"))

    def test_trim_prunes_old_terminal_only(self, tmp_path):
        spool = JobSpool(str(tmp_path / "spool"))
        jobs = []
        for i in range(4):
            jobs.append(spool.create(f"{i}.npz"))
            time.sleep(0.002)
        for j in jobs[:3]:
            j.state = "done"
            spool.save(j)
        orphan = tmp_path / "spool" / "dead.json.part"
        orphan.write_text("{")
        assert spool.trim(keep_terminal=1) == 2
        assert {j.id for j in spool.all_jobs()} == {jobs[2].id, jobs[3].id}
        assert not orphan.exists()

    def test_roundtrip_and_recover(self, tmp_path):
        spool = JobSpool(str(tmp_path / "spool"))
        a = spool.create("a.npz")
        time.sleep(0.002)
        b = spool.create("b.npz")
        time.sleep(0.002)
        done = spool.create("c.npz")
        b.state = "running"
        spool.save(b)
        done.state = "done"
        spool.save(done)
        again = JobSpool(str(tmp_path / "spool"))
        assert [j.id for j in again.recover()] == [a.id, b.id]
        assert again.get(done.id).state == "done" and again.get("nope") is None

    def test_job_fields_match_jax(self):
        ours = [(f.name, f.default) for f in dataclasses.fields(Job)]
        theirs = [(f.name, f.default) for f in dataclasses.fields(jax_jobs.Job)]
        assert ours == theirs and jax_jobs.TERMINAL == TERMINAL

    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_manifests_read_across_packages(self, tmp_path, writer):
        spools = {"port": JobSpool(str(tmp_path / "s")), "jax": jax_jobs.JobSpool(str(tmp_path / "s"))}
        job = spools[writer].create("/data/a.npz")
        job.state, job.loops, job.cost = "done", 3, {"device_s": 0.25, "phases": {"emit": 0.1}}
        job.timeline = [{"index": 1, "diff_weights": 4}]
        spools[writer].save(job)
        reader = spools["jax" if writer == "port" else "port"]
        back = reader.get(job.id)
        assert dataclasses.asdict(back) == dataclasses.asdict(job)
        with open(tmp_path / "s" / f"{job.id}.json") as fh:
            raw = fh.read()
        reader.save(back)
        with open(tmp_path / "s" / f"{job.id}.json") as fh:
            assert fh.read() == raw


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_backoff_same_draws_as_jax(monkeypatch, seed):
    monkeypatch.setenv("ICT_BACKOFF_SEED", str(seed))
    ours, theirs = backoff.make_rng(), jax_backoff.make_rng()
    for attempt in range(-1, 70):
        a = backoff.full_jitter(0.25, attempt, cap_s=5.0, rng=ours)
        assert a == jax_backoff.full_jitter(0.25, attempt, cap_s=5.0, rng=theirs)
        assert 0.0 <= a <= 5.0
    assert backoff.DEFAULT_CAP_S == jax_backoff.DEFAULT_CAP_S


class TestResultCache:
    def _put(self, cache, key, seed=0):
        w = np.random.default_rng(seed).random((4, 16)).astype(np.float32)
        cache.put(key, w, loops=2, converged=True, rfi_frac=0.125,
                  termination="fixed_point", origin_job_id=f"job-{key}")
        return w

    def test_lru_and_disabled(self, tmp_path):
        off = results_cache.ResultCache(0, root=str(tmp_path / "off"))
        self._put(off, "k")
        assert not off.enabled and off.get("k") is None and not (tmp_path / "off").exists()
        cache = results_cache.ResultCache(2)
        for k in "abc":
            self._put(cache, k)
        assert len(cache) == 2 and cache.get("a") is None and cache.get("c") is not None

    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_disk_tier_reads_across_packages_and_restarts(self, tmp_path, writer):
        mod = results_cache if writer == "port" else jax_results_cache
        other = jax_results_cache if writer == "port" else results_cache
        root = str(tmp_path / "rc")
        w = self._put(mod.ResultCache(4, root=root), "deadbeef")
        rec = other.ResultCache(4, root=root).get("deadbeef")
        assert rec is not None and rec["weights"].tobytes() == w.tobytes()
        assert (rec["loops"], rec["converged"], rec["rfi_frac"], rec["termination"],
                rec["origin_job_id"]) == (2, True, 0.125, "fixed_point", "job-deadbeef")

    def test_disk_sweep_and_corrupt_entry(self, tmp_path):
        root = tmp_path / "rc"
        cache = results_cache.ResultCache(1, root=str(root))
        for i, k in enumerate("abcd"):
            self._put(cache, k, seed=i)
            time.sleep(0.01)
        assert len(list(root.glob("*.npz"))) <= 2 * results_cache.DISK_KEEP_FACTOR
        (root / "bad.npz").write_bytes(b"not a zip")
        assert results_cache.ResultCache(1, root=str(root)).get("bad") is None
        assert not (root / "bad.npz").exists()


def _cost_job(mod, jid, tenant="", shape=(4, 16, 64), state="done", served_by="sharded"):
    job = mod.Job(id=jid, path=f"/tmp/{jid}.npz", tenant=tenant, state=state,
                  served_by=served_by)
    job.shape = list(shape)
    return job


class TestCostsMatchJax:
    def _scenario(self, costs_mod, jobs_mod, tmp_path):
        tmp_path.mkdir(parents=True)
        jobs = [_cost_job(jobs_mod, f"j{i}", tenant="t1" if i % 2 else "") for i in range(4)]
        costs_mod.add_dispatch_share(jobs, 2.0, compile_s=0.4)
        costs_mod.add_dispatch_share(jobs[:2], 1.0)
        for j in jobs:
            costs_mod.add_phase(j, "emit", 0.01)
        costs_mod.add_exec_share(jobs, {"bytes_accessed": 8e9, "flops": 2e9}, 2.0)
        hit = _cost_job(jobs_mod, "hit", served_by="cache")
        costs_mod.add_cache_hit(hit, jobs[0].cost)
        failed = _cost_job(jobs_mod, "bad", state="error", served_by="")
        costs_mod.add_cache_hit(failed, jobs[1].cost)
        ledger = costs_mod.CostLedger(str(tmp_path / "costs.json"), replica_id="r-1")
        for j in (*jobs, hit, failed):
            ledger.record(costs_mod.finalize(j))
        ledger.flush()
        resumed = costs_mod.CostLedger(str(tmp_path / "costs.json"), replica_id="r-1")
        return [j.cost for j in (*jobs, hit, failed)], ledger.report(), resumed.report()

    def test_records_ledger_and_resume(self, tmp_path, monkeypatch):
        monkeypatch.setenv("ICT_ROOFLINE_GBPS", "100")
        from iterative_cleaner_tpu.service import jobs as jjobs
        from iterative_cleaner_tpu_torch.service import jobs as pjobs

        ours = self._scenario(obs_costs, pjobs, tmp_path / "port")
        theirs = self._scenario(jax_costs, jjobs, tmp_path / "jax")
        assert ours == theirs
        assert ours[2]["resumed"] and ours[2]["totals"]["jobs"] == 6
        assert (tmp_path / "port" / "costs.json").read_text() == \
            (tmp_path / "jax" / "costs.json").read_text()

    @pytest.mark.parametrize("text", ['{"totals": {"device_s": "x", "jobs": null}}', "[]",
                                      "not json"])
    def test_schema_drift_degrades_like_jax(self, tmp_path, text):
        p = tmp_path / "costs.json"
        p.write_text(text)
        ours = obs_costs.CostLedger(str(p)).report()
        theirs = jax_costs.CostLedger(str(p)).report()
        assert ours == theirs

    def test_attainment_math_matches_jax(self, monkeypatch):
        # Without a reference each package reads its own ingest pipeline's
        # measured rate; the operator's ICT_ROOFLINE_GBPS pins one for both.
        monkeypatch.setenv("ICT_ROOFLINE_GBPS", "2.5")
        for args in ((8e9, 2.0, 4.0), (0, 1.0, 1.0), (1e9, 0, 1.0), (1e9, 1.0, None)):
            assert obs_costs.attainment_ratio(*args) == jax_costs.attainment_ratio(*args)
        assert obs_costs.reference_gbps() == jax_costs.reference_gbps() == 2.5

    def test_attainment_on_the_card(self, monkeypatch):
        # The card's figure: every iteration's bytes against the pinned
        # rate alone, never against the host's staged GB/s.
        from iterative_cleaner_tpu_torch.service import jobs as pjobs

        analysis = {"bytes_accessed": 8e9, "flops": 2e9}
        monkeypatch.delenv("ICT_ROOFLINE_GBPS", raising=False)
        monkeypatch.setattr(obs_costs, "reference_gbps", lambda: 1.0)
        jobs = [_cost_job(pjobs, f"c{i}") for i in range(2)]
        assert obs_costs.add_exec_share(jobs, analysis, 2.0, iterations=5, on_card=True) is None
        assert jobs[0].cost["attainment"] is None
        assert jobs[0].cost["bytes_accessed"] == 4e9
        assert obs_costs.add_exec_share(jobs, analysis, 2.0) == 4.0   # the JAX rule
        monkeypatch.setenv("ICT_ROOFLINE_GBPS", "3350")
        jobs = [_cost_job(pjobs, f"d{i}") for i in range(2)]
        got = obs_costs.add_exec_share(jobs, analysis, 2.0, iterations=5, on_card=True)
        assert got == pytest.approx(8e9 * 5 / 2.0 / 3350e9)
        assert jobs[1].cost["attainment"] == round(got, 6)


class TestBucketCostModel:
    def test_kernel_bytes_and_peak(self, monkeypatch):
        monkeypatch.delenv("ICT_EXEC_ANALYSIS", raising=False)
        cfg = _clean_cfg()
        shape = (3, 5, 7, 64)
        got = obs_memory.analyze_batch_route(shape, cfg)
        n, p = 3 * 5 * 7 * 64, 3 * 5 * 7
        assert got["bytes_accessed"] == (8 * n + 17 * p + 4 * 3 * 64 + 4 * 64 + 4 * 3) \
            + (4 * n + 4 * p + 4 * 3 * 64)
        assert got["flops"] == 14 * n
        assert got["peak_bytes"] == batch_working_set_bytes((5, 7, 64), cfg, True, 3)
        assert obs_memory.analyze_batch_route(shape, cfg) == got
        assert "3x5x7x64" in obs_memory.memory_report()["executables"]
        monkeypatch.setenv("ICT_EXEC_ANALYSIS", "0")
        assert obs_memory.analyze_batch_route((1, 2, 3, 4), cfg) is None

    def test_gauges_follow_the_dispatch_not_the_memo(self, monkeypatch):
        # A bucket an earlier clean in the process analyzed: after a
        # registry reset its next dispatch publishes the gauges again,
        # whatever ran before in the process.
        monkeypatch.delenv("ICT_EXEC_ANALYSIS", raising=False)
        cfg, shape = _clean_cfg(), (2, 5, 7, 64)
        got = obs_memory.analyze_batch_route(shape, cfg)
        tracing.reset_counters()
        assert obs_memory.analyze_batch_route(shape, cfg) == got
        _, labeled = tracing.gauges_snapshot()
        labels = (("shape_bucket", "2x5x7x64"),)
        assert {k: labeled[(f"executable_{k}", labels)] for k in got} == {
            k: float(v) for k, v in got.items()}


class TestShadowAuditor:
    def test_sampling(self):
        assert obs_audit.should_audit(True, 0.0) and obs_audit.should_audit(False, 1.0)
        assert not obs_audit.should_audit(False, 0.0)

    def test_audit_and_divergence(self, tmp_path):
        D, w0 = preprocess(make_archive(nsub=4, nchan=16, nbin=64, seed=5))
        cfg = _clean_cfg()
        res = clean_cube(D, w0, obs_audit.oracle_config(cfg))
        spool = JobSpool(str(tmp_path / "spool"))
        seen = []
        aud = obs_audit.ShadowAuditor(spool, str(tmp_path / "repro"),
                                      on_divergence=seen.append, quiet=True)
        aud.start()
        try:
            good, bad = spool.create("good"), spool.create("bad")
            good.state = bad.state = "done"
            wrong = res.weights.copy()
            wrong[0, 0] = 1.0 - (wrong[0, 0] != 0)
            assert aud.submit(good, D, w0, res.weights, res.test_results, "sharded", cfg)
            assert aud.submit(bad, D, w0, wrong, None, "sharded", cfg)
            assert aud.drain(60)
        finally:
            aud.stop()
            aud.join(timeout=30)
        assert not aud.is_alive()
        assert good.audit_result["mask_identical"] and good.audit_result["drift_within_bound"]
        assert not bad.audit_result["mask_identical"] and len(seen) == 1
        assert os.path.isdir(bad.audit_result["bundle"])
        assert spool.get(bad.id).audit_result["n_mask_diffs"] == 1


def test_tile_counters_one_pair_under_many_threads(monkeypatch):
    # The dispatch worker and the session passes may make a stream's first
    # launch together: they must share one pair of counters.
    monkeypatch.setattr(fk, "_COUNTERS", {})
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    got, barrier = [], threading.Barrier(16)

    def grab():
        barrier.wait(timeout=30)
        got.append(fk._tile_counters(torch.device("cpu"), 5))

    try:
        threads = [threading.Thread(target=grab) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
    finally:
        sys.setswitchinterval(prev)
    assert not any(th.is_alive() for th in threads)
    assert len(got) == 16 and all(c is got[0] for c in got)


# --- the daemon on the CPU ---


def test_daemon_end_to_end_mixed_shapes(tmp_path):
    """Two shapes and a corrupt archive over real HTTP: oracle-identical
    masks, per-job failure isolation, the inspection endpoints."""
    a0, a1 = _write(tmp_path, "a0.npz", seed=50), _write(tmp_path, "a1.npz", seed=51)
    b0 = _write(tmp_path, "b0.npz", nsub=4, seed=52)
    corrupt = str(tmp_path / "corrupt.npz")
    Path(corrupt).write_bytes(b"not an archive")
    d = _counters_delta(tracing.counters_snapshot())
    svc = _start(tmp_path, bucket_cap=2, deadline_s=1.0)
    try:
        jobs = {p: _request(svc, "/jobs", {"path": p}) for p in (a0, a1, b0, corrupt)}
        assert all(j["state"] == "pending" and j["replica_id"] == svc.replica_id
                   for j in jobs.values())
        assert svc.drain(180)
        for p in (a0, a1, b0):
            got = _request(svc, f"/jobs/{jobs[p]['id']}")
            assert got["state"] == "done" and got["served_by"] == "sharded"
            w, loops, converged = _oracle(p)
            assert NpzIO().load(got["out_path"]).weights.tobytes() == w.tobytes()
            assert (got["loops"], got["converged"]) == (loops, converged)
            assert got["cost"]["route"] == "sharded" and got["exec_analysis"]["peak_bytes"] > 0
            trace = _request(svc, f"/jobs/{jobs[p]['id']}/trace")
            assert trace["replica_id"] == svc.replica_id
        bad = _request(svc, f"/jobs/{jobs[corrupt]['id']}")
        assert bad["state"] == "error" and "load failed" in bad["error"]
        health = _request(svc, "/healthz")
        assert health["status"] == "ok" and health["backend"] == "torch"
        assert health["open_jobs"] == 0 and health["bucket_cap"] == 2
        assert d("service_jobs_submitted") == 4
        assert d("service_jobs_done") == 3 and d("service_jobs_error") == 1
        assert d("service_coalesced_dispatches") >= 1
        assert "ict_service_dispatch_n" in urllib.request.urlopen(
            f"http://127.0.0.1:{svc.port}/metrics", timeout=30).read().decode()
        # a load failure never reaches the dispatch worker: no cost record
        assert _request(svc, "/costs")["totals"]["jobs"] == 3
        for route in ("/debug/memory", "/debug/flight", "/debug/audit", "/debug/profiles"):
            assert isinstance(_request(svc, route), dict)
        assert _status(svc, "/jobs/nope").code == 404
        assert _status(svc, "/nothing").code == 404
        for body in (b"[]", b"5", b"{}", b"not json"):
            assert _status(svc, "/jobs", body).code == 400
        with svc._jobs_lock:
            assert svc._jobs == {}
    finally:
        svc.stop()


def test_masks_and_loops_match_the_jax_daemon(tmp_path):
    paths = [_write(tmp_path, f"p{i}.npz", nsub=n, seed=s)
             for i, (n, s) in enumerate([(8, 61), (8, 62), (4, 63)])]
    served = {}
    for name, start in (("port", _start), ("jax", _start_jax)):
        svc = start(tmp_path / name, bucket_cap=2, deadline_s=0.5)
        try:
            ids = [_request(svc, "/jobs", {"path": p})["id"] for p in paths]
            assert svc.drain(300)
            served[name] = [_request(svc, f"/jobs/{i}") for i in ids]
        finally:
            svc.stop()
    for ours, theirs in zip(served["port"], served["jax"]):
        assert ours["state"] == theirs["state"] == "done"
        assert ours["served_by"] == theirs["served_by"] == "sharded"
        for key in ("loops", "converged", "rfi_frac", "termination", "quality"):
            assert ours[key] == theirs[key], key
        assert ours["content_key"] == "" or len(ours["content_key"]) == 64
        assert NpzIO().load(ours["out_path"]).weights.tobytes() == \
            NpzIO().load(theirs["out_path"]).weights.tobytes()
        assert ours["out_path"] == theirs["out_path"]


def test_second_daemon_on_one_spool_is_refused(tmp_path):
    svc = _start(tmp_path)
    try:
        dup = CleaningService(_serve_cfg(tmp_path, clean=CleanConfig(backend="numpy")))
        with pytest.raises(RuntimeError, match="already served"):
            dup.start()
        with pytest.raises(RuntimeError, match="already served"):
            JaxService(JaxServeConfig(spool_dir=str(tmp_path / "spool"), port=0, quiet=True,
                                      clean=JaxConfig(backend="numpy"))).start()
    finally:
        svc.stop()
    _start(tmp_path).stop()


def test_failed_start_releases_the_flock(tmp_path):
    import socket

    blocker = socket.socket()
    blocker.bind(("127.0.0.1", 0))
    blocker.listen(1)
    try:
        bad = CleaningService(_serve_cfg(tmp_path, port=blocker.getsockname()[1],
                                         clean=CleanConfig(backend="numpy")))
        with pytest.raises(OSError):
            bad.start()
    finally:
        blocker.close()
    _start(tmp_path).stop()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_spool_of_one_daemon_replays_in_the_other(tmp_path, writer):
    """Jobs a daemon accepted before it died (one mid-dispatch) are served
    by the next daemon on the spool, whichever package either is."""
    p1, p2 = _write(tmp_path, "r1.npz", nsub=4, seed=70), _write(tmp_path, "r2.npz", nsub=4, seed=71)
    spool = (JobSpool if writer == "port" else jax_jobs.JobSpool)(str(tmp_path / "spool"))
    j1 = spool.create(p1)
    j2 = spool.create(p2)
    j2.state = "running"
    spool.save(j2)
    reader = _start_jax if writer == "port" else _start
    d = _counters_delta(tracing.counters_snapshot())
    svc = reader(tmp_path)
    try:
        assert svc.drain(300)
        for j, p in ((j1, p1), (j2, p2)):
            got = spool.get(j.id)
            assert got.state == "done" and got.served_by == "sharded"
            assert NpzIO().load(got.out_path).weights.tobytes() == _oracle(p)[0].tobytes()
    finally:
        svc.stop()
    if reader is _start:
        assert d("service_jobs_recovered") == 2


def test_dispatch_failure_degrades_to_oracle_and_demotes(tmp_path, monkeypatch):
    from iterative_cleaner_tpu_torch.service.worker import DispatchWorker

    def boom(self, entries):
        raise RuntimeError("synthetic backend failure")

    monkeypatch.setattr(DispatchWorker, "_dispatch_sharded", boom)
    p = _write(tmp_path, "f1.npz", nsub=4, seed=80)
    d = _counters_delta(tracing.counters_snapshot())
    svc = _start(tmp_path, dispatch_retries=1, demote_after=1)
    try:
        job = _request(svc, "/jobs", {"path": p})
        assert svc.drain(120)
        got = _request(svc, f"/jobs/{job['id']}")
        assert got["state"] == "done" and got["served_by"] == "oracle-fallback"
        assert got["attempts"] == 2
        assert NpzIO().load(got["out_path"]).weights.tobytes() == _oracle(p)[0].tobytes()
        assert _request(svc, "/healthz")["backend"] == "numpy"
        for key in ("service_dispatch_retries", "service_oracle_fallbacks",
                    "service_backend_demotions"):
            assert d(key) > 0, key
    finally:
        svc.stop()


def test_dispatch_failure_on_the_card_fails_the_jobs(tmp_path, monkeypatch):
    """A replica on the card (``ctx.on_card``, set here by hand on a CPU
    replica) fails a bucket that keeps raising and keeps its backend: no
    oracle fallback, no demotion, however often it fails."""
    from iterative_cleaner_tpu_torch.service.worker import DispatchWorker

    def boom(self, entries):
        raise RuntimeError("synthetic kernel launch failure")

    monkeypatch.setattr(DispatchWorker, "_dispatch_sharded", boom)
    paths = [_write(tmp_path, f"c{i}.npz", nsub=4, seed=81 + i) for i in range(2)]
    d = _counters_delta(tracing.counters_snapshot())
    svc = _start(tmp_path, dispatch_retries=1, demote_after=1)
    svc.ctx.on_card = True
    try:
        for p in paths:      # two buckets: twice demote_after
            job = _request(svc, "/jobs", {"path": p})
            assert svc.drain(120)
            got = _request(svc, f"/jobs/{job['id']}")
            assert got["state"] == "error" and got["attempts"] == 2
            assert "synthetic kernel launch failure" in got["error"]
            assert not got.get("out_path")
        assert _request(svc, "/healthz")["backend"] == "torch"
        assert d("service_dispatch_retries") == 2
        assert d("service_jobs_error") == 2
        for key in ("service_oracle_fallbacks", "service_backend_demotions"):
            assert d(key) == 0, key
    finally:
        svc.stop()


def test_hung_probe_on_the_card_refuses_to_start(tmp_path, monkeypatch):
    """The JAX daemon demotes to numpy after a hung device probe; a
    replica on the card refuses to start and releases the spool."""
    from iterative_cleaner_tpu_torch.utils import device_probe

    monkeypatch.setattr(device_probe, "ensure_responsive_backend", lambda: "hang")
    svc = CleaningService(_serve_cfg(tmp_path))
    svc.ctx.on_card = True
    with pytest.raises(RuntimeError, match="hung probe"):
        svc.start()
    assert svc.backend_mode == "torch"
    _start(tmp_path).stop()      # the flock was released

def test_admission_cap_503_root_and_drain(tmp_path):
    inside = _write(tmp_path, "in.npz", nsub=4, seed=90)
    # bucket_cap 2 parks the one job in its bucket, so it stays open
    svc = _start(tmp_path, max_open_jobs=1, root=str(tmp_path), deadline_s=30.0,
                 bucket_cap=2)
    try:
        assert _request(svc, "/jobs", {"path": inside})["state"] == "pending"
        err = _status(svc, "/jobs", {"path": inside})
        assert err.code == 503 and err.headers["Retry-After"] == "5"
        assert _status(svc, "/jobs", {"path": "/etc/passwd"}).code == 400
        deadline = time.time() + 60
        while svc.scheduler.pending_count() == 0 and time.time() < deadline:
            time.sleep(0.02)
        assert _request(svc, "/drain", {})["draining"] is True   # flushes the bucket
        assert svc.drain(120)
        assert _status(svc, "/jobs", {"path": inside}).code == 503
        assert _request(svc, "/healthz")["draining"] is True
    finally:
        svc.stop()


def test_root_resolves_symlinks_and_revalidates_on_replay(tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    outside = _write(tmp_path, "outside.npz", nsub=4, seed=95)
    (data / "link.npz").symlink_to(outside)
    svc = _start(tmp_path, root=str(data))
    try:
        assert _status(svc, "/jobs", {"path": str(data / "link.npz")}).code == 400
    finally:
        svc.stop()
    j = JobSpool(str(tmp_path / "spool")).create(outside)
    svc = _start(tmp_path, root=str(data))
    try:
        assert svc.drain(60)
        replayed = svc.job(j.id)
        assert replayed.state == "error" and "outside --root" in replayed.error
    finally:
        svc.stop()


def test_cache_hit_and_audit(tmp_path):
    """A byte-identical resubmission is served from the result cache; a
    job with {"audit": true} is replayed through the oracle and holds."""
    p = _write(tmp_path, "c.npz", nsub=4, seed=33)
    d = _counters_delta(tracing.counters_snapshot())
    svc = _start(tmp_path)
    try:
        first = _request(svc, "/jobs", {"path": p, "audit": True})
        assert svc.drain(120)
        second = _request(svc, "/jobs", {"path": p})
        assert svc.drain(120)
        assert svc.auditor.drain(60)
        first, second = (_request(svc, f"/jobs/{j['id']}") for j in (first, second))
        assert first["served_by"] == "sharded" and second["served_by"] == "cache"
        assert first["audit_result"]["mask_identical"]
        assert NpzIO().load(second["out_path"]).weights.tobytes() == _oracle(p)[0].tobytes()
        assert d("audit_runs") == 1 and d("audit_divergences") == 0
        assert d("service_result_cache_hits") == 1
        assert second["cost"]["cache_hit"] and second["cost"]["device_s"] == 0
    finally:
        svc.stop()


def _meta_and_blocks(seed=21, nsub=8, step=2):
    ar = make_archive(nsub=nsub, nchan=16, nbin=64, seed=seed)
    blocks = [(ar.data[lo:lo + step], ar.weights[lo:lo + step]) for lo in range(0, nsub, step)]
    return ar, SessionMeta.from_archive(ar).to_dict(), blocks


def _no_latency(alert):
    return {k: v for k, v in alert.items() if k != "latency_s"}


def test_sessions_match_the_jax_session_manager(tmp_path):
    ar, meta, blocks = _meta_and_blocks()
    ours = SessionManager(str(tmp_path / "port"), _clean_cfg(), device="cpu")
    theirs = JaxSessionManager(str(tmp_path / "jax"),
                               JaxConfig(backend="jax", max_iter=MAX_ITER))
    sid_o, sid_t = ours.create(dict(meta))["id"], theirs.create(dict(meta))["id"]
    for data, weights in blocks:
        payload = encode_block(data, weights, codec="shuffle-zlib")
        assert payload == jax_encode_block(data, weights, codec="shuffle-zlib")
        a, b = ours.add_block(sid_o, payload), theirs.add_block(sid_t, payload)
        assert _no_latency(a) == _no_latency(b)
    fo, ft = ours.finish(sid_o), theirs.finish(sid_t)
    for key in ("loops", "converged", "n_provisional_zaps", "n_final_zaps", "state"):
        assert fo[key] == ft[key], key
    w = NpzIO().load(fo["out_path"]).weights
    assert w.tobytes() == NpzIO().load(ft["out_path"]).weights.tobytes()
    cfg = CleanConfig(backend="numpy", max_iter=MAX_ITER)
    assert w.tobytes() == finalize_weights(clean_cube(*preprocess(ar), cfg).weights, cfg)[0].tobytes()
    for name in sorted(os.listdir(tmp_path / "port" / sid_o)):
        if name.startswith("block_"):
            assert (tmp_path / "port" / sid_o / name).read_bytes() == \
                (tmp_path / "jax" / sid_t / name).read_bytes()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_session_spool_resumes_across_packages(tmp_path, writer):
    ar, meta, blocks = _meta_and_blocks(seed=22)
    make = {"port": lambda: SessionManager(str(tmp_path / "s"), _clean_cfg(), device="cpu"),
            "jax": lambda: JaxSessionManager(str(tmp_path / "s"),
                                             JaxConfig(backend="numpy", max_iter=MAX_ITER))}
    first = make[writer]()
    sid = first.create(dict(meta))["id"]
    for data, weights in blocks[:2]:
        first.add_block(sid, encode_block(data, weights, codec="shuffle-zlib"))
    second = make["jax" if writer == "port" else "port"]()   # a restarted daemon
    assert second.manifest(sid)["blocks"] == 2 and second.open_count() == 1
    for data, weights in blocks[2:]:
        second.add_block(sid, encode_block(data, weights))
    fin = second.finish(sid)
    assert fin["state"] == "done" and second.open_count() == 0
    cfg = CleanConfig(backend="numpy", max_iter=MAX_ITER)
    want = finalize_weights(clean_cube(*preprocess(ar), cfg).weights, cfg)[0]
    assert NpzIO().load(fin["out_path"]).weights.tobytes() == want.tobytes()


def test_session_over_http(tmp_path):
    ar, meta, blocks = _meta_and_blocks(seed=23, nsub=4)
    svc = _start(tmp_path)
    try:
        sid = _request(svc, "/sessions", meta)["id"]
        for data, weights in blocks:
            alert = _request(svc, f"/sessions/{sid}/blocks", encode_block(data, weights))
            assert alert["subint_hi"] == alert["nsub_total"]
        fin = _request(svc, f"/sessions/{sid}/finish", b"")
        assert fin["state"] == "done" and _request(svc, f"/sessions/{sid}")["state"] == "done"
        assert _status(svc, f"/sessions/{sid}/finish", b"").code == 409
        assert _status(svc, f"/sessions/{sid}/blocks", b"junk").code == 409
        assert _status(svc, "/sessions/../x").code == 404
        assert _status(svc, "/sessions", {"nchan": 0, "nbin": 4}).code == 400
    finally:
        svc.stop()


class TestWarmPool:
    def _ctx(self, tmp_path):
        from iterative_cleaner_tpu_torch.parallel.mesh import make_mesh
        from iterative_cleaner_tpu_torch.service.context import ReplicaContext

        return ReplicaContext(_serve_cfg(tmp_path), mesh=make_mesh(devices=["cpu"]))

    def test_failed_size_is_not_reported_warm(self, tmp_path, monkeypatch):
        from iterative_cleaner_tpu_torch.parallel import sharded

        pool = WarmPool(self._ctx(tmp_path), 4)
        seen = []

        def flaky(Db, w0b, cfg, mesh):
            seen.append(Db.shape[0])
            if Db.shape[0] == 2:
                raise RuntimeError("transient failure")

        monkeypatch.setattr(sharded, "sharded_clean", flaky)
        assert pool.warm_shape((4, 16, 64)) == 2 and seen == [1, 2, 4]
        assert not pool.is_warm((4, 16, 64))
        monkeypatch.setattr(sharded, "sharded_clean", lambda *a, **kw: seen.append("again"))
        assert pool.warm_shape((4, 16, 64)) == 1 and pool.is_warm((4, 16, 64))

    def test_declared_shape_warms_through_the_daemon(self, tmp_path):
        svc = _start(tmp_path, bucket_cap=2, warm_shapes=((4, 16, 64),))
        try:
            assert svc.pool.is_warm((4, 16, 64))
            assert _request(svc, "/healthz")["warm_shapes"] == [[4, 16, 64]]
        finally:
            svc.stop()


class TestEntryPoints:
    def test_serve_smoke_in_process(self, capsys):
        # The smoke reads the process's cumulative audit counters off
        # /healthz; an earlier test's deliberate divergence must not count.
        tracing.reset_counters()
        assert daemon.serve_main(["--smoke", "--device", "cpu", "-q", "-m", "3"]) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["smoke"] == "ok" and out["backend"] == "torch"
        assert out["served_by"] == "sharded" and out["mask_identical_to_oracle"]

    def test_cli_dispatches_serve(self, monkeypatch):
        from iterative_cleaner_tpu_torch.cli import main

        seen = {}
        monkeypatch.setattr(daemon, "serve_main", lambda argv: seen.setdefault("argv", argv) and 7)
        assert main(["serve", "--port", "0"]) == 7 and seen["argv"] == ["--port", "0"]

    def test_serve_token_yields_to_a_file_named_serve(self, tmp_path, monkeypatch):
        from iterative_cleaner_tpu_torch.cli import main

        monkeypatch.chdir(tmp_path)
        (tmp_path / "serve").write_bytes(b"not an archive")
        monkeypatch.setattr(daemon, "serve_main", lambda argv: pytest.fail("daemon ran"))
        with contextlib.redirect_stderr(io.StringIO()):
            assert main(["serve", "-q", "-l", "--device", "cpu"]) == 1

    def test_parser(self):
        args = daemon.build_serve_parser().parse_args(
            ["--warm", "8x16x64", "--warm", "4x16x64", "-m", "3", "--device", "cpu"])
        cfg = daemon.serve_config_from_args(args)
        assert cfg.warm_shapes == ((8, 16, 64), (4, 16, 64)) and cfg.device == "cpu"
        assert cfg.clean.max_iter == 3 and cfg.clean.backend == "torch"
        assert daemon.ServeConfig().device == "cuda"
        with pytest.raises(ValueError):
            daemon.parse_warm_shapes(["8x16"])
        for bad in (["--max_open_jobs", "-1"], ["--bucket_cap", "-1"], ["--coalesce", "0"],
                    ["--alert_iters", "0"], ["--audit_rate", "2"]):
            with pytest.raises(ValueError):
                daemon.serve_config_from_args(daemon.build_serve_parser().parse_args(bad))
        jax_fields = {f.name for f in dataclasses.fields(JaxServeConfig)}
        assert {f.name for f in dataclasses.fields(ServeConfig)} - jax_fields == {"device"}

    def test_subprocess_daemon_serves_its_first_job(self, tmp_path):
        """A real ``serve`` process whose loader threads race the first lazy
        imports (torch, the native runtime) serves its first job."""
        p = _write(tmp_path, "sub.npz", seed=77)
        proc = subprocess.Popen(
            [sys.executable, "-m", "iterative_cleaner_tpu_torch", "serve", "--device", "cpu",
             "--port", "0", "--spool", str(tmp_path / "sub_spool"), "--loaders", "3",
             "--deadline_s", "0.2", "-m", str(MAX_ITER)],
            stderr=subprocess.PIPE, stdout=subprocess.DEVNULL, text=True,
            env=dict(os.environ, PYTHONPATH=str(REPO)), cwd=str(tmp_path))
        lines = []
        try:
            line, deadline = "", time.time() + 120
            while time.time() < deadline:
                line = proc.stderr.readline()
                lines.append(line)
                if not line or "listening" in line:
                    break
            assert "listening" in line, "".join(lines)
            port = int(line.rsplit(":", 1)[1].split()[0])
            threading.Thread(target=lambda: lines.extend(proc.stderr), daemon=True).start()
            base = f"http://127.0.0.1:{port}"
            job = json.load(urllib.request.urlopen(urllib.request.Request(
                f"{base}/jobs", data=json.dumps({"path": p}).encode()), timeout=30))
            state, deadline = {}, time.time() + 120
            while time.time() < deadline:
                state = json.load(urllib.request.urlopen(f"{base}/jobs/{job['id']}",
                                                         timeout=10))
                if state["state"] in TERMINAL:
                    break
                time.sleep(0.1)
            assert state["state"] == "done", "".join(lines)[-2000:]
            assert NpzIO().load(state["out_path"]).weights.tobytes() == _oracle(p)[0].tobytes()
            assert not any("partially initialized" in ln for ln in lines)
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
