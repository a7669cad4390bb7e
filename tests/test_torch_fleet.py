"""The port's fleet tier against the JAX package's, on the CPU.

``iterative_cleaner_tpu_torch.fleet`` is held case for case against
``iterative_cleaner_tpu.fleet``: the pure pieces (weighted fair queueing,
quotas, the fleet cache, placement ranking, the capacity model, alert
lifecycles, SLO burn rates, trend rings and the sentinel, cost showback)
take the same inputs from a numpy seed and must give the same answers; a
mini-fleet of two port replicas (``device="cpu"``) and one of two JAX
replicas take the same archives through a failover of a parked job and
must serve masks identical to each other and to the oracle, with the same
metric families on the router's three exposition routes; a port replica
that demotes to the oracle raises a ``backend_demotion`` incident; and
the port's smokes print the JAX smokes' keys.

Timing discipline: routers are built with a dormant poll loop and every
wait is a bounded poll on a condition that drives ``poll_tick`` by hand.
Every router's spool lies under the test's temporary directory.
"""

from __future__ import annotations

import ast
import contextlib
import importlib
import io
import json
import os
import re
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest

from iterative_cleaner_tpu.config import CleanConfig as JaxConfig
from iterative_cleaner_tpu.io.npz import NpzIO as JaxNpzIO
from iterative_cleaner_tpu.io.synthetic import make_archive as jax_make_archive
from iterative_cleaner_tpu.parallel.mesh import make_mesh as jax_make_mesh
from iterative_cleaner_tpu.service import CleaningService as JaxService
from iterative_cleaner_tpu.service import ServeConfig as JaxServeConfig
from iterative_cleaner_tpu_torch.config import CleanConfig
from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
from iterative_cleaner_tpu_torch.fleet import obs as fleet_obs
from iterative_cleaner_tpu_torch.io.npz import NpzIO
from iterative_cleaner_tpu_torch.models.surgical import finalize_weights
from iterative_cleaner_tpu_torch.ops.preprocess import preprocess
from iterative_cleaner_tpu_torch.service import CleaningService, ServeConfig

REPO = Path(__file__).resolve().parent.parent
PKGS = ("iterative_cleaner_tpu", "iterative_cleaner_tpu_torch")
MAX_ITER = 3
SHAPE = (4, 16, 64)


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _both(drive, tmp_path):
    """``drive(pkg, tmp)`` for the JAX package and the port, each in a
    directory of its own; the port's answer must equal the JAX one."""
    ref, port = (drive(pkg, tmp_path / pkg) for pkg in PKGS)
    assert port == ref
    return port


def _fams(pkg: str, text: str):
    return _mod(pkg, "obs.metrics").parse_exposition(text)


def _bounded(cond, timeout_s: float, what: str, tick=None):
    """Poll ``cond()`` (driving ``tick()`` first when given) until it is
    true; fail after ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    while True:
        if tick is not None:
            tick()
        value = cond()
        if value:
            return value
        if time.monotonic() >= deadline:
            raise AssertionError(f"{what} not reached within {timeout_s}s")
        time.sleep(0.05)


# --- pure logic, each case on the same inputs in both packages ---


def _drive_wfq(pkg, tmp):
    q = _mod(pkg, "fleet.tenants").WeightedFairQueue(
        weights={"a": 1.0, "b": 3.0, "c": 0.5})
    rng = np.random.default_rng(9)
    order = []
    for i in range(80):
        if rng.random() < 0.6 or not len(q):
            tenant = "abcd"[int(rng.integers(4))]
            q.push(tenant, f"{tenant}{i}")
        else:
            order.append(q.pop())
    while len(q):
        order.append(q.pop())
    return order


def _drive_admission(pkg, tmp):
    t = _mod(pkg, "fleet.tenants")
    adm = t.TenantAdmission(quotas={"t": 2, "u": 1}, default_quota=3)
    rng = np.random.default_rng(11)
    log = []
    for _ in range(60):
        tenant = "tuv"[int(rng.integers(3))]
        if rng.random() < 0.65:
            try:
                adm.admit(tenant)
                log.append(("admit", tenant))
            except t.QuotaExceeded:
                log.append(("429", tenant))
        else:
            adm.release(tenant)
            log.append(("release", tenant))
        log.append(tuple(adm.open_count(x) for x in "tuv"))
    return log


def _drive_cache(pkg, tmp):
    c = _mod(pkg, "fleet.cache")
    idx = c.FleetResultIndex(capacity=4)
    rng = np.random.default_rng(5)
    log = []
    for i in range(40):
        digest = f"d{int(rng.integers(8))}"
        if rng.random() < 0.5:
            ok = idx.record({"id": f"j{i}", "state": "done",
                             "file_digest": digest, "cache_salt": "s",
                             "out_path": f"/o/{i}.npz", "replica_id": "r"})
            log.append(("record", digest, ok))
        else:
            hit = idx.lookup(digest, "s")
            log.append(("lookup", digest,
                        hit and (hit["out_path"], hit["origin"]["job_id"])))
    log.append(len(idx))
    log.append(c.unanimous_salt([{"alive": True, "cache_salt": "s"},
                                 {"alive": True, "cache_salt": "s"},
                                 {"alive": False, "cache_salt": "x"}]))
    log.append(c.unanimous_salt([{"alive": True, "cache_salt": "s"},
                                 {"alive": True, "cache_salt": "t"}]))
    return log


class _FakeClient:
    """Scripted ``/healthz`` replies by base URL."""

    def __init__(self, script):
        self.script = script

    def health(self, base_url):
        out = self.script[base_url]
        if isinstance(out, Exception):
            raise out
        return out


def _drive_ranking(pkg, tmp):
    r = _mod(pkg, "fleet.router")
    client = _mod(pkg, "fleet.client")
    urls = ("http://a", "http://b", "http://c")
    router = r.FleetRouter(r.FleetConfig(replicas=urls,
                                         spool_dir=str(tmp / "spool")))
    rng = np.random.default_rng(3)
    out = []
    for _ in range(12):
        script = {}
        for u in urls:
            if rng.random() < 0.15:
                script[u] = client.ReplicaUnreachable("down")
                continue
            depth = int(rng.integers(3))
            script[u] = {
                "replica_id": "r" + u[-1], "open_jobs": int(rng.integers(4)),
                "warm_shapes": [list(SHAPE)] if rng.random() < 0.4 else [],
                "bucket_queue_depths": {"4x16x64": depth} if depth else {},
                "bucketed_cubes": depth,
                "draining": bool(rng.random() < 0.1)}
        router.registry.poll_once(_FakeClient(script))
        for bucket in ("4x16x64", ""):
            out.append([c.replica_id for c in
                        router._ranked_candidates(bucket, set())])
    return out


def _replica_row(rid, depths, load_q=0):
    return {"base_url": f"http://x/{rid}", "replica_id": rid, "alive": True,
            "draining": False, "consecutive_failures": 0, "open_jobs": 0,
            "load_queue_depth": load_q, "dispatch_queue_depth": 0,
            "bucketed_cubes": sum(depths.values()),
            "bucket_queue_depths": dict(depths), "warm_shapes": [],
            "backend": "torch", "version": "t", "audits_run": 0,
            "audit_divergences": 0}


def _scrape(pkg, busy_s, done, exec_bytes):
    text = ("# TYPE ict_service_dispatch_s counter\n"
            f"ict_service_dispatch_s {busy_s!r}\n"
            "# TYPE ict_service_jobs_done counter\n"
            f"ict_service_jobs_done {done!r}\n"
            "# TYPE ict_executable_bytes_accessed gauge\n"
            + "".join(f'ict_executable_bytes_accessed{{shape_bucket="{b}"}} '
                      f"{v!r}\n" for b, v in exec_bytes.items()))
    return {"families": _fams(pkg, text), "ok": True}


def _drive_capacity(pkg, tmp, monkeypatch):
    cap = _mod(pkg, "fleet.capacity")
    clock = [1000.0]
    monkeypatch.setattr(cap.time, "monotonic", lambda: clock[0])
    monkeypatch.setattr(cap.time, "time", lambda: clock[0])
    model = cap.CapacityModel(window=4)
    rng = np.random.default_rng(21)
    busy = {"ra": 0.0, "rb": 0.0}
    done = {"ra": 0.0, "rb": 0.0}
    exec_bytes = {"4x16x64": 1e9, "8x16x64": 3e9}
    snaps = []
    for _ in range(6):
        rows = []
        scrapes = {}
        for rid in ("ra", "rb"):
            depths = {b: int(rng.integers(4)) for b in exec_bytes}
            rows.append(_replica_row(rid, depths, int(rng.integers(2))))
            busy[rid] += float(rng.integers(0, 8)) / 4
            done[rid] += float(rng.integers(0, 5))
            scrapes[rid] = _scrape(pkg, busy[rid], done[rid], exec_bytes)
        for _ in range(int(rng.integers(4))):
            model.note_placement("4x16x64")
        snap = model.update(rows, scrapes)
        snap.pop("ts", None)
        snaps.append(snap)
        clock[0] += 1.5
    return {"snaps": snaps, "gauges": {
        k: sorted(v.items()) for k, v in model.gauge_families().items()},
        "demand": model.demand_total()}


def _drive_alerts(pkg, tmp):
    a = _mod(pkg, "fleet.alerts")
    h = _mod(pkg, "fleet.history").MetricsHistory(keep=16)
    rules = [a.parse_rule({"name": "hot", "severity": "warning",
                           "family": "ict_g",
                           "predicate": {"op": "gt", "value": 5},
                           "for_ticks": 2}),
             a.parse_rule({"name": "moved", "family": "ict_c",
                           "predicate": {"op": "delta_gt", "value": 2,
                                         "window": 1}})]
    eng = a.AlertEngine(rules, history_ticks=16)
    rng = np.random.default_rng(17)
    count = 0.0
    log = []
    for _ in range(24):
        count += float(rng.integers(0, 5))
        text = "# TYPE ict_g gauge\n" + "".join(
            f'ict_g{{replica="{r}"}} {float(rng.integers(0, 10))!r}\n'
            for r in ("a", "b"))
        text += f"# TYPE ict_c counter\nict_c {count!r}\n"
        h.append(_fams(pkg, text))
        v = eng.evaluate(h)
        log.append({k: [(x["rule"], x["state"], x["labels"], x["value"])
                        for x in v[k]] for k in ("fired", "resolved",
                                                 "firing")})
    log.append(eng.firing_counts())
    log.append([(t["rule"], t["state"]) for t in eng.recent()])
    # The default pack, less its prose (the port's names its own backend).
    log.append([{k: v for k, v in r.to_json().items() if k != "description"}
                for r in a.default_rule_pack()])
    return log


def _drive_slo(pkg, tmp):
    slo = _mod(pkg, "fleet.slo")
    plane = slo.SloPlane(slo.parse_slo_specs(
        ["fresh:0.9:8", "cache:0.99:16", "session:0.95:4"]), str(tmp))
    rng = np.random.default_rng(23)
    out = []
    placed = burned = 0.0
    for _ in range(12):
        for journey in ("fresh", "cache", "session", "campaign"):
            ok = bool(rng.random() < 0.8)
            plane.note_verdict({
                "journey": journey, "ok": ok,
                "correct": (bool(rng.random() < 0.9) if ok else None),
                "latency_s": float(rng.integers(1, 400)) / 100})
        placed += float(rng.integers(0, 6))
        burned += float(rng.integers(0, 2))
        plane.note_admission(burned_total=burned, placed_total=placed)
        plane.end_tick()
        report = plane.report()
        out.append({j: {k: row.get(k) for k in
                        ("availability", "correctness", "burn",
                         "budget_remaining_pct", "good", "bad")}
                    for j, row in report["journeys"].items()})
        out.append(plane.failing_journeys())
    out.append(plane.min_budget_remaining())
    out.append([r.to_json() for r in slo.burn_rules(plane.objectives)])
    return out


def _drive_trend_store(pkg, tmp):
    tr = _mod(pkg, "fleet.trends")
    store = tr.TrendStore(keep_raw=8)
    rng = np.random.default_rng(29)
    count = 0.0
    ts = 3_595.0
    out = []
    for _ in range(30):
        count += float(rng.integers(0, 7))
        text = ("# TYPE ict_fleet_speed gauge\n"
                f'ict_fleet_speed{{replica="a"}} {float(rng.random())!r}\n'
                "# TYPE ict_fleet_done_total counter\n"
                f"ict_fleet_done_total {count!r}\n"
                "# TYPE ict_other gauge\nict_other 1.0\n")
        out.append(store.append(_fams(pkg, text), ts))
        ts += 17.0
    out.append(store.ticks())
    out.append(store.series_count())
    for res in ("raw", "60", "3600"):
        out.append(store.query("ict_fleet_speed", resolution=res))
        out.append(store.query("ict_fleet_done_total", resolution=res))
    out.append(store.inventory())
    return json.loads(json.dumps(out))


def _drive_sentinel(pkg, tmp):
    fp = _mod(pkg, "fleet.trends").Fingerprint()
    rng = np.random.default_rng(31)
    series = list(10.0 + rng.normal(0, 0.2, 12)) + [4.0] * 4 + \
        list(10.0 + rng.normal(0, 0.2, 4))
    edges = [fp.observe(float(x), direction="low", min_samples=4,
                        sentinel_k=3, band_mad=4.0, rel_floor=0.05)
             for x in series]
    return {"edges": edges, "fp": fp.to_json(), "band": fp.band(4.0, 0.05)}


_COST_SCRAPE = """\
# TYPE ict_cost_device_seconds_total counter
ict_cost_device_seconds_total{{tenant="default"}} {d0}
ict_cost_device_seconds_total{{tenant="survey"}} {d1}
# TYPE ict_cost_jobs_total counter
ict_cost_jobs_total{{tenant="survey"}} {jobs}
# TYPE ict_cost_compile_seconds_total counter
ict_cost_compile_seconds_total{{tenant="survey"}} 1.5
# TYPE ict_cost_cache_hits_total counter
ict_cost_cache_hits_total{{tenant="survey"}} {hits}
# TYPE ict_cost_cache_avoided_device_seconds_total counter
ict_cost_cache_avoided_device_seconds_total{{tenant="survey"}} 3
# TYPE ict_cost_bucket_device_seconds_total counter
ict_cost_bucket_device_seconds_total{{shape_bucket="4x16x64"}} {d1}
# TYPE ict_cost_route_device_seconds_total counter
ict_cost_route_device_seconds_total{{route="sharded"}} {d1}
# TYPE ict_cost_attainment_ratio gauge
ict_cost_attainment_ratio{{shape_bucket="4x16x64"}} 0.42
# TYPE ict_service_dispatch_s counter
ict_service_dispatch_s {disp}
"""


def _drive_costs(pkg, tmp):
    costs = _mod(pkg, "fleet.costs")
    rng = np.random.default_rng(37)
    rows, scrapes = [], {}
    for rid in ("r1", "r2", "dead"):
        d0, d1 = (float(rng.integers(0, 40)) / 4 for _ in range(2))
        rows.append({"replica_id": rid, "alive": rid != "dead"})
        scrapes[rid] = {"families": _fams(pkg, _COST_SCRAPE.format(
            d0=d0, d1=d1, jobs=int(rng.integers(1, 9)),
            hits=int(rng.integers(0, 3)), disp=d0 + d1))}
    budgets = {"survey": 10.0, "idle": 5.0}
    snap = costs.fold(rows, scrapes, budgets)
    snap.pop("ts", None)
    return {"snap": snap,
            "gauges": {k: sorted(v.items()) for k, v in
                       costs.gauge_families(snap, budgets).items()},
            "rules": [r.to_json() for r in costs.budget_rules(budgets)]}


LOGIC_CASES = {
    "wfq_order": _drive_wfq,
    "tenant_admission": _drive_admission,
    "cache_eviction": _drive_cache,
    "registry_ranking": _drive_ranking,
    "alert_lifecycle": _drive_alerts,
    "slo_burn": _drive_slo,
    "trend_store": _drive_trend_store,
    "trend_sentinel": _drive_sentinel,
    "cost_showback": _drive_costs,
}


@pytest.mark.parametrize("case", sorted(LOGIC_CASES))
def test_fleet_logic_matches_jax(tmp_path, case):
    got = _both(LOGIC_CASES[case], tmp_path)
    assert got, case


def test_capacity_model_matches_jax(tmp_path, monkeypatch):
    got = _both(lambda pkg, tmp: _drive_capacity(pkg, tmp, monkeypatch),
                tmp_path)
    assert got["snaps"][-1]["fleet"]["replicas_live"] == 2
    assert got["demand"] > 0


# --- the CLI surface ---


@pytest.mark.parametrize("sub,module,func", [
    ("serve-fleet", "fleet.router", "fleet_main"),
    ("campaign", "campaign.cli", "campaign_main"),
    ("prove", "proving.soak", "prove_main"),
    ("explain", "fleet.explain", "explain_main"),
    ("trends", "fleet.trends", "trends_main"),
])
def test_cli_dispatches_the_fleet_subcommands(monkeypatch, sub, module,
                                              func):
    from iterative_cleaner_tpu_torch import cli

    seen = []

    def fake_main(argv):
        seen.append(argv)
        return 7

    mod = importlib.import_module(f"iterative_cleaner_tpu_torch.{module}")
    monkeypatch.setattr(mod, func, fake_main)
    assert cli.main([sub, "--x", "1"]) == 7
    assert seen == [["--x", "1"]]


def test_fleet_parser_device_and_spawned_replicas(tmp_path, monkeypatch):
    from iterative_cleaner_tpu_torch.fleet import autoscale
    from iterative_cleaner_tpu_torch.fleet.router import (
        build_fleet_parser,
        fleet_config_from_args,
    )

    args = ["--replica", "http://h:1"]
    assert fleet_config_from_args(
        build_fleet_parser().parse_args(args)).device == "cuda"
    assert fleet_config_from_args(build_fleet_parser().parse_args(
        args + ["--device", "cpu"])).device == "cpu"
    seen = {}

    class _Exited:
        returncode = 3

        def poll(self):
            return 3

    def fake_popen(argv, *a, **kw):
        seen["argv"] = argv
        return _Exited()

    monkeypatch.setattr(autoscale.subprocess, "Popen", fake_popen)
    factory = autoscale.SubprocessReplicaFactory(
        str(tmp_path), extra_args=("--device", "cpu"))
    with pytest.raises(autoscale.SpawnFailed):
        factory.spawn("r1")
    assert seen["argv"][1:4] == ["-m", "iterative_cleaner_tpu_torch", "serve"]
    assert seen["argv"][-2:] == ["--device", "cpu"]


def test_new_modules_import_without_jax():
    """Every module of the port's fleet, campaign and proving packages
    (and the CLI that dispatches them) imports with ``jax`` and the JAX
    package blocked."""
    code = """
import importlib, pkgutil, sys
sys.modules["jax"] = None

class Block:
    def find_spec(self, name, path=None, target=None):
        if name == "iterative_cleaner_tpu" or name.startswith(
                "iterative_cleaner_tpu."):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import iterative_cleaner_tpu_torch.cli
n = 0
for sub in ("fleet", "campaign", "proving"):
    pkg = importlib.import_module("iterative_cleaner_tpu_torch." + sub)
    n += 1
    for info in pkgutil.iter_modules(pkg.__path__):
        importlib.import_module(pkg.__name__ + "." + info.name)
        n += 1
bad = [m for m in sys.modules if m == "iterative_cleaner_tpu"
       or m.startswith("iterative_cleaner_tpu.")]
print(n, bad)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(REPO),
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["28", "[]"]
    # The port's fleet_top imports neither (it runs where JAX is absent).
    tree = ast.parse((REPO / "tools_torch" / "fleet_top.py").read_text())
    imported = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names} | {n.module for n in ast.walk(tree)
                                     if isinstance(n, ast.ImportFrom)}
    assert not {m.split(".")[0] for m in imported} & {
        "jax", "jaxlib", "iterative_cleaner_tpu"}
    assert "iterative_cleaner_tpu_torch.obs" in imported


# --- end to end: a port mini-fleet against a JAX mini-fleet ---


def _oracle(path):
    cfg = CleanConfig(backend="numpy", max_iter=MAX_ITER)
    res = clean_cube(*preprocess(NpzIO().load(path)), cfg)
    return finalize_weights(res.weights, cfg)[0]


def _port_replica(tmp, tag, **kw):
    svc = CleaningService(ServeConfig(
        spool_dir=str(tmp / f"spool_{tag}"), port=0, replica_id=tag,
        quiet=True, retry_backoff_s=0.01, device="cpu",
        clean=CleanConfig(backend="torch", max_iter=MAX_ITER, quiet=True,
                          no_log=True), **kw))
    svc.start()
    return svc


def _jax_replica(tmp, tag, **kw):
    svc = JaxService(JaxServeConfig(
        spool_dir=str(tmp / f"spool_{tag}"), port=0, replica_id=tag,
        quiet=True, retry_backoff_s=0.01,
        clean=JaxConfig(backend="jax", max_iter=MAX_ITER, quiet=True,
                        no_log=True), **kw),
        mesh=jax_make_mesh(1, devices=jax.devices("cpu")[:1]))
    svc.start()
    return svc


def _router(pkg, tmp, *svcs):
    r = _mod(pkg, "fleet.router")
    router = r.FleetRouter(r.FleetConfig(
        replicas=tuple(f"http://127.0.0.1:{s.port}" for s in svcs),
        port=0, poll_interval_s=999.0, dead_after=2, quiet=True,
        retry_backoff_s=0.01, queue_timeout_s=5.0,
        # The trend plane's families appear after a number of windows
        # that follows each backend's speed (the smokes drive the plane);
        # one rule fires in both fleets while placements are open, so both
        # register the alert counter whatever else fires on a backend's
        # timing.
        trends=False,
        alert_rules=({"name": "open_placements", "severity": "info",
                      "family": "ict_fleet_open_placements",
                      "predicate": {"op": "gt", "value": 0},
                      "for_ticks": 1},),
        spool_dir=str(tmp / "router_spool")))
    router.start()
    return router


def _http(base, route, body=None, headers=None):
    req = urllib.request.Request(
        base + route, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=30) as resp:
        raw = resp.read().decode()
    return raw if route.endswith("metrics") else json.loads(raw)


def _run_mini_fleet(pkg, start, tmp, paths):
    """Two replicas behind one router: ``a`` parks its cubes, ``b``
    drains; jobs go in through the router, ``a`` is stopped with its jobs
    parked and the router fails them over.  Returns the masks, counts,
    the router's family names and ``fleet_top``'s reply.  The package's
    process-wide registry starts empty, so the replicas' families are
    this traffic's alone, and ``b`` flushes each cube as it lands (bucket
    cap 1), so no family follows the loaders' timing."""
    tmp.mkdir(parents=True, exist_ok=True)
    tracing = _mod(pkg, "obs.tracing")
    tracing.reset_counters()
    svc_a = start(tmp, "mf-a", deadline_s=3600.0, bucket_cap=8)
    svc_b = start(tmp, "mf-b", deadline_s=0.2, bucket_cap=1)
    router = _router(pkg, tmp, svc_a, svc_b)
    base = f"http://127.0.0.1:{router.port}"
    out = {}
    try:
        router.poll_tick()
        jobs = {p: _http(base, "/jobs", {"path": p, "shape": list(SHAPE)})
                for p in paths}
        on_a = sum(1 for j in jobs.values() if j["replica_id"] == "mf-a")
        assert on_a >= 1
        _bounded(lambda: _http(f"http://127.0.0.1:{svc_a.port}", "/healthz")
                 .get("bucketed_cubes", 0) >= on_a, 60, "cubes parked on a")
        router.poll_tick()
        svc_a.stop()

        def states():
            return {p: _http(base, f"/jobs/{j['id']}") for p, j in jobs.items()}

        final = _bounded(lambda: (lambda s: s if all(
            v["state"] in ("done", "error") for v in s.values()) else None)(
                states()), 120, "every job terminal", tick=router.poll_tick)
        out["states"] = {p: s["state"] for p, s in final.items()}
        out["masks"] = {p: NpzIO().load(s["out_path"]).weights
                        for p, s in final.items()}
        out["failovers"] = router.metrics.counter_total("fleet_failovers_total")
        out["completed"] = router.metrics.counter_value(
            "fleet_jobs_completed_total", {"state": "done"})
        out["jobs_done"] = tracing.counters_snapshot().get(
            "service_jobs_done", 0)
        router.poll_tick()
        out["families"] = {
            route: sorted({f.name for f in _fams(pkg, _http(base, route))})
            for route in ("/metrics", "/fleet/metrics")}
        history = _http(base, "/fleet/metrics/history?ticks=4")
        out["families"]["/fleet/metrics/history"] = sorted(
            {f["name"] for t in history["ticks"] for f in t["families"]})
        out["merged_equal"] = _mod(pkg, "fleet.router")._merged_counters_equal(
            _fams(pkg, _http(base, "/fleet/metrics")))
        if pkg == PKGS[1]:
            out["fleet_top"] = {}
            for tool in ("tools_torch", "tools"):
                # The port's copy runs on its own; the JAX package's
                # reads the port router's HTTP surface just as well.
                top = subprocess.run(
                    [sys.executable, str(REPO / tool / "fleet_top.py"),
                     "--router", base, "--json"],
                    capture_output=True, text=True, timeout=60,
                    env=dict(os.environ, PYTHONPATH=str(REPO)
                             if tool == "tools" else ""))
                out["fleet_top"][tool] = (top.returncode, top.stdout,
                                          top.stderr)
    finally:
        router.stop()
        svc_a.stop()
        svc_b.stop()
    return out


@pytest.fixture(scope="module")
def mini_fleets(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mini_fleet")
    paths = []
    for i in range(3):
        p = str(tmp / f"mf{i}.npz")
        JaxNpzIO().save(jax_make_archive(nsub=SHAPE[0], nchan=SHAPE[1],
                                         nbin=SHAPE[2], seed=201 + i), p)
        paths.append(p)
    port = _run_mini_fleet(PKGS[1], _port_replica, tmp / "port", paths)
    ref = _run_mini_fleet(PKGS[0], _jax_replica, tmp / "jax", paths)
    return {"paths": paths, "port": port, "jax": ref}


def test_mini_fleet_masks_match_jax_and_oracle_through_failover(mini_fleets):
    port, ref = mini_fleets["port"], mini_fleets["jax"]
    for fleet in (port, ref):
        assert set(fleet["states"].values()) == {"done"}
        assert fleet["failovers"] >= 1
        assert fleet["completed"] == len(mini_fleets["paths"])
        assert fleet["merged_equal"]
        # Exactly once: the replicas completed each job one time.
        assert fleet["jobs_done"] == len(mini_fleets["paths"])
    for p in mini_fleets["paths"]:
        want = _oracle(p)
        assert port["masks"][p].tobytes() == want.tobytes()
        assert ref["masks"][p].tobytes() == want.tobytes()


#: Replica families that only one backend exports (each also federated
#: as ``ict_fleet_<name>``): the JAX replicas' XLA compile, compile-cache
#: and executable-analysis accounting, and the port replicas' native
#: preprocess counter.  Every other family must match by name.
BACKEND_ONLY = re.compile(
    r"^ict_(fleet_)?(compile_|compiles_total|jax_compile_|exec_analysis_"
    r"|executable_temp_bytes|persistent_|preprocess_native)")


@pytest.mark.parametrize("route", ["/metrics", "/fleet/metrics",
                                   "/fleet/metrics/history"])
def test_fleet_metric_families_match_jax(mini_fleets, route):
    port, ref = (
        [n for n in mini_fleets[k]["families"][route]
         if not BACKEND_ONLY.match(n)] for k in ("port", "jax"))
    assert port == ref
    assert {"ict_fleet_alerts_total", "ict_fleet_jobs_completed_total",
            "ict_fleet_placements_total"} <= set(port)
    if route != "/metrics":
        assert {"ict_fleet_service_jobs_done",
                "ict_service_jobs_done"} <= set(port)


@pytest.mark.parametrize("tool", ["tools_torch", "tools"])
def test_fleet_top_one_shot_against_the_port_router(mini_fleets, tool):
    rc, stdout, stderr = mini_fleets["port"]["fleet_top"][tool]
    assert rc == 0, stderr
    body = json.loads(stdout)
    assert body["health"]["router_id"] == body["router_id"]
    assert {r["replica_id"] for r in body["health"]["replicas"]} == {
        "mf-a", "mf-b"}


def test_torch_to_numpy_demotion_raises_an_incident(tmp_path, monkeypatch):
    from iterative_cleaner_tpu_torch.io.synthetic import make_archive
    from iterative_cleaner_tpu_torch.service.worker import DispatchWorker

    def boom(self, entries):
        raise RuntimeError("synthetic backend failure")

    monkeypatch.setattr(DispatchWorker, "_dispatch_sharded", boom)
    p = str(tmp_path / "d.npz")
    NpzIO().save(make_archive(nsub=4, nchan=16, nbin=64, seed=80), p)
    svc = _port_replica(tmp_path, "dm", dispatch_retries=1, demote_after=1)
    router = _router(PKGS[1], tmp_path, svc)
    base = f"http://127.0.0.1:{router.port}"
    try:
        router.poll_tick()      # the router sees the replica on "torch"
        assert router.registry.snapshot()[0]["backend"] == "torch"
        job = _http(base, "/jobs", {"path": p})
        _bounded(lambda: _http(base, f"/jobs/{job['id']}")["state"] == "done",
                 120, "the demoted job done", tick=router.poll_tick)
        _bounded(lambda: [b for b in fleet_obs.list_incidents(
            router.incident_dir) if b.get("reason") == "backend_demotion"],
            30, "a backend_demotion incident", tick=router.poll_tick)
        bundles = [b for b in fleet_obs.list_incidents(router.incident_dir)
                   if b.get("reason") == "backend_demotion"]
        assert len(bundles) == 1 and bundles[0]["replica_id"] == "dm"
        assert router.registry.snapshot()[0]["backend"] == "numpy"
    finally:
        router.stop()
        svc.stop()


# --- the smokes: the port's JSON carries the JAX smokes' keys ---


def _smoke_line(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


def _jax_result_keys(func_name: str) -> list[str]:
    """The keys of the ``result = {...}`` line the JAX smoke prints on
    its full path, read from its source: the JAX smoke's outcome in a
    process that already compiled its shapes depends on that history (a
    warm compile cache drains the autoscale smoke's backlog before its
    scaler can see it), its keys do not."""
    tree = ast.parse((REPO / "iterative_cleaner_tpu" / "fleet" / "router.py")
                     .read_text())
    func = next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == func_name)
    dicts = [n.value for n in ast.walk(func)
             if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
             and any(isinstance(t, ast.Name) and t.id == "result"
                     for t in n.targets) and len(n.value.keys) > 1]
    assert len(dicts) == 1
    return sorted(k.value for k in dicts[0].keys)


@pytest.mark.parametrize("extra,func", [
    ([], "run_fleet_smoke"),
    (["--autoscale", "act"], "run_autoscale_smoke"),
], ids=["fleet", "autoscale"])
def test_fleet_smokes_print_the_jax_keys(extra, func):
    from iterative_cleaner_tpu_torch.fleet.router import fleet_main

    rc, got = _smoke_line(fleet_main, ["--smoke", "-q", "--device", "cpu",
                                       *extra])
    assert rc == 0 and got["smoke"] == "ok", got
    if extra:
        assert got["scaled_up"] and got["scaled_down"]
    else:
        assert got["failovers"] >= 1 and got["mask_identical_to_oracle"]
    assert sorted(got) == _jax_result_keys(func)
