"""The ``ict-clean-torch prove`` driver: scenario mix + chaos schedule against
an in-process fleet, one JSON verdict.

Port of ``iterative_cleaner_tpu/proving/soak.py``.

The soak stands up a hermetic 2-replica fleet (dormant poll loop, driven
by hand — the test_fleet timing discipline), runs a bounded number of
scenario-mix ticks (:mod:`.scenarios`), proves the duplicate-storm CAS
and trace record→replay dedupe observables, runs the chaos schedule
(:mod:`.chaos`), and prints exactly ONE JSON verdict line on stdout on
EVERY exit path, enforcing the invariant triad:

- **zero lost jobs** — the exactly-once ledger conserves: every external
  submission is either a replica completion, a fleet-cache hit, or an
  idempotent dedupe, and every fleet job read back terminal ``done``;
- **bit-identical masks** — sampled shadow-oracle audits per scenario
  class (one job per class per tick re-cleaned on the numpy oracle and
  compared with ``np.array_equal``);
- **cost conservation** — the device-time ledger stays within
  ``fleet/costs.CONSERVATION_TOLERANCE`` (1%) of the dispatch clock.

Exit code 0 iff the triad holds AND every drill's closed loop
(inject → alert → heal → resolve → books balance) closed.  A budget that
cannot fund the proof (``--job_budget 0``) is a FAIL, not a vacuous pass.
Verdict schema: docs/PROVING.md.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import urllib.request

import numpy as np

from iterative_cleaner_tpu_torch.config import CleanConfig
from iterative_cleaner_tpu_torch.fleet import costs as fleet_costs
from iterative_cleaner_tpu_torch.fleet.router import FleetConfig, FleetRouter
from iterative_cleaner_tpu_torch.io.npz import NpzIO
from iterative_cleaner_tpu_torch.obs import events
from iterative_cleaner_tpu_torch.obs import metrics as obs_metrics
from iterative_cleaner_tpu_torch.obs import tracing
from iterative_cleaner_tpu_torch.proving import chaos, scenarios, traces
from iterative_cleaner_tpu_torch.service import CleaningService, ServeConfig
from iterative_cleaner_tpu_torch.service.jobs import TERMINAL

#: Alert rules the soak injects into its router — the chaos drills
#: assert full firing -> resolved cycles against these names
#: (chaos.RULE_REPLICA_DEAD / chaos.RULE_SINK_DEGRADED).
PROVE_RULES = (
    {"name": chaos.RULE_REPLICA_DEAD, "severity": "critical",
     "family": "ict_fleet_replicas", "labels": {"state": "dead"},
     "predicate": {"op": "gt", "value": 0}, "for_ticks": 1,
     "description": "proving ground: a fleet replica is dead/unreachable"},
    {"name": chaos.RULE_SINK_DEGRADED, "severity": "warning",
     "family": "ict_prove_event_sink_degraded",
     "predicate": {"op": "gt", "value": 0}, "for_ticks": 1,
     "description": "proving ground: the JSON-lines event sink is "
                    "dropping events (full disk / unwritable path)"},
)


class ProvingFleet:
    """A hermetic in-process fleet plus the helpers the scenario lane and
    chaos drills share.  Single-threaded driver discipline: every method
    is called from the soak's (or the test's) one thread; the router and
    replicas run their own threads behind their own locks."""

    def __init__(self, workdir: str, seed: int = 0, backend: str = "torch",
                 replicas: int = 2, device: str = "cuda") -> None:
        self.workdir = workdir  # ict: guarded-by(none: soak driver thread only)
        self.seed = int(seed)  # ict: guarded-by(none: soak driver thread only)
        self.backend = backend  # ict: guarded-by(none: soak driver thread only)
        self.device = device  # ict: guarded-by(none: soak driver thread only)
        self.services: list = []  # ict: guarded-by(none: soak driver thread only)
        self.scenario_jobs: dict[str, int] = {}  # ict: guarded-by(none: soak driver thread only)
        self.faults_injected: dict[str, int] = {}  # ict: guarded-by(none: soak driver thread only)
        self.faults_healed: dict[str, int] = {}  # ict: guarded-by(none: soak driver thread only)
        self.submitted_total = 0  # ict: guarded-by(none: soak driver thread only)
        self.verdict_code = 0.0  # ict: guarded-by(none: soak driver thread only)
        self._tag_n = 0  # ict: guarded-by(none: soak driver thread only)
        self._oracle_cache: dict[str, object] = {}  # ict: guarded-by(none: soak driver thread only)
        self.telemetry = os.path.join(workdir, "events.jsonl")  # ict: guarded-by(none: soak driver thread only)
        self._prior_sink = events.configured_sink()  # ict: guarded-by(none: set once during construction)
        self._done_at_start = self._global_done()  # ict: guarded-by(none: set once during construction)
        for _ in range(replicas):
            self._start_service(self.next_tag("replica"))
        self._cost_base = self._cost_sums()  # ict: guarded-by(none: set once during construction)
        self.router = FleetRouter(FleetConfig(  # ict: guarded-by(none: set once during construction)
            replicas=tuple(f"http://127.0.0.1:{s.port}"
                           for s in self.services),
            port=0, poll_interval_s=999.0, dead_after=2, quiet=True,
            retry_backoff_s=0.01, queue_timeout_s=10.0,
            spool_dir=os.path.join(workdir, "router_spool"),
            telemetry=self.telemetry, alert_rules=PROVE_RULES))
        self.router.start()
        self.base_url = f"http://127.0.0.1:{self.router.port}"  # ict: guarded-by(none: set once during construction)

    # --- replica lifecycle ---

    def next_tag(self, prefix: str) -> str:
        self._tag_n += 1
        return f"prove-{prefix}-{self._tag_n}"

    def _start_service(self, tag: str, port: int = 0,
                       spool_dir: str | None = None,
                       deadline_s: float = 0.2,
                       bucket_cap: int = 0) -> CleaningService:
        svc = CleaningService(ServeConfig(
            spool_dir=spool_dir or os.path.join(self.workdir,
                                                f"spool_{tag}"),
            port=port, replica_id=tag, deadline_s=deadline_s,
            bucket_cap=bucket_cap, quiet=True, retry_backoff_s=0.01,
            device=self.device,
            clean=CleanConfig(backend=self.backend, max_iter=3,
                              quiet=True, no_log=True)))
        svc.start()
        self.services.append(svc)
        return svc

    def new_replica(self, tag: str, port: int = 0,
                    spool_dir: str | None = None,
                    deadline_s: float = 0.2,
                    bucket_cap: int = 0) -> CleaningService:
        """Start one more in-process replica and join it to the fleet
        (registry.add = the autoscaler's scale-up path; not alive until
        its first good poll)."""
        svc = self._start_service(tag, port=port, spool_dir=spool_dir,
                                  deadline_s=deadline_s,
                                  bucket_cap=bucket_cap)
        self.router.registry.add(f"http://127.0.0.1:{svc.port}")
        return svc

    def kill(self, svc: CleaningService) -> None:
        """Stop a replica WITHOUT telling the registry — the crash, not
        the drain: the router must discover the death by poll."""
        svc.stop()
        if svc in self.services:
            self.services.remove(svc)

    def close(self) -> None:
        try:
            self.router.stop()
        finally:
            for svc in list(self.services):
                try:
                    svc.stop()
                except Exception:
                    pass
            self.services.clear()
            # Back to honoring ICT_TELEMETRY (the daemon contract).
            events.configure(self._prior_sink)

    # --- the proving tick: publish gauges, then drive the router ---

    def tick(self) -> None:
        """Publish the ``ict_prove_*`` gauge families onto the router's
        registry, THEN run one poll tick — ``_history_alert_tick`` runs
        inside ``poll_tick``, so rules over prove families always see
        this tick's values, never last tick's."""
        m = self.router.metrics
        m.replace_gauge_family(
            "prove_scenario_jobs",
            {(("scenario", k),): float(v)
             for k, v in self.scenario_jobs.items()})
        m.replace_gauge_family(
            "prove_faults_injected",
            {(("fault", k),): float(v)
             for k, v in self.faults_injected.items()})
        m.replace_gauge_family(
            "prove_faults_healed",
            {(("fault", k),): float(v)
             for k, v in self.faults_healed.items()})
        m.set_gauge("prove_soak_verdict", None, float(self.verdict_code))
        m.set_gauge("prove_event_sink_degraded", None,
                    1.0 if events.sink_degraded() else 0.0)
        self.router.poll_tick()

    # --- submission + settlement ---

    def submit(self, sub: scenarios.Submission, timeout_s: float = 30.0,
               count_scenario: bool = True) -> dict:
        req = urllib.request.Request(
            f"{self.base_url}/jobs",
            data=json.dumps(sub.job_body()).encode(),
            headers={"Content-Type": "application/json",
                     "X-ICT-Tenant": sub.tenant})
        reply = json.load(urllib.request.urlopen(req, timeout=timeout_s))
        self.submitted_total += 1
        if count_scenario:
            self.scenario_jobs[sub.scenario] = (
                self.scenario_jobs.get(sub.scenario, 0) + 1)
        return reply

    def job_state(self, job_id: str, timeout_s: float = 30.0) -> dict:
        return json.load(urllib.request.urlopen(
            f"{self.base_url}/jobs/{job_id}", timeout=timeout_s))

    def await_terminal(self, job_ids: list, timeout_s: float = 180.0) -> dict:
        deadline = time.time() + timeout_s
        states: dict = {}
        while time.time() < deadline:
            self.tick()
            states = {jid: self.job_state(jid) for jid in job_ids}
            if all(s.get("state") in TERMINAL for s in states.values()):
                return states
            time.sleep(0.05)
        raise TimeoutError(
            f"jobs not terminal within {timeout_s}s: "
            f"{ {j: s.get('state') for j, s in states.items()} }")

    # --- the invariant triad's measurement helpers ---

    def oracle_weights(self, path: str):
        """The numpy oracle's weights for one cube — the executable
        spec every served mask must match bit for bit.  Cached per path:
        scenario cubes recur across ticks."""
        if path not in self._oracle_cache:
            from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
            from iterative_cleaner_tpu_torch.models.surgical import finalize_weights
            from iterative_cleaner_tpu_torch.ops.preprocess import preprocess

            cfg = CleanConfig(backend="numpy", max_iter=3, quiet=True,
                              no_log=True)
            w, _nbs, _nbc = finalize_weights(
                clean_cube(*preprocess(NpzIO().load(path)), cfg).weights,
                cfg)
            self._oracle_cache[path] = w
        return self._oracle_cache[path]

    def load_weights(self, out_path: str):
        return NpzIO().load(out_path).weights

    def audit_ok(self, sub: scenarios.Submission, state: dict) -> bool:
        return (state.get("state") == "done"
                and bool(state.get("out_path"))
                and np.array_equal(self.load_weights(state["out_path"]),
                                   self.oracle_weights(sub.path)))

    def _global_done(self) -> int:
        return int(tracing.counters_snapshot().get("service_jobs_done", 0))

    def jobs_done(self) -> int:
        """Fleet-wide replica completions SINCE this fleet started (the
        tracing counter is process-global; tests may run fleets
        back-to-back in one process)."""
        return self._global_done() - self._done_at_start

    def ledger(self) -> dict:
        m = self.router.metrics
        done = self.jobs_done()
        cache = int(m.counter_total("fleet_cache_hits_total"))
        deduped = int(m.counter_total("fleet_deduped_submissions_total"))
        return {"submitted": self.submitted_total, "completed": done,
                "cache_hits": cache, "deduped": deduped,
                "lost": self.submitted_total - done - cache - deduped}

    def _cost_sums(self) -> tuple[float, float]:
        """(device-seconds total, dispatch-seconds total) off one
        replica's exposition — in-process replicas share one
        process-global metrics registry, so any one covers the fleet."""
        text = urllib.request.urlopen(
            f"http://127.0.0.1:{self.services[0].port}/metrics",
            timeout=10).read().decode()
        cost_sum = dispatch_sum = 0.0
        for fam in obs_metrics.parse_exposition(text):
            for name, _labels, raw in fam.samples:
                if name == "ict_cost_device_seconds_total":
                    cost_sum += obs_metrics.sample_value(raw)
                elif name == "ict_service_dispatch_s":
                    dispatch_sum += obs_metrics.sample_value(raw)
        return cost_sum, dispatch_sum

    def cost_conservation_ok(self, timeout_s: float = 30.0) -> bool:
        """Device-time ledger vs the dispatch clock, as a DELTA since
        this fleet was built: the registry is process-global, so a
        totals check would inherit (and fail on) whatever residue
        earlier fleets in the same process left behind.  Bounded retry:
        a job turns terminal a beat before the worker finalizes its
        cost record."""
        if not self.services:
            return False
        deadline = time.time() + timeout_s
        cost0, dispatch0 = self._cost_base
        while True:
            cost_sum, dispatch_sum = self._cost_sums()
            cost_sum -= cost0
            dispatch_sum -= dispatch0
            if dispatch_sum <= 0.0:
                return True   # nothing dispatched yet: vacuously conserved
            if (abs(cost_sum / dispatch_sum - 1.0)
                    <= fleet_costs.CONSERVATION_TOLERANCE):
                return True
            if time.time() >= deadline:
                return False
            time.sleep(0.1)


class SoakConfig:
    """Bounded budgets + mode for one proving run."""

    def __init__(self, smoke: bool = False, seed: int = 0,
                 ticks: int | None = None, job_budget: int | None = None,
                 wall_budget_s: float | None = None,
                 backend: str = "torch", workdir: str = "",
                 quiet: bool = False, device: str = "cuda") -> None:
        self.smoke = smoke
        self.seed = int(seed)
        self.ticks = int(ticks if ticks is not None else (1 if smoke else 3))
        self.job_budget = int(job_budget if job_budget is not None
                              else (64 if smoke else 512))
        self.wall_budget_s = float(wall_budget_s if wall_budget_s is not None
                                   else (300.0 if smoke else 1800.0))
        self.backend = backend
        self.device = device
        self.workdir = workdir
        self.quiet = quiet


def _scenario_tick(fleet: ProvingFleet, cfg: SoakConfig, tick_i: int,
                   out: dict) -> None:
    """One scenario-mix tick: submit the seeded mix, settle it, audit one
    job per scenario class against the oracle, and prove the
    duplicate-storm echoes land born-terminal on the fleet cache."""
    mix = scenarios.SMOKE_MIX if cfg.smoke else scenarios.FULL_MIX
    subs = scenarios.build_mix(fleet.workdir, cfg.seed + tick_i * 1_000,
                               mix)
    if fleet.submitted_total + len(subs) > cfg.job_budget:
        raise _BudgetExhausted(
            f"job budget {cfg.job_budget} cannot fund scenario tick "
            f"{tick_i} ({len(subs)} submissions on top of "
            f"{fleet.submitted_total})")
    # build_mix orders the stream [first storm copy, ...rest, echoes]:
    # settle the head first so the router's scrape learns the storm
    # cube's result, then the echoes MUST be cache-served born-terminal.
    echoes = [s for s in subs if s.scenario == "duplicate_storm"][1:]
    head = subs[:len(subs) - len(echoes)]
    head_replies = [fleet.submit(s) for s in head]
    states = fleet.await_terminal([r["id"] for r in head_replies])
    audited: dict[str, bool] = {}
    for s, r in zip(head, head_replies):
        if s.scenario not in audited:   # sampled: one per class per tick
            audited[s.scenario] = fleet.audit_ok(s, states[r["id"]])
    out["audits"].append(audited)
    out["audits_ok"] = out["audits_ok"] and all(audited.values())
    if echoes:
        # Wait for the scrape to learn THIS tick's storm cube (probing
        # len(result_index) would pass vacuously from tick 2 on).
        from iterative_cleaner_tpu_torch.fleet import cache as fleet_cache
        from iterative_cleaner_tpu_torch.ingest import cas

        digest = cas.file_digest(echoes[0].path)
        deadline = time.time() + 60
        while time.time() < deadline:
            salt = fleet_cache.unanimous_salt(
                fleet.router.registry.snapshot())
            if salt and fleet.router.result_index.lookup(digest, salt):
                break
            fleet.tick()
            time.sleep(0.05)
        cache0 = fleet.router.metrics.counter_total("fleet_cache_hits_total")
        done0 = fleet.jobs_done()
        echo_replies = [fleet.submit(s) for s in echoes]
        born_terminal = all(r.get("served_by") == "fleet-cache"
                            and r.get("state") == "done"
                            for r in echo_replies)
        cache_moved = (fleet.router.metrics.counter_total(
            "fleet_cache_hits_total") - cache0 == len(echoes))
        storm_ok = (born_terminal and cache_moved
                    and fleet.jobs_done() == done0)
        out["storm_cas_ok"] = out["storm_cas_ok"] and storm_ok
    fleet.tick()


def _trace_lane(fleet: ProvingFleet, cfg: SoakConfig) -> dict:
    """Record a trace from the soak's own event log and replay it at
    high compression: every replayed submission must dedupe (original
    idempotency keys) — zero new replica work, the dedupe counter moving
    one-for-one."""
    trace_path = os.path.join(fleet.workdir, "prove.trace.jsonl")
    recorded = traces.record_trace(fleet.telemetry, trace_path)
    entries = traces.load_trace(trace_path)
    done0 = fleet.jobs_done()
    dedup0 = fleet.router.metrics.counter_total(
        "fleet_deduped_submissions_total")
    report = traces.replay_trace(entries, fleet.base_url,
                                 compression=1000.0)
    fleet.submitted_total += report["submitted"]
    dedup_delta = int(fleet.router.metrics.counter_total(
        "fleet_deduped_submissions_total") - dedup0)
    ok = (recorded > 0 and not report["errors"]
          and report["submitted"] == len(entries)
          and dedup_delta == len(entries)
          and fleet.jobs_done() == done0)
    return {"ok": ok, "recorded": recorded,
            "replayed": report["submitted"],
            "deduped": dedup_delta, "errors": len(report["errors"]),
            "wall_s": report["wall_s"]}


def _chaos_lane(fleet: ProvingFleet, cfg: SoakConfig,
                wall_deadline: float) -> list[dict]:
    names = chaos.SMOKE_DRILLS if cfg.smoke else tuple(chaos.DRILLS)
    reports = []
    for name in names:
        if time.time() >= wall_deadline:
            reports.append({"fault": name, "ok": False,
                            "detail": "wall budget exhausted before drill"})
            continue
        fleet.faults_injected[name] = fleet.faults_injected.get(name, 0) + 1
        rep = chaos.DRILLS[name](fleet)
        if rep.healed:
            fleet.faults_healed[name] = fleet.faults_healed.get(name, 0) + 1
        fleet.tick()
        reports.append(rep.to_json())
    return reports


class _BudgetExhausted(RuntimeError):
    pass


def run_soak(cfg: SoakConfig) -> int:
    """Run the proving ground; prints exactly ONE JSON verdict line on
    stdout on every exit path; returns 0 iff the proof closed."""
    t0 = time.time()
    verdict: dict = {"prove": "fail",
                     "mode": "smoke" if cfg.smoke else "full",
                     "seed": cfg.seed, "backend": cfg.backend}
    rc = 1
    fleet = None
    workdir = cfg.workdir
    try:
        if cfg.job_budget <= 0:
            raise _BudgetExhausted(
                f"job budget {cfg.job_budget} cannot fund any proof")
        if not workdir:
            workdir = tempfile.mkdtemp(prefix="ict_prove_")
        wall_deadline = t0 + cfg.wall_budget_s
        fleet = ProvingFleet(workdir, seed=cfg.seed, backend=cfg.backend,
                             device=cfg.device)
        fallbacks0 = tracing.counters_snapshot().get(
            "service_oracle_fallbacks", 0)
        scen: dict = {"audits": [], "audits_ok": True, "storm_cas_ok": True}
        ticks_run = 0
        for i in range(cfg.ticks):
            if time.time() >= wall_deadline:
                break
            _scenario_tick(fleet, cfg, i, scen)
            ticks_run += 1
            if not cfg.quiet:
                print(f"[prove] scenario tick {i + 1}/{cfg.ticks}: "
                      f"{fleet.submitted_total} submitted",
                      file=sys.stderr)
        replay = _trace_lane(fleet, cfg)
        drills = _chaos_lane(fleet, cfg, wall_deadline)
        fleet.tick()
        ledger = fleet.ledger()
        cost_ok = fleet.cost_conservation_ok()
        triad = {
            "zero_lost_jobs": ledger["lost"] == 0 and ticks_run > 0,
            "bit_identical_masks": scen["audits_ok"] and ticks_run > 0,
            "cost_conservation": cost_ok,
        }
        drills_ok = bool(drills) and all(d.get("ok") for d in drills)
        # The trend plane's view of the run (fleet/trends.py):
        # a CLEAN soak — steady synthetic traffic, no real slowdown —
        # must not trip the regression sentinel; a firing here means
        # the fingerprint bands are mis-learned (or the fleet genuinely
        # destabilized mid-proof), either of which fails the proof.
        trends_plane = fleet.router.trends
        trends_block = {
            "enabled": trends_plane is not None,
            "ticks": (trends_plane.store.ticks()
                      if trends_plane is not None else 0),
            "series": (trends_plane.store.series_count()
                       if trends_plane is not None else 0),
            "regressions_total": (trends_plane.regressions_total()
                                  if trends_plane is not None else 0),
            "firing": (trends_plane.firing()
                       if trends_plane is not None else []),
        }
        trends_ok = (trends_block["regressions_total"] == 0
                     and not trends_block["firing"])
        # A device-backend proof that quietly served through the numpy
        # oracle proved nothing about the device: it fails.
        fallbacks = tracing.counters_snapshot().get(
            "service_oracle_fallbacks", 0) - fallbacks0
        if cfg.backend != "numpy" and fallbacks:
            verdict["error"] = (f"{fallbacks:g} oracle fallbacks on the "
                                f"{cfg.backend} backend")
        ok = (all(triad.values()) and drills_ok and replay["ok"]
              and scen["storm_cas_ok"] and trends_ok
              and (cfg.backend == "numpy" or not fallbacks))
        rc = 0 if ok else 1
        fleet.verdict_code = 1.0 if ok else 2.0
        fleet.tick()   # final verdict visible on /fleet/metrics
        # The SLI plane's view of the run (fleet/slo.py): the proving
        # traffic drives the derived "admission" journey, so a soak that
        # burned grant-waits shows up here even when the triad closed.
        slo_report = fleet.router.slo.report()
        adm = slo_report["journeys"].get("admission", {})
        verdict.update({
            "slo": {
                "tick": slo_report["tick"],
                "failing_journeys": slo_report["failing_journeys"],
                "admission": {k: adm.get(k) for k in
                              ("availability", "good", "bad")},
            }})
        verdict.update({
            "prove": "pass" if ok else "fail",
            "triad": triad, "jobs": ledger,
            "trends": {**trends_block, "ok": trends_ok},
            "scenario_ticks": ticks_run,
            "scenarios": dict(sorted(fleet.scenario_jobs.items())),
            "storm_cas_ok": scen["storm_cas_ok"],
            "audits": scen["audits"],
            "replay": replay, "drills": drills,
        })
    except _BudgetExhausted as exc:
        verdict["error"] = str(exc)
    except Exception as exc:    # the verdict line still prints
        verdict["error"] = f"{type(exc).__name__}: {exc}"
    finally:
        if fleet is not None:
            try:
                verdict.setdefault("jobs", fleet.ledger())
            except Exception:
                pass
            fleet.close()
        verdict["wall_s"] = round(time.time() - t0, 3)
        verdict["rc"] = rc
        print(json.dumps(verdict))
    return rc


def run_replay(trace_path: str, router_url: str,
               compression: float = 10.0) -> int:
    """``ict-clean-torch prove --replay``: re-issue one recorded trace (a
    sealed flight-recorder segment, or a record_trace output) against a
    LIVE router under the original idempotency keys.  One JSON report
    line on stdout on every exit path; rc 0 when every entry was
    submitted and none errored — whether each deduped is visible in the
    report's dedupe delta (a window the fleet already served must come
    back all-dedupe, zero new replica work)."""
    report: dict = {"trace": trace_path, "router": router_url}
    rc = 1
    try:
        entries = traces.load_trace(trace_path)
        report["entries"] = len(entries)

        def _dedup_total() -> float | None:
            try:
                req = urllib.request.urlopen(
                    f"{router_url.rstrip('/')}/metrics", timeout=10)
                text = req.read().decode()
            except (OSError, ValueError):
                return None
            for fam in obs_metrics.parse_exposition(text):
                if fam.name == "ict_fleet_deduped_submissions_total":
                    return sum(obs_metrics.sample_value(raw)
                               for _n, _l, raw in fam.samples)
            return 0.0

        dedup0 = _dedup_total()
        result = traces.replay_trace(entries, router_url,
                                     compression=compression)
        dedup1 = _dedup_total()
        report.update(result)
        report["dedup_delta"] = (
            None if dedup0 is None or dedup1 is None
            else dedup1 - dedup0)
        rc = 0 if (not result["errors"]
                   and result["submitted"] == len(entries)) else 1
    except (OSError, ValueError) as exc:
        report["error"] = str(exc)
    finally:
        report["rc"] = rc
        print(json.dumps(report))
    return rc


def prove_main(argv: list | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="ict-clean-torch prove",
        description="Run the proving ground: scenario mix + chaos drills "
                    "against a hermetic in-process fleet; one JSON "
                    "verdict line on stdout (docs/PROVING.md).")
    p.add_argument("--smoke", action="store_true",
                   help="the bounded CI lane: one scenario-mix tick, the "
                        "trace replay lane, one replica-kill drill")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ticks", type=int, default=None,
                   help="scenario-mix ticks (default: 1 smoke / 3 full)")
    p.add_argument("--job_budget", type=int, default=None,
                   help="max external submissions (default: 64 smoke / "
                        "512 full); a budget that cannot fund the proof "
                        "is a FAIL")
    p.add_argument("--wall_budget_s", type=float, default=None,
                   help="wall-clock budget (default: 300 smoke / 1800 "
                        "full)")
    p.add_argument("--backend", default="torch",
                   choices=("numpy", "torch"),
                   help="replica clean backend (default torch: the "
                        "device path, held against the numpy oracle; "
                        "numpy serves through the oracle itself)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the replicas (default: cuda; "
                        "pass 'cpu' to run on the CPU)")
    p.add_argument("--workdir", default="",
                   help="working directory (default: a fresh tempdir)")
    p.add_argument("--replay", default="", metavar="TRACE",
                   help="replay ONE recorded trace file (a sealed "
                        "flight-recorder segment, or a record_trace "
                        "output) against --router under its original "
                        "idempotency keys, print a JSON report line, "
                        "and exit — a window the fleet already served "
                        "must dedupe one-for-one")
    p.add_argument("--router", default="http://127.0.0.1:8790",
                   metavar="URL",
                   help="fleet router base URL for --replay "
                        "(default http://127.0.0.1:8790)")
    p.add_argument("--compression", type=float, default=10.0,
                   metavar="X",
                   help="--replay time compression: X times faster than "
                        "recorded (default 10.0)")
    p.add_argument("-q", "--quiet", action="store_true")
    args = p.parse_args(argv)
    if args.replay:
        return run_replay(args.replay, args.router,
                          compression=args.compression)
    return run_soak(SoakConfig(
        smoke=args.smoke, seed=args.seed, ticks=args.ticks,
        job_budget=args.job_budget, wall_budget_s=args.wall_budget_s,
        backend=args.backend, workdir=args.workdir, quiet=args.quiet,
        device=args.device))


if __name__ == "__main__":
    sys.exit(prove_main())
