#!/usr/bin/env python
"""fleet_top: terminal snapshot (or live watch) of a fleet router.

``python tools_torch/fleet_top.py --router http://host:8790`` fetches the
router's ``/healthz``, ``GET /fleet/capacity``, ``GET /fleet/alerts``,
``GET /fleet/costs``, and ``GET /fleet/metrics`` and prints one
human-readable snapshot: per-replica state (alive/draining/dead,
straggler and autoscale-managed flags, queue depths, utilization,
service rate, dispatch p50), per-bucket backlog/demand/drain-ETA rows
(with roofline attainment), the fleet totals, the autoscaler state, a
CAMPAIGNS section off the survey orchestrator (per-campaign archive
progress and device-seconds), a TENANTS showback section off the cost
plane (device-seconds, jobs, cache savings, budget burn), a SOAK
section off the proving ground's ``ict_prove_*`` gauges when an
``ict-clean-torch prove`` soak is driving the router (docs/PROVING.md), an
SLO section off the SLI/error-budget plane (``GET /fleet/slo``:
per-journey availability/correctness, p99 latency, budget remaining,
burn rates, and the canary prober's round count — docs/OBSERVABILITY.md
"Canary probing & SLOs"), a TREND section off the durable
performance-trend plane (``GET /fleet/trends``: fingerprint table with
learned centers/bands, per-series sparklines, firing regressions —
docs/OBSERVABILITY.md "Performance trends & regression sentinel"), a
RECORDER line off the production flight recorder's segment inventory
(``GET /fleet/traces``: sealed segments, bytes, open tape,
entry/excluded/dropped tallies), and a
FIRING ALERTS section off the alerting plane.  ``fleet_top.py explain
<job_id>`` is a one-shot mode instead: it prints the per-job causal
report off ``GET /fleet/explain/<job_id>`` (the same renderer as
``ict-clean-torch explain``) and exits.  ``--json`` prints the same snapshot as ONE JSON line
for scripting (the bench.py one-line contract); ``--watch N``
re-renders every N seconds until interrupted (one JSON line per
refresh in ``--json`` mode).  Read-only: five GETs, no mutation, safe
against a production router.

Port of ``tools/fleet_top.py``: it reads the exposition, trends and
explain views through the port's ``obs.metrics``, ``fleet.trends`` and
``fleet.explain``, so it runs where JAX is not installed.  Tests point it
at an in-process port fleet (tests/test_torch_fleet.py).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import urllib.error
import urllib.parse
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _get_json(base: str, route: str, timeout_s: float) -> dict:
    with urllib.request.urlopen(f"{base}{route}", timeout=timeout_s) as resp:
        return json.load(resp)


def _get_text(base: str, route: str, timeout_s: float) -> str:
    with urllib.request.urlopen(f"{base}{route}", timeout=timeout_s) as resp:
        return resp.read().decode("utf-8")


def collect(base: str, timeout_s: float = 10.0) -> dict:
    """The snapshot dict both output modes render: healthz + capacity +
    alerts, with the straggler/p50 gauges — and the throughput-tier
    figures (per-bucket coalesce batch-size p50s, result-cache hit
    rates) — read off the FEDERATED exposition (``GET /fleet/metrics``,
    whose first section is the router's own registry, so every series
    the old ``/metrics`` scrape carried is still here).  Everything
    fleet_top shows is an exported figure — the explainability contract,
    docs/OBSERVABILITY.md."""
    from iterative_cleaner_tpu_torch.obs import metrics as obs_metrics

    health = _get_json(base, "/healthz", timeout_s)
    capacity = _get_json(base, "/fleet/capacity", timeout_s)
    try:
        alerts = _get_json(base, "/fleet/alerts", timeout_s)
    except (urllib.error.URLError, OSError, ValueError):
        alerts = {}   # pre-alerting routers still render everything else
    try:
        costs = _get_json(base, "/fleet/costs", timeout_s)
    except (urllib.error.URLError, OSError, ValueError):
        costs = {}    # pre-costs routers still render everything else
    try:
        slo = _get_json(base, "/fleet/slo", timeout_s)
    except (urllib.error.URLError, OSError, ValueError):
        slo = {}      # pre-SLO routers still render everything else
    try:
        traces = _get_json(base, "/fleet/traces", timeout_s)
    except (urllib.error.URLError, OSError, ValueError):
        traces = {}   # pre-recorder routers still render everything else
    # The trend plane (GET /fleet/trends): the unfiltered reply is a
    # bounded inventory + fingerprint table; the sparkline rings are
    # fetched per signal family (a handful of narrow queries) so the
    # snapshot never ships every retained series.
    try:
        trends = _get_json(base, "/fleet/trends", timeout_s)
    except (urllib.error.URLError, OSError, ValueError):
        trends = {}   # pre-trend routers still render everything else
    if trends.get("enabled"):
        spark_fams: list[str] = []
        for spec in (trends.get("fingerprints") or {}).get("signals") or []:
            for key in ("family", "num_family"):
                fam_name = spec.get(key)
                if fam_name and fam_name not in spark_fams:
                    spark_fams.append(fam_name)
        series: list[dict] = []
        for fam_name in spark_fams[:6]:
            try:
                sub = _get_json(
                    base,
                    "/fleet/trends?family="
                    f"{urllib.parse.quote(fam_name)}"
                    "&resolution=raw&window=32", timeout_s)
                series.extend(sub.get("series") or [])
            except (urllib.error.URLError, OSError, ValueError):
                pass
        trends["series"] = series
    p50s: dict[str, float] = {}
    scale_events = 0.0
    # bucket -> {k -> dispatch count} (the merged fleet-wide coalesce
    # batch-size distribution) and bucket -> {outcome -> count} (the
    # merged replica-side result-cache counters).
    co_sizes: dict[str, dict[int, float]] = {}
    cache_counts: dict[str, dict[str, float]] = {}
    # The proving-ground gauges (only present while an ``ict-clean-torch
    # prove`` soak is driving this router — docs/PROVING.md): scenario
    # job counts, chaos-drill inject/heal tallies, and the running
    # verdict / sink-degraded flags.
    soak_scenarios: dict[str, float] = {}
    soak_faults: dict[str, dict[str, float]] = {}
    soak_verdict: float | None = None
    soak_sink_degraded: float | None = None
    try:
        fams = obs_metrics.parse_exposition(
            _get_text(base, "/fleet/metrics", timeout_s))
    except (OSError, ValueError):
        fams = []
    for fam in fams:
        for _name, labels, raw in fam.samples:
            d = dict(labels)
            if fam.name == "ict_fleet_replica_p50_seconds" and "replica" in d:
                p50s[d["replica"]] = obs_metrics.sample_value(raw)
            elif fam.name == "ict_fleet_scale_events_total":
                scale_events += obs_metrics.sample_value(raw)
            elif (fam.name == "ict_fleet_coalesce_batch_size_total"
                    and "shape_bucket" in d and "k" in d):
                try:
                    k = int(d["k"])
                except ValueError:
                    continue
                co_sizes.setdefault(d["shape_bucket"], {})[k] = \
                    co_sizes.get(d["shape_bucket"], {}).get(k, 0.0) \
                    + obs_metrics.sample_value(raw)
            elif (fam.name == "ict_fleet_result_cache_total"
                    and "shape_bucket" in d and "outcome" in d):
                bucket = cache_counts.setdefault(d["shape_bucket"], {})
                bucket[d["outcome"]] = (bucket.get(d["outcome"], 0.0)
                                        + obs_metrics.sample_value(raw))
            elif fam.name == "ict_prove_scenario_jobs" and "scenario" in d:
                soak_scenarios[d["scenario"]] = obs_metrics.sample_value(raw)
            elif (fam.name in ("ict_prove_faults_injected",
                               "ict_prove_faults_healed")
                    and "fault" in d):
                rec = soak_faults.setdefault(d["fault"],
                                             {"injected": 0.0, "healed": 0.0})
                which = ("injected" if fam.name.endswith("injected")
                         else "healed")
                rec[which] = obs_metrics.sample_value(raw)
            elif fam.name == "ict_prove_soak_verdict":
                soak_verdict = obs_metrics.sample_value(raw)
            elif fam.name == "ict_prove_event_sink_degraded":
                soak_sink_degraded = obs_metrics.sample_value(raw)
    return {
        "router": base,
        "router_id": health.get("router_id"),
        "health": health,
        "capacity": capacity,
        "alerts": alerts,
        "costs": costs,
        "p50s": p50s,
        "scale_events_total": scale_events,
        "coalesce_p50s": {b: dispatch_size_p50(sizes)
                          for b, sizes in co_sizes.items()},
        "cache_hit_rates": {b: cache_hit_rate(counts)
                            for b, counts in cache_counts.items()},
        "fleet_cache": health.get("result_cache") or {},
        "campaigns": health.get("campaigns") or {},
        "slo": slo,
        "trends": trends,
        "recorder": traces.get("recorder") or {},
        "soak": ({"scenarios": soak_scenarios, "faults": soak_faults,
                  "verdict": soak_verdict,
                  "sink_degraded": soak_sink_degraded}
                 if (soak_scenarios or soak_faults
                     or soak_verdict is not None) else {}),
    }


def dispatch_size_p50(sizes: dict[int, float]) -> float | None:
    """Weighted median batch size over one bucket's dispatch counts
    ({k -> dispatches}) — the per-bucket coalesce figure the bucket
    table shows."""
    total = sum(sizes.values())
    if total <= 0:
        return None
    cum = 0.0
    for k in sorted(sizes):
        cum += sizes[k]
        if cum >= total / 2:
            return float(k)
    return float(max(sizes))


def cache_hit_rate(counts: dict[str, float]) -> float | None:
    """hits / (hits + misses) for one bucket's merged result-cache
    counters; None before any lookup."""
    hits = counts.get("hit", 0.0)
    total = hits + counts.get("miss", 0.0)
    return (hits / total) if total > 0 else None


def _fmt_num(value) -> str:
    if value is None:
        return "-"
    value = float(value)
    if value == float("inf"):
        return "inf"
    if value == int(value) and abs(value) < 1e6:
        return str(int(value))
    return f"{value:.3g}"


def render(snap: dict) -> str:
    """The human view: replicas, buckets, fleet, autoscale, firing
    alerts — aligned columns, one screen."""
    health = snap["health"]
    capacity = snap["capacity"]
    caps = capacity.get("replicas", {})
    stragglers = set(capacity.get("stragglers", []))
    managed = capacity.get("managed_replicas", {}) or {}
    lines = [
        f"fleet {health.get('router_id', '?')} @ {snap['router']}  "
        f"replicas_alive={health.get('replicas_alive')}  "
        f"open={health.get('open_placements')}  "
        f"queued={health.get('queued_submissions')}  "
        f"last_poll_age_s={health.get('last_poll_age_s')}",
        "",
        f"{'REPLICA':<16} {'STATE':<10} {'FLAGS':<10} {'QUEUED':>6} "
        f"{'UTIL':>6} {'RATE/S':>7} {'P50_S':>7}",
    ]
    for row in health.get("replicas", []):
        rid = row.get("replica_id") or row.get("base_url", "?")
        state = ("dead" if not row.get("alive")
                 else "draining" if row.get("draining") else "alive")
        flags = []
        if rid in stragglers:
            flags.append("strag")
        if rid in managed:
            flags.append("mgd")
        cap = caps.get(rid, {})
        queued = (float(row.get("bucketed_cubes", 0) or 0)
                  + float(row.get("load_queue_depth", 0) or 0)
                  + float(row.get("dispatch_queue_depth", 0) or 0))
        lines.append(
            f"{rid:<16} {state:<10} {','.join(flags) or '-':<10} "
            f"{_fmt_num(queued):>6} "
            f"{_fmt_num(cap.get('utilization')):>6} "
            f"{_fmt_num(cap.get('service_rate')):>7} "
            f"{_fmt_num(snap['p50s'].get(rid, cap.get('p50_s'))):>7}")
    buckets = capacity.get("buckets", {})
    co_p50s = snap.get("coalesce_p50s") or {}
    hit_rates = snap.get("cache_hit_rates") or {}
    cost_buckets = (snap.get("costs") or {}).get("buckets") or {}
    if buckets or co_p50s or hit_rates or cost_buckets:
        lines += ["", f"{'BUCKET':<16} {'BACKLOG':>8} {'DEMAND/S':>9} "
                      f"{'ETA_S':>8} {'COST_B':>10} {'CO_P50':>7} "
                      f"{'HIT%':>6} {'ATTAIN':>7}"]
        for bucket in sorted({*buckets, *co_p50s, *hit_rates,
                              *cost_buckets}):
            rec = buckets.get(bucket, {})
            rate = hit_rates.get(bucket)
            crec = cost_buckets.get(bucket, {})
            lines.append(
                f"{bucket:<16} {_fmt_num(rec.get('backlog')):>8} "
                f"{_fmt_num(rec.get('demand_rate')):>9} "
                f"{_fmt_num(rec.get('eta_s')):>8} "
                f"{_fmt_num(rec.get('cost_bytes')):>10} "
                f"{_fmt_num(co_p50s.get(bucket)):>7} "
                f"{_fmt_num(round(rate * 100, 1)) if rate is not None else '-':>6} "
                f"{_fmt_num(crec.get('attainment')):>7}")
    lines += render_campaigns(snap.get("campaigns") or {})
    lines += render_tenants(snap.get("costs") or {})
    lines += render_soak(snap.get("soak") or {})
    lines += render_slo(snap.get("slo") or {})
    lines += render_trend_section(snap.get("trends") or {})
    fleet = capacity.get("fleet", {})
    if fleet:
        fc = snap.get("fleet_cache") or {}
        lines += ["",
                  f"fleet  util={_fmt_num(fleet.get('utilization'))}  "
                  f"rate={_fmt_num(fleet.get('service_rate'))}/s  "
                  f"demand={_fmt_num(fleet.get('demand_rate'))}/s  "
                  f"backlog={_fmt_num(fleet.get('backlog'))}  "
                  f"eta={_fmt_num(fleet.get('backlog_eta_s'))}s  "
                  f"cache={_fmt_num(fc.get('hits'))}h/"
                  f"{_fmt_num(fc.get('misses'))}m"
                  f" ({_fmt_num(fc.get('entries'))} idx)"]
    lines += render_recorder(snap.get("recorder") or {})
    scaler = capacity.get("autoscale")
    if scaler:
        last = scaler.get("last_decision") or {}
        lines += [
            f"autoscale mode={scaler.get('mode')}  "
            f"bounds=[{scaler.get('min_replicas')},"
            f"{scaler.get('max_replicas')}]  "
            f"streaks=up:{scaler.get('up_streak')}/"
            f"down:{scaler.get('down_streak')}  "
            f"cooldown={_fmt_num(scaler.get('cooldown_remaining_s'))}s  "
            f"events={_fmt_num(snap.get('scale_events_total'))}"
            + (f"  last={last.get('direction')}:{last.get('reason')}"
               if last else "")]
    else:
        lines += ["autoscale off"]
    lines += render_alerts(snap.get("alerts") or {})
    return "\n".join(lines)


def render_campaigns(campaigns: dict) -> list[str]:
    """The CAMPAIGNS section (from ``/healthz``, the orchestrator's
    summary): one row per campaign — state, tenant, archive progress,
    errors, and the attributed device-seconds from the showback fold.
    The header aggregates archive states across every OPEN campaign so
    survey progress reads at a glance."""
    rows = campaigns.get("campaigns") or []
    if not rows:
        return []
    states = campaigns.get("archives") or {}
    agg = "  ".join(f"{s}={_fmt_num(states[s])}"
                    for s in ("pending", "placed", "done", "error",
                              "cancelled") if states.get(s))
    lines = ["", f"CAMPAIGNS  (open={campaigns.get('open', 0)}"
                 + (f"  {agg}" if agg else "") + ")",
             f"{'CAMPAIGN':<22} {'NAME':<16} {'STATE':<10} {'TENANT':<12} "
             f"{'DONE/TOT':>9} {'ERR':>4} {'DEVICE_S':>9}"]
    for row in rows:
        arch = row.get("archives") or {}
        lines.append(
            f"{str(row.get('id', '?'))[:22]:<22} "
            f"{str(row.get('name', '?'))[:16]:<16} "
            f"{row.get('state', '?'):<10} "
            f"{str(row.get('tenant', '?'))[:12]:<12} "
            f"{_fmt_num(arch.get('done', 0))}/"
            f"{_fmt_num(arch.get('total', 0)):<4} "
            f"{_fmt_num(arch.get('error', 0)):>4} "
            f"{_fmt_num(row.get('device_s')):>9}")
    return lines


def render_tenants(costs: dict) -> list[str]:
    """The TENANTS showback section (from ``GET /fleet/costs``): one row
    per tenant — attributed device-seconds, jobs, cache savings (the
    device-seconds the content caches avoided for this tenant), and the
    advisory budget burn; the section header carries the best observed
    roofline attainment so efficiency sits next to consumption."""
    tenants = costs.get("tenants") or {}
    if not tenants:
        return []
    attains = [rec.get("attainment")
               for rec in (costs.get("buckets") or {}).values()
               if rec.get("attainment") is not None]
    head = "TENANTS" + (f"  (best attainment {_fmt_num(max(attains))})"
                        if attains else "")
    lines = ["", head,
             f"{'TENANT':<16} {'DEVICE_S':>10} {'JOBS':>6} "
             f"{'SAVED_S':>8} {'BUDGET%':>8}"]
    for tenant in sorted(tenants):
        rec = tenants[tenant]
        pct = rec.get("budget_used_pct")
        lines.append(
            f"{tenant:<16} {_fmt_num(rec.get('device_s')):>10} "
            f"{_fmt_num(rec.get('jobs')):>6} "
            f"{_fmt_num(rec.get('avoided_device_s')):>8} "
            f"{_fmt_num(pct) if pct is not None else '-':>8}")
    return lines


def render_soak(soak: dict) -> list[str]:
    """The SOAK section (from the ``ict_prove_*`` gauges a running
    ``ict-clean-torch prove`` soak publishes on the router — docs/PROVING.md):
    per-scenario job counts, per-fault inject/heal tallies, the running
    verdict (running/pass/fail) and the telemetry-sink health.  Empty
    (section absent) when no soak has touched this router."""
    if not soak:
        return []
    verdict = soak.get("verdict")
    verdict_s = {0.0: "running", 1.0: "pass", 2.0: "fail"}.get(
        verdict, _fmt_num(verdict))
    sink = soak.get("sink_degraded")
    head = (f"SOAK  (verdict={verdict_s}"
            + (f"  sink={'degraded' if sink else 'ok'}"
               if sink is not None else "") + ")")
    lines = ["", head]
    scenarios = soak.get("scenarios") or {}
    if scenarios:
        lines.append(f"{'SCENARIO':<20} {'JOBS':>6}")
        for name in sorted(scenarios):
            lines.append(f"{name:<20} {_fmt_num(scenarios[name]):>6}")
    faults = soak.get("faults") or {}
    if faults:
        lines.append(f"{'FAULT':<22} {'INJECTED':>9} {'HEALED':>7}")
        for name in sorted(faults):
            rec = faults[name]
            lines.append(f"{name:<22} {_fmt_num(rec.get('injected')):>9} "
                         f"{_fmt_num(rec.get('healed')):>7}")
    return lines


def render_slo(slo: dict) -> list[str]:
    """The SLO section (from ``GET /fleet/slo``): one row per journey —
    availability, correctness, p99 latency, and (for journeys with a
    declared ``--slo`` objective) the target, budget remaining, and
    fast/slow burn rates.  The header carries the canary prober's state
    and any journeys currently vetoing scale-down.  Empty (section
    absent) when the router predates the SLO plane."""
    journeys = slo.get("journeys") or {}
    if not journeys:
        return []
    canary = slo.get("canary") or {}
    failing = slo.get("failing_journeys") or []
    head = ("SLO  (canary="
            + ("off" if not canary.get("enabled")
               else f"every {_fmt_num(canary.get('cadence_ticks'))} ticks, "
                    f"{_fmt_num(canary.get('rounds'))} rounds")
            + (f"  FAILING: {','.join(failing)}" if failing else "") + ")")
    lines = ["", head,
             f"{'JOURNEY':<10} {'AVAIL':>7} {'CORRECT':>8} {'P99_S':>8} "
             f"{'TARGET':>7} {'BUDGET%':>8} {'BURN_F':>7} {'BURN_S':>7}"]
    for name in sorted(journeys):
        rec = journeys[name]
        burn = rec.get("burn") or {}
        lines.append(
            f"{name:<10} {_fmt_num(rec.get('availability')):>7} "
            f"{_fmt_num(rec.get('correctness')):>8} "
            f"{_fmt_num(rec.get('latency_p99_s')):>8} "
            f"{_fmt_num(rec.get('target')):>7} "
            f"{_fmt_num(rec.get('budget_remaining_pct')):>8} "
            f"{_fmt_num(burn.get('fast')):>7} "
            f"{_fmt_num(burn.get('slow')):>7}")
    return lines


def render_trend_section(trends: dict) -> list[str]:
    """The TREND section (from ``GET /fleet/trends``): the fingerprint
    table with learned centers/bands and per-series sparklines (rings
    fetched per signal family in :func:`collect`), plus any firing
    regressions — rendered through the same
    ``fleet.trends.render_trends`` the ``ict-clean-torch trends`` one-shot
    uses (docs/OBSERVABILITY.md "Performance trends & regression
    sentinel").  Empty (section absent) when the router predates the
    trend plane or runs with it disabled."""
    if not trends or not trends.get("enabled"):
        return []
    from iterative_cleaner_tpu_torch.fleet import trends as fleet_trends
    return ["", "TREND", fleet_trends.render_trends(trends)]


def render_recorder(rec: dict) -> list[str]:
    """The RECORDER line (from ``GET /fleet/traces``): the production
    flight recorder's footprint — sealed segments on disk and their
    bytes, the open tape depth, and the lifetime entry/excluded/dropped
    tallies (dropped > 0 means real traffic is NOT fully replayable —
    docs/OBSERVABILITY.md "Production recorder & explain plane").
    Empty (line absent) when the router predates the recorder."""
    if not rec:
        return []
    return [
        f"recorder {'on' if rec.get('enabled') else 'OFF'}  "
        f"segments={_fmt_num(rec.get('segments'))} "
        f"({_fmt_num(rec.get('segment_bytes'))}B)  "
        f"open={_fmt_num(rec.get('open_entries'))}  "
        f"entries={_fmt_num(rec.get('entries_total'))}  "
        f"excluded={_fmt_num(rec.get('excluded_total'))}  "
        f"dropped={_fmt_num(rec.get('dropped_total'))}"]


def render_alerts(alerts: dict) -> list[str]:
    """The FIRING ALERTS section (from ``GET /fleet/alerts``): one row
    per firing (rule, series) — severity, rule, series labels, the
    evaluated value, and how long it has been firing."""
    firing = alerts.get("firing") or []
    if not firing:
        return ["", "alerts: none firing"
                + (f"  ({len(alerts.get('rules', []))} rules loaded)"
                   if alerts.get("rules") else "")]
    lines = ["", "FIRING ALERTS",
             f"{'SEVERITY':<9} {'RULE':<28} {'SERIES':<24} {'VALUE':>10} "
             f"{'FOR_S':>7}"]
    now = time.time()
    for a in firing:
        labels = ",".join(f"{k}={v}"
                          for k, v in sorted((a.get("labels") or {}).items()))
        since = a.get("since_ts") or 0
        lines.append(
            f"{a.get('severity', '?'):<9} {a.get('rule', '?'):<28} "
            f"{labels or 'fleet':<24} {_fmt_num(a.get('value')):>10} "
            f"{_fmt_num(max(now - since, 0.0) if since else None):>7}")
    return lines


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="fleet_top",
        description="Snapshot (or --watch) of a fleet router's capacity "
                    "and alerting view (/healthz + /fleet/capacity + "
                    "/fleet/alerts + /metrics; read-only)")
    p.add_argument("--router", default="http://127.0.0.1:8790",
                   metavar="URL", help="router base URL "
                   "(default http://127.0.0.1:8790)")
    p.add_argument("--json", action="store_true",
                   help="one machine-readable JSON line (per refresh in "
                        "--watch mode) instead of the terminal table")
    p.add_argument("--watch", type=float, default=0.0, metavar="N",
                   help="continuous-refresh mode: re-render every N "
                        "seconds until interrupted (0 = one shot, the "
                        "default)")
    p.add_argument("--iterations", type=int, default=0, metavar="K",
                   help="with --watch: stop after K refreshes "
                        "(0 = until interrupted; the offline-test hook)")
    p.add_argument("--timeout_s", type=float, default=10.0, metavar="S")
    p.add_argument("command", nargs="*", metavar="CMD",
                   help="optional one-shot command: 'explain <job_id>' "
                        "prints the per-job causal report off "
                        "GET /fleet/explain/<job_id> and exits")
    args = p.parse_args(argv)
    base = args.router.rstrip("/")

    if args.command:
        # The explain one-shot: same endpoint, same renderer as
        # ``ict-clean-torch explain`` — fleet_top just saves the operator a
        # tool switch mid-investigation.
        from iterative_cleaner_tpu_torch.fleet import explain as fleet_explain
        if args.command[0] != "explain" or len(args.command) != 2:
            print(f"error: unknown command {' '.join(args.command)!r}; "
                  "want: explain <job_id>", file=sys.stderr)
            return 2
        code, report = fleet_explain.fetch_explain(
            base, args.command[1], timeout_s=args.timeout_s)
        if args.json:
            print(json.dumps(report, default=str))
            return 0 if code == 200 else 1
        if code != 200:
            print(f"error: explain {args.command[1]}: HTTP {code} "
                  f"{report.get('error', '')}", file=sys.stderr)
            return 1
        print(fleet_explain.render_explain(report))
        return 0

    def one_shot() -> int:
        try:
            snap = collect(base, timeout_s=args.timeout_s)
        except (urllib.error.URLError, OSError, ValueError) as exc:
            if args.json:
                print(json.dumps({"error": f"router unreachable: {exc}",
                                  "router": base}))
            else:
                print(f"error: router unreachable at {base}: {exc}",
                      file=sys.stderr)
            return 1
        if args.json:
            print(json.dumps(snap, default=str))
        else:
            if args.watch > 0 and sys.stdout.isatty():
                # Clear + home between refreshes on a real terminal;
                # piped output gets plain successive snapshots.
                print("\x1b[2J\x1b[H", end="")
            print(render(snap))
        return 0

    if args.watch <= 0:
        return one_shot()
    n = 0
    rc = 0
    try:
        while True:
            rc = one_shot()
            n += 1
            if args.iterations and n >= args.iterations:
                return rc
            time.sleep(args.watch)
    except KeyboardInterrupt:
        return rc


if __name__ == "__main__":
    raise SystemExit(main())
