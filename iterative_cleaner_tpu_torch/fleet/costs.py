"""Fleet-wide cost federation: tenant showback, budgets, and the
conservation check (the router half; replica half in
obs/costs.py).

Port of ``iterative_cleaner_tpu/fleet/costs.py``.

Zero new traffic by construction: the replica ledgers render their
aggregates as ``ict_cost_*`` counters on the ``/metrics`` exposition the
router's poll tick ALREADY scrapes (fleet/obs.ScrapeCache); this module
folds those cached parsed families into the ``GET /fleet/costs`` view —
per-tenant / per-bucket / per-replica breakdowns — once per tick, the
fleet/capacity.py pattern.

Budgets are **advisory**: ``--tenant NAME:QUOTA:WEIGHT[:BUDGET]`` grows
an optional device-seconds budget that feeds default alert RULES (never
admission changes — quotas stay the only admission lever).  The router
rebuilds the ``ict_fleet_tenant_budget_used_pct{tenant}`` gauge whole
each tick from the ALIVE replicas' scraped per-life counters, and
:func:`budget_rules` installs two rules per budgeted tenant over it:
``tenant_budget_burn:<name>`` (warning at 80%) and
``tenant_budget_exhausted:<name>`` (critical at 100%).  Because the
gauge is rebuilt from live scrapes, a replica that restarts clean (its
pre-registered counters read an explicit 0) or leaves the fleet drops
its usage from the gauge and a fired budget alert RESOLVES — the
freeze-on-missing lesson, designed in rather than patched in.

The **conservation check** rides the same fold: per replica,
``Σ ict_cost_device_seconds_total`` over tenants divided by
``ict_service_dispatch_s`` must sit within 1% of 1.0 whenever the
replica has dispatched at all — attribution that doesn't conserve is
fiction, and the ratio is exported
(``ict_fleet_cost_conservation_ratio{replica}``) so the invariant is a
scrapeable fact, not a test-only assertion.
"""

from __future__ import annotations

import time

from iterative_cleaner_tpu_torch.fleet import alerts as fleet_alerts
from iterative_cleaner_tpu_torch.fleet.capacity import (
    counter_value,
    labeled_gauge_values,
)
from iterative_cleaner_tpu_torch.fleet.tenants import SYNTHETIC_TENANT
from iterative_cleaner_tpu_torch.obs import metrics as obs_metrics

#: |conservation_ratio - 1| beyond this is an attribution bug (the smoke
#: and the e2e tests assert it; float split error is ~1e-9, so 1% is
#: pure headroom for counter-read skew between the two families).
CONSERVATION_TOLERANCE = 0.01


def _labeled_counter_sums(families, family: str, label_key: str,
                          ) -> dict[str, float]:
    """``{label value -> summed sample value}`` for one labeled counter
    family out of a parsed scrape.  Walks the RAW samples (not the
    capacity gauge helper, which keeps last-wins per label value): two
    samples sharing a ``label_key`` value but differing on some other
    label dimension must SUM, or the fold under-reports the tenant and
    the conservation ratio reads falsely low."""
    out: dict[str, float] = {}
    for fam in families:
        if fam.name != family:
            continue
        for _sname, label_pairs, raw in fam.samples:
            d = dict(label_pairs)
            if label_key not in d:
                continue
            try:
                value = obs_metrics.sample_value(raw)
            except ValueError:
                continue
            out[d[label_key]] = out.get(d[label_key], 0.0) + value
    return out


def fold(replica_rows: list[dict], scrapes: dict[str, dict],
         budgets: dict[str, float] | None = None) -> dict:
    """One tick's fleet cost view from the registry + scrape-cache
    snapshots the router already took.  Only ALIVE replicas contribute
    (a departed or restarted-clean replica's usage leaves the fold —
    the advisory-budget resolution semantics documented above); each
    contributing replica also gets its conservation ratio."""
    budgets = dict(budgets or {})
    tenants: dict[str, dict] = {}
    buckets: dict[str, dict] = {}
    routes: dict[str, dict] = {}
    replicas: dict[str, dict] = {}

    def tenant_row(name: str) -> dict:
        return tenants.setdefault(name, {
            "device_s": 0.0, "jobs": 0.0, "compile_s": 0.0,
            "bytes_accessed": 0.0, "cache_hits": 0.0,
            "avoided_device_s": 0.0, "avoided_bytes": 0.0,
        })

    for row in replica_rows:
        if not row.get("alive"):
            continue
        rid = row.get("replica_id") or row.get("base_url", "")
        rec = scrapes.get(rid)
        families = (rec or {}).get("families") or []
        if not families:
            continue
        per_tenant = _labeled_counter_sums(
            families, "ict_cost_device_seconds_total", "tenant")
        for tenant, v in per_tenant.items():
            tenant_row(tenant)["device_s"] += v
        for family, key in (("ict_cost_jobs_total", "jobs"),
                            ("ict_cost_compile_seconds_total", "compile_s"),
                            ("ict_cost_bytes_accessed_total",
                             "bytes_accessed"),
                            ("ict_cost_cache_hits_total", "cache_hits"),
                            ("ict_cost_cache_avoided_device_seconds_total",
                             "avoided_device_s"),
                            ("ict_cost_cache_avoided_bytes_total",
                             "avoided_bytes")):
            for tenant, v in _labeled_counter_sums(
                    families, family, "tenant").items():
                tenant_row(tenant)[key] += v
        for bucket, v in _labeled_counter_sums(
                families, "ict_cost_bucket_device_seconds_total",
                "shape_bucket").items():
            buckets.setdefault(bucket, {"device_s": 0.0,
                                        "attainment": None})
            buckets[bucket]["device_s"] += v
        for bucket, v in labeled_gauge_values(
                families, "ict_cost_attainment_ratio",
                "shape_bucket").items():
            rec_b = buckets.setdefault(bucket, {"device_s": 0.0,
                                                "attainment": None})
            # Latest-known attainment per bucket; max across replicas
            # (the gauge-merge "peaks don't average" rationale).
            if v and (rec_b["attainment"] is None
                      or v > rec_b["attainment"]):
                rec_b["attainment"] = v
        for route, v in _labeled_counter_sums(
                families, "ict_cost_route_device_seconds_total",
                "route").items():
            routes.setdefault(route, {"device_s": 0.0})
            routes[route]["device_s"] += v
        cost_s = sum(per_tenant.values())
        dispatch_s = counter_value(families, "ict_service_dispatch_s")
        replicas[rid] = {
            "device_s": round(cost_s, 6),
            "dispatch_s": round(dispatch_s, 6),
            "conservation_ratio": (round(cost_s / dispatch_s, 6)
                                   if dispatch_s > 0 else None),
        }

    # Canary traffic is excluded from SHOWBACK, not from conservation:
    # the reserved synthetic tenant's device time stays in each replica's
    # cost_s sum above (attribution must still conserve against dispatch
    # seconds — probe work is real work), but it is nobody's bill, so the
    # tenant table never grows a "_canary" row.
    tenants.pop(SYNTHETIC_TENANT, None)
    for tenant, budget in budgets.items():
        row = tenant_row(tenant)
        row["budget_device_s"] = float(budget)
    for tenant, row in tenants.items():
        budget = budgets.get(tenant)
        row["budget_used_pct"] = (
            round(100.0 * row["device_s"] / budget, 3)
            if budget else None)
        for key in ("device_s", "compile_s", "avoided_device_s"):
            row[key] = round(row[key], 6)
    return {
        "ts": round(time.time(), 3),
        "tenants": {k: tenants[k] for k in sorted(tenants)},
        "buckets": {k: buckets[k] for k in sorted(buckets)},
        "routes": {k: routes[k] for k in sorted(routes)},
        "replicas": {k: replicas[k] for k in sorted(replicas)},
        "budgets": {k: float(v) for k, v in sorted(budgets.items())},
    }


def gauge_families(snap: dict, budgets: dict[str, float] | None = None,
                   ) -> dict[str, dict[tuple, float]]:
    """The fold rendered for ``RouterMetrics.replace_gauge_family`` —
    families replaced whole each tick, so a departed replica's ratio and
    a resolved tenant's usage drop off instead of freezing.  Every
    BUDGETED tenant always has a ``used_pct`` sample (0.0 before any
    usage): the budget rules are gt thresholds, and an absent series
    would freeze instead of resolving."""
    budgets = dict(budgets or {})
    used: dict[tuple, float] = {
        (("tenant", t),): 0.0 for t in budgets}
    for tenant, row in (snap.get("tenants") or {}).items():
        pct = row.get("budget_used_pct")
        if pct is not None:
            used[(("tenant", tenant),)] = float(pct)
    conservation = {
        (("replica", rid),): float(rec["conservation_ratio"])
        for rid, rec in (snap.get("replicas") or {}).items()
        if rec.get("conservation_ratio") is not None}
    return {
        "fleet_tenant_budget_used_pct": used,
        "fleet_cost_conservation_ratio": conservation,
    }


def budget_rules(budgets: dict[str, float],
                 ) -> list["fleet_alerts.AlertRule"]:
    """Two advisory rules per budgeted tenant over the router-computed
    ``ict_fleet_tenant_budget_used_pct`` gauge: warning at 80%, critical
    at 100% (rules, never admission changes).  Named per tenant (the
    engine requires unique names); an operator ``--alert_rule`` re-using
    a name replaces it, the default-pack override convention."""
    rules = []
    for tenant in sorted(budgets):
        if float(budgets[tenant]) <= 0:
            continue
        rules.append(fleet_alerts.parse_rule({
            "name": f"tenant_budget_burn:{tenant}",
            "source": "budget",
            "severity": "warning",
            "family": "ict_fleet_tenant_budget_used_pct",
            "labels": {"tenant": tenant},
            "predicate": {"op": "gt", "value": 80.0},
            "for_ticks": 1,
            "description": f"tenant {tenant!r} has burned over 80% of its "
                           "advisory device-seconds budget "
                           "(docs/OBSERVABILITY.md \"Cost & efficiency "
                           "accounting\")"}))
        rules.append(fleet_alerts.parse_rule({
            "name": f"tenant_budget_exhausted:{tenant}",
            "source": "budget",
            "severity": "critical",
            "family": "ict_fleet_tenant_budget_used_pct",
            "labels": {"tenant": tenant},
            "predicate": {"op": "ge", "value": 100.0},
            "for_ticks": 1,
            "description": f"tenant {tenant!r} has exhausted its advisory "
                           "device-seconds budget — showback only, "
                           "admission is untouched"}))
    return rules
