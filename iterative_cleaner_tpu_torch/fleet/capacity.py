"""Capacity observability: the fleet's demand / utilization / backlog model.

Port of ``iterative_cleaner_tpu/fleet/capacity.py``.

The observability plane made the fleet *visible* (metrics federation, stitched traces,
incidents, SLO/straggler detection); this module makes it *quantified*.
Every poll tick the router hands :class:`CapacityModel` the registry
snapshot and the scrape cache, and the model folds three already-exported
signal families into actionable figures — extending the
Pipeline-Collector aggregation pattern from measuring a distributed
pipeline to steering it (arXiv:1807.05733):

- **queue state** — each replica's ``/healthz`` aggregate and
  per-shape-bucket queue depths (the backlog's *where*);
- **latency / throughput** — the federated ``/metrics`` scrapes already
  in the router's :class:`~.obs.ScrapeCache`: the
  ``ict_service_dispatch_s`` busy-seconds counter (the dispatch thread is
  one thread, so its windowed busy fraction IS the replica's
  utilization), the ``ict_service_jobs_done`` completion counter (the
  service rate), and the ``ict_phase_duration_seconds`` histogram (the
  p50 the straggler detector also watches);
- **cost** — the memoized ``exec_analysis`` figures obs/memory.py
  exports as ``ict_executable_bytes_accessed{shape_bucket=...}`` gauges
  (XLA's static accounting, persisted on job manifests): a queued cube of
  an expensive bucket weighs more than one of a cheap bucket, so the
  backlog-drain ETA is cost-weighted whenever the figures are known.

The model's outputs are rendered (by the router, through the ONE shared
registry renderer) as strict-grammar ``ict_fleet_capacity_*`` /
``ict_fleet_backlog_eta_seconds`` gauges and served as JSON at
``GET /fleet/capacity`` — and they are the ONLY inputs the autoscaler
(fleet/autoscale.py) reads, so every scale decision is reconstructible
from the exported gauges alone (the explainability contract in
docs/OBSERVABILITY.md "Capacity & autoscaling").

Derivations (all rates are windowed over the last ``window`` poll ticks):

- ``utilization(replica)``   = Δ``ict_service_dispatch_s`` / Δwall,
  clamped to [0, 1]; fleet utilization is the mean over live replicas.
- ``service_rate(replica)``  = Δ``ict_service_jobs_done`` / Δwall
  (jobs/s); the fleet rate is the sum.
- ``demand_rate(bucket)``    = placements the router routed for the
  bucket / Δwall (``note_placement`` feeds this; failover re-routes and
  idempotent dedupes are not new demand).
- ``backlog(bucket)``        = Σ over replicas of the bucket's queued
  cubes right now; the fleet backlog adds the un-bucketed load/dispatch
  queue depths on top.
- ``backlog_eta_s``          = cost-weighted backlog / fleet service
  rate: each bucket's depth is scaled by ``bytes_accessed(bucket) /
  mean(bytes_accessed)`` when the exec-analysis gauge is known (1.0
  otherwise).  Zero backlog → 0; backlog with a zero observed rate →
  ``+Inf`` (the renderer emits the grammar-legal ``+Inf``).
"""

from __future__ import annotations

import collections
import threading
import time

from iterative_cleaner_tpu_torch.fleet import obs as fleet_obs
from iterative_cleaner_tpu_torch.obs import metrics as obs_metrics
from iterative_cleaner_tpu_torch.obs.metrics import MetricFamily

#: Poll ticks per sliding window.  Rates over one tick are noisy (a
#: bucket flush completes several jobs at once); eight ticks at the
#: default 1 s cadence is the same horizon the straggler detector uses.
DEFAULT_WINDOW = 8

#: Label value for demand/backlog that arrived without a shape hint —
#: the submission carried no ``"shape"``, so the router cannot attribute
#: it to a bucket (it still counts toward fleet totals).
UNBUCKETED = "unbucketed"


def counter_value(families: list[MetricFamily], name: str) -> float:
    """One flat (unlabeled) counter's value out of a parsed scrape;
    0.0 when the replica has not registered the family yet."""
    for fam in families:
        for sname, labels, raw in fam.samples:
            if sname == name and not labels:
                try:
                    return obs_metrics.sample_value(raw)
                except ValueError:
                    return 0.0
    return 0.0


def labeled_gauge_values(families: list[MetricFamily], family: str,
                         label_key: str) -> dict[str, float]:
    """``{label value -> sample value}`` for one labeled gauge family out
    of a parsed scrape (e.g. ``ict_executable_bytes_accessed`` by
    ``shape_bucket``)."""
    out: dict[str, float] = {}
    for fam in families:
        if fam.name != family:
            continue
        for _sname, labels, raw in fam.samples:
            d = dict(labels)
            if label_key not in d:
                continue
            try:
                out[d[label_key]] = obs_metrics.sample_value(raw)
            except ValueError:
                continue
    return out


class CapacityModel:
    """Windowed capacity/demand accounting, written by the router's poll
    thread (:meth:`update`, once per tick) and its HTTP handler threads
    (:meth:`note_placement` on every fresh placement); read by both
    (:meth:`snapshot`, :meth:`gauge_families`).  Own lock, acquired
    strictly AFTER the router's (the lock-order discipline) and
    never while calling out."""

    def __init__(self, window: int = DEFAULT_WINDOW,
                 dispatch_phase: str = "service_dispatch") -> None:
        self.window = max(int(window), 1)
        self.dispatch_phase = dispatch_phase
        self._lock = threading.Lock()
        # Fresh placements since the last update(), keyed by bucket label.
        self._arrivals: dict[str, int] = {}  # ict: guarded-by(self._lock)
        # Sliding windows: wall-seconds per tick, arrivals per tick, and
        # per-replica (busy-seconds delta, jobs-done delta) per tick.
        self._wall_win: collections.deque = collections.deque(maxlen=self.window)  # ict: guarded-by(self._lock)
        self._arrival_win: collections.deque = collections.deque(maxlen=self.window)  # ict: guarded-by(self._lock)
        self._busy_win: dict[str, collections.deque] = {}  # ict: guarded-by(self._lock)
        self._done_win: dict[str, collections.deque] = {}  # ict: guarded-by(self._lock)
        # Previous absolute counter readings per replica (deltas only
        # count NEW work; a replica restart resets its counters, and the
        # max(…, 0) clamp absorbs the negative delta).
        self._busy_prev: dict[str, float] = {}  # ict: guarded-by(self._lock)
        self._done_prev: dict[str, float] = {}  # ict: guarded-by(self._lock)
        self._last_mono: float | None = None  # ict: guarded-by(self._lock)
        self._snapshot: dict = {}  # ict: guarded-by(self._lock)
        # Lifetime demand counter (never windowed away): the synthetic-
        # exclusion proof the canary lane leans on — a probe round with
        # zero movement here provably never entered the demand plane.
        self._noted_total = 0  # ict: guarded-by(self._lock)

    # --- inputs ---

    def note_placement(self, bucket: str) -> None:
        """One fresh placement routed (demand).  Failover re-routes,
        idempotency dedupes, and synthetic canary probes must NOT call
        this — the first two are the same demand arriving twice, the
        probes are not demand at all (fleet/canary.py)."""
        key = bucket or UNBUCKETED
        with self._lock:
            self._arrivals[key] = self._arrivals.get(key, 0) + 1
            self._noted_total += 1

    def demand_total(self) -> int:
        """Cumulative count of placements ever noted (not windowed)."""
        with self._lock:
            return self._noted_total

    # --- the per-tick fold ---

    def update(self, replicas: list[dict],
               scrapes: dict[str, dict]) -> dict:
        """One poll tick: fold the registry snapshot (``replicas``, the
        rows ``ReplicaRegistry.snapshot`` serves) and the scrape cache
        snapshot (``scrapes``, ``ScrapeCache.snapshot``) into the
        capacity figures; returns (and stores) the snapshot dict."""
        now = time.monotonic()
        live = [r for r in replicas if r["alive"]]
        with self._lock:
            dt = (now - self._last_mono) if self._last_mono is not None \
                else 0.0
            self._last_mono = now
            self._wall_win.append(max(dt, 0.0))
            self._arrival_win.append(dict(self._arrivals))
            self._arrivals = {}
            wall = sum(self._wall_win)

            per_replica: dict[str, dict] = {}
            for row in live:
                rid = row["replica_id"] or row["base_url"]
                rec = scrapes.get(rid)
                families = (rec or {}).get("families") or []
                busy = counter_value(
                    families, f"ict_{self.dispatch_phase}_s")
                done = counter_value(families, "ict_service_jobs_done")
                d_busy = max(busy - self._busy_prev.get(rid, busy), 0.0)
                d_done = max(done - self._done_prev.get(rid, done), 0.0)
                self._busy_prev[rid] = busy
                self._done_prev[rid] = done
                bwin = self._busy_win.setdefault(
                    rid, collections.deque(maxlen=self.window))
                dwin = self._done_win.setdefault(
                    rid, collections.deque(maxlen=self.window))
                bwin.append(d_busy)
                dwin.append(d_done)
                util = min(sum(bwin) / wall, 1.0) if wall > 0 else 0.0
                rate = sum(dwin) / wall if wall > 0 else 0.0
                cum = fleet_obs.phase_hist_cum(families,
                                               self.dispatch_phase)
                p50 = obs_metrics.quantile_from_cum(cum, 0.5)
                queued = (float(row.get("bucketed_cubes", 0) or 0)
                          + float(row.get("load_queue_depth", 0) or 0)
                          + float(row.get("dispatch_queue_depth", 0) or 0))
                per_replica[rid] = {
                    "utilization": round(util, 6),
                    "service_rate": round(rate, 6),
                    "p50_s": p50,
                    "queued": queued,
                    "draining": bool(row.get("draining", False)),
                    "bucket_queue_depths": dict(
                        row.get("bucket_queue_depths", {})),
                }
                # Sweep replicas that left the fleet (scale-down, death
                # eviction of a renamed replica) out of the windows.
            gone = ({*self._busy_win} - {rid for rid in per_replica}
                    - {r["replica_id"] or r["base_url"] for r in replicas})
            for rid in gone:
                for table in (self._busy_win, self._done_win,
                              self._busy_prev, self._done_prev):
                    table.pop(rid, None)

            # Per-bucket backlog (fleet-wide) + the exec-analysis cost
            # figures off the same scrapes that fed the rates.
            backlog: dict[str, float] = {}
            for rep in per_replica.values():
                for bucket, n in rep["bucket_queue_depths"].items():
                    backlog[str(bucket)] = (backlog.get(str(bucket), 0.0)
                                            + float(n))
            cost: dict[str, float] = {}
            for rid in per_replica:
                rec = scrapes.get(rid)
                families = (rec or {}).get("families") or []
                for bucket, v in labeled_gauge_values(
                        families, "ict_executable_bytes_accessed",
                        "shape_bucket").items():
                    cost[bucket] = max(cost.get(bucket, 0.0), v)

            # Demand rates over the arrival window.
            demand: dict[str, float] = {}
            for tick in self._arrival_win:
                for bucket, n in tick.items():
                    demand[bucket] = demand.get(bucket, 0.0) + n
            demand = {b: (n / wall if wall > 0 else 0.0)
                      for b, n in demand.items()}

            fleet_rate = sum(r["service_rate"]
                             for r in per_replica.values())
            fleet_util = (sum(r["utilization"]
                              for r in per_replica.values())
                          / len(per_replica)) if per_replica else 0.0
            total_backlog = sum(r["queued"] for r in per_replica.values())
            bucket_backlog_sum = sum(backlog.values())

            # Cost-weighted drain ETA: scale each bucket's depth by its
            # relative bytes-accessed when known; cubes of unknown cost
            # (and the un-bucketed queue residue) weigh 1.0.
            known = [cost[b] for b in backlog if b in cost and cost[b] > 0]
            mean_cost = (sum(known) / len(known)) if known else 0.0
            def weight(bucket: str) -> float:
                if mean_cost > 0 and cost.get(bucket, 0.0) > 0:
                    return cost[bucket] / mean_cost
                return 1.0
            weighted = sum(n * weight(b) for b, n in backlog.items())
            weighted += max(total_backlog - bucket_backlog_sum, 0.0)

            def eta(load: float) -> float:
                if load <= 0:
                    return 0.0
                if fleet_rate <= 0:
                    return float("inf")
                return load / fleet_rate

            buckets = {
                b: {
                    "backlog": backlog.get(b, 0.0),
                    "demand_rate": round(demand.get(b, 0.0), 6),
                    "cost_bytes": cost.get(b),
                    "eta_s": eta(backlog.get(b, 0.0) * weight(b)),
                }
                for b in sorted({*backlog, *demand, *cost})
            }
            snap = {
                "ts": round(time.time(), 3),
                "window_s": round(wall, 3),
                "replicas": per_replica,
                "buckets": buckets,
                "fleet": {
                    "replicas_live": len(per_replica),
                    "utilization": round(fleet_util, 6),
                    "service_rate": round(fleet_rate, 6),
                    "demand_rate": round(sum(demand.values()), 6),
                    "backlog": total_backlog,
                    "backlog_weighted": round(weighted, 6),
                    "backlog_eta_s": eta(weighted),
                },
            }
            self._snapshot = snap
            return snap

    # --- outputs ---

    def snapshot(self) -> dict:
        """The last computed figures (empty before the first update)."""
        with self._lock:
            return dict(self._snapshot)

    def gauge_families(self) -> dict[str, dict[tuple, float]]:
        """The last snapshot rendered as ``{family -> {label pairs ->
        value}}`` for ``RouterMetrics.replace_gauge_family`` — the
        strict-grammar ``ict_fleet_capacity_*`` /
        ``ict_fleet_backlog_eta_seconds`` exposition the explainability
        contract promises.  Families are replaced whole each tick, so a
        drained bucket (or a scaled-down replica) drops off instead of
        freezing at its last value."""
        snap = self.snapshot()
        if not snap:
            return {}
        fleet = snap["fleet"]
        out: dict[str, dict[tuple, float]] = {
            "fleet_capacity_utilization": {(): fleet["utilization"]},
            "fleet_capacity_service_rate": {(): fleet["service_rate"]},
            "fleet_capacity_demand_rate": {(): fleet["demand_rate"]},
            "fleet_capacity_backlog": {(): fleet["backlog"]},
            "fleet_capacity_backlog_weighted": {
                (): fleet["backlog_weighted"]},
            "fleet_backlog_eta_seconds": {(): fleet["backlog_eta_s"]},
            "fleet_capacity_replica_utilization": {
                (("replica", rid),): rep["utilization"]
                for rid, rep in snap["replicas"].items()},
            "fleet_capacity_replica_service_rate": {
                (("replica", rid),): rep["service_rate"]
                for rid, rep in snap["replicas"].items()},
            "fleet_capacity_bucket_backlog": {
                (("bucket", b),): rec["backlog"]
                for b, rec in snap["buckets"].items()},
            "fleet_capacity_bucket_demand_rate": {
                (("bucket", b),): rec["demand_rate"]
                for b, rec in snap["buckets"].items()},
            "fleet_bucket_backlog_eta_seconds": {
                (("bucket", b),): rec["eta_s"]
                for b, rec in snap["buckets"].items()},
            "fleet_capacity_bucket_cost_bytes": {
                (("bucket", b),): rec["cost_bytes"]
                for b, rec in snap["buckets"].items()
                if rec["cost_bytes"] is not None},
        }
        return out
