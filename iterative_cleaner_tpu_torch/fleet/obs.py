"""Fleet-wide observability plane: the router-side aggregation layer.

Port of ``iterative_cleaner_tpu/fleet/obs.py``.

The replica's three-rung observability tower is strictly
per-replica; the router made the fleet one *system* without making it
one *view*.  This module is the missing aggregation layer (the
Pipeline-Collector shape of cross-node performance accounting,
arXiv:1807.05733), four pillars, all read-only on the math:

- **Metrics federation** (:class:`ScrapeCache`,
  :func:`federated_exposition`): the router's poll loop scrapes each
  replica's ``/metrics`` (parsed strictly by
  ``obs.metrics.parse_exposition``); ``GET /fleet/metrics`` serves every
  per-replica series re-labeled ``{replica=...}`` plus *merged* families
  under an ``ict_fleet_``-prefixed rename — counters summed, the fixed
  log2-bucket latency histograms merged bucket-wise (identical bounds by
  construction, so the merge is exact), gauges max/sum by the
  :func:`gauge_merge_policy` table — built from ONE cache snapshot so the
  merged totals always equal the per-replica sums they sit next to.
  Scrape-staleness gauges (``ict_fleet_scrape_ok`` /
  ``ict_fleet_scrape_age_seconds``) make a wedged replica visible instead
  of silently stale: a dead replica's last good scrape keeps serving, its
  age keeps growing.
- **Cross-hop trace assembly** (:class:`TraceStore`): a bounded span
  store indexes the router's own placement/failover/terminal events under
  the adopted ``X-ICT-Trace`` id; ``GET /fleet/trace/<trace_id>``
  stitches one timeline — submit → placement → the serving replica's
  persisted per-job forensics (``GET /jobs/<id>/trace``, fetched lazily)
  → (failover → second replica) → done.  A dead hop's spans come from the
  best-effort pre-death **flight-ring cache** the poll loop keeps, so a
  failed-over job's partial telemetry survives the replica that produced
  it.
- **Incident bundles** (:func:`write_incident_bundle`): on death
  eviction, failover, or an observed audit-divergence/demotion the router
  snapshots its placement table, the registry, the replica's last good
  ``/metrics`` scrape, its cached flight ring, and (for job-scoped
  incidents) the stitched trace into ``<spool>/fleet-incidents/`` — same
  ``.part``-rename + bounded-retention discipline as
  ``obs.audit.write_repro_bundle``.
- **SLO & straggler detection** (:class:`StragglerDetector`): windowed
  per-replica p50 estimates off the scraped latency histograms; a replica
  whose p50 sits ``straggler_factor`` above the fleet median for
  ``straggler_polls`` consecutive polls is flagged
  (``ict_fleet_stragglers`` gauge, a flight/event record, and a placement
  de-prioritization penalty in the router's ranked-candidate scoring)
  and cleared once it recovers.  Per-tenant SLO burn counters
  (``ict_fleet_slo_burn_total{tenant}``) ride the WFQ admission path.
"""

from __future__ import annotations

import collections
import json
import os
import shutil
import threading
import time
import uuid

from iterative_cleaner_tpu_torch.obs import metrics as obs_metrics
from iterative_cleaner_tpu_torch.obs.metrics import MetricFamily

#: Incident bundles kept per directory (oldest swept) — the
#: flight.MAX_DUMPS_KEPT rationale: a flapping replica must not fill the
#: router spool with one bundle per death/failover.
MAX_INCIDENTS_KEPT = 20

#: Bounds on the router-side span store: traces evicted LRU beyond
#: ``MAX_TRACES``; spans per trace capped (a pathological retry loop must
#: not grow one trace without bound).
MAX_TRACES = 1024
MAX_SPANS_PER_TRACE = 128

#: Substrings that flag a gauge family as a high-water/point-in-time fact
#: where summing across replicas would lie — merged with max instead.
#: Everything else (RSS, HBM in use, queue depths) merges additively.
GAUGE_MAX_HINTS = ("max", "peak", "last", "limit")


def merged_name(name: str) -> str:
    """The merged-family rename: ``ict_service_jobs_done`` ->
    ``ict_fleet_service_jobs_done``.  Renamed, not re-labeled: the same
    family cannot carry both ``{replica=...}`` per-replica series and an
    unlabeled fleet total without colliding in the exposition."""
    if name.startswith("ict_"):
        return "ict_fleet_" + name[len("ict_"):]
    return "fleet_" + name


def gauge_merge_policy(family_name: str) -> str:
    """``"max"`` or ``"sum"`` for one gauge family (the merge-policy
    table in docs/OBSERVABILITY.md "Fleet observability")."""
    lowered = family_name.lower()
    if any(hint in lowered for hint in GAUGE_MAX_HINTS):
        return "max"
    return "sum"


def merge_families(scrapes: dict[str, list[MetricFamily]],
                   ) -> list[MetricFamily]:
    """Merge per-replica family lists into fleet totals.

    Counters and histograms sum sample-wise (histogram buckets share the
    fixed log2 bounds by construction, so the bucket-wise sum is the
    exact fleet histogram); gauges follow :func:`gauge_merge_policy`.
    Sample identity is (suffixed sample name, label pairs); families and
    samples keep first-seen order over the sorted replica ids so the
    exposition is deterministic."""
    merged: dict[str, MetricFamily] = {}
    order: list[str] = []
    # (family, sample_name, labels) -> accumulated float
    acc: dict[tuple, float] = {}
    sample_order: dict[str, list[tuple]] = {}
    for rid in sorted(scrapes):
        for fam in scrapes[rid]:
            out_name = merged_name(fam.name)
            out = merged.get(out_name)
            if out is None:
                out = MetricFamily(name=out_name, kind=fam.kind,
                                   help=fam.help)
                merged[out_name] = out
                order.append(out_name)
                sample_order[out_name] = []
            policy = ("max" if fam.kind == "gauge"
                      and gauge_merge_policy(fam.name) == "max" else "sum")
            for name, labels, raw in fam.samples:
                out_sample = merged_name(name) if name.startswith(
                    fam.name) else name
                key = (out_name, out_sample, labels)
                value = obs_metrics.sample_value(raw)
                if key not in acc:
                    acc[key] = value
                    sample_order[out_name].append((out_sample, labels))
                elif policy == "max":
                    acc[key] = max(acc[key], value)
                else:
                    acc[key] += value
    for out_name in order:
        fam = merged[out_name]
        fam.samples = [
            (sample_name, labels,
             obs_metrics._fmt(acc[(out_name, sample_name, labels)]))
            for sample_name, labels in sample_order[out_name]]
    return [merged[name] for name in order]


def relabeled_families(scrapes: dict[str, list[MetricFamily]],
                       ) -> list[MetricFamily]:
    """Per-replica series under their original family names with a
    ``replica`` label appended — the raw federated view next to the
    merged one."""
    out: dict[str, MetricFamily] = {}
    order: list[str] = []
    for rid in sorted(scrapes):
        for fam in scrapes[rid]:
            dst = out.get(fam.name)
            if dst is None:
                dst = MetricFamily(name=fam.name, kind=fam.kind,
                                   help=fam.help)
                out[fam.name] = dst
                order.append(fam.name)
            for name, labels, raw in fam.samples:
                dst.samples.append(
                    (name, labels + (("replica", rid),), raw))
    return [out[name] for name in order]


def federated_exposition(scrapes: dict[str, list[MetricFamily]]) -> str:
    """The replica half of ``GET /fleet/metrics``: every per-replica
    series re-labeled, then every merged family.  Built from one scrapes
    snapshot, so the merged totals equal the per-replica sums by
    construction."""
    if not scrapes:
        return ""
    return (obs_metrics.render_exposition(relabeled_families(scrapes))
            + obs_metrics.render_exposition(merge_families(scrapes)))


def phase_hist_cum(families: list[MetricFamily], phase: str,
                   ) -> dict[float, float]:
    """Cumulative latency-bucket counts (``le`` bound -> count) for one
    phase out of a parsed scrape's ``ict_phase_duration_seconds`` family;
    empty when the replica has not observed the phase yet.  Thin wrapper
    over the shared :func:`obs.metrics.bucket_cum` (foreign ``le`` bounds
    are skipped, never raised out of the poll thread)."""
    return obs_metrics.bucket_cum(families, "ict_phase_duration_seconds",
                                  {"phase": phase})


def histogram_quantile(cum: dict[float, float], q: float) -> float | None:
    """Back-compat alias for the ONE shared upper-bound-bucket estimator,
    :func:`obs.metrics.quantile_from_cum` — the straggler detector, the
    capacity model, and the alert engine's quantile predicates must never
    disagree about the same scrape."""
    return obs_metrics.quantile_from_cum(cum, q)


class ScrapeCache:
    """Per-replica last-good ``/metrics`` scrape + flight-ring cache,
    written by the router's poll thread and read by its HTTP handler
    threads.  A failed scrape never evicts the last good one — staleness
    is *reported* (the age gauges), not silently absorbed."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._scrapes: dict[str, dict] = {}  # ict: guarded-by(self._lock)

    def update(self, replica_id: str, text: str,
               families: list[MetricFamily],
               flight_events: list[dict] | None) -> None:
        rec = {
            "text": text,
            "families": families,
            "flight": list(flight_events or ()),
            "ts_mono": time.monotonic(),
            "ts": round(time.time(), 3),
            "ok": True,
        }
        with self._lock:
            # Keep the previous flight cache when this scrape could not
            # fetch the ring — a partially-degraded replica's last good
            # pre-death ring is exactly what the post-mortem needs.
            if flight_events is None and replica_id in self._scrapes:
                rec["flight"] = self._scrapes[replica_id]["flight"]
            self._scrapes[replica_id] = rec

    def note_failure(self, replica_id: str) -> None:
        with self._lock:
            rec = self._scrapes.get(replica_id)
            if rec is not None:
                rec["ok"] = False

    def snapshot(self) -> dict[str, dict]:
        """Shallow copies: family lists are replaced whole on update,
        never mutated in place, so readers can render from them lock-free."""
        with self._lock:
            return {rid: dict(rec) for rid, rec in self._scrapes.items()}

    def ages(self) -> dict[str, float]:
        """Seconds since each replica's last GOOD scrape."""
        now = time.monotonic()
        with self._lock:
            return {rid: round(now - rec["ts_mono"], 3)
                    for rid, rec in self._scrapes.items()}

    def flight_events(self, replica_id: str) -> list[dict]:
        with self._lock:
            rec = self._scrapes.get(replica_id)
            return list(rec["flight"]) if rec is not None else []

    def forget(self, replica_id: str) -> None:
        """Drop one replica's cached scrape — the autoscaler's scale-down
        path (a replica that LEFT the fleet must fall off the staleness
        gauges instead of aging forever; a dead-but-configured replica
        keeps its last good scrape, as before)."""
        with self._lock:
            self._scrapes.pop(replica_id, None)


class TraceStore:
    """Bounded router-side span store, indexed by trace id.  LRU over
    traces (``MAX_TRACES``), capped per trace (``MAX_SPANS_PER_TRACE``);
    a span is one small dict, so the store's memory is bounded by
    construction."""

    def __init__(self, max_traces: int = MAX_TRACES,
                 max_spans: int = MAX_SPANS_PER_TRACE) -> None:
        self.max_traces = int(max_traces)
        self.max_spans = int(max_spans)
        self._lock = threading.Lock()
        # trace_id -> {"spans": [...], "job_id": str}
        self._traces: collections.OrderedDict = collections.OrderedDict()  # ict: guarded-by(self._lock)

    def record(self, trace_id: str, event: str, job_id: str = "",
               **fields) -> None:
        if not trace_id:
            return
        span = {"ts": round(time.time(), 6), "source": "router",
                "event": event}
        span.update(fields)
        with self._lock:
            rec = self._traces.get(trace_id)
            if rec is None:
                rec = {"spans": [], "job_id": ""}
                self._traces[trace_id] = rec
            self._traces.move_to_end(trace_id)
            if len(rec["spans"]) < self.max_spans:
                rec["spans"].append(span)
            if job_id:
                rec["job_id"] = job_id
            while len(self._traces) > self.max_traces:
                self._traces.popitem(last=False)

    def spans(self, trace_id: str) -> list[dict]:
        with self._lock:
            rec = self._traces.get(trace_id)
            return [dict(s) for s in rec["spans"]] if rec else []

    def job_for(self, trace_id: str) -> str:
        with self._lock:
            rec = self._traces.get(trace_id)
            return rec["job_id"] if rec else ""


def span_hops(spans: list[dict]) -> dict:
    """Per-hop latency off one assembled trace: consecutive span deltas
    in timestamp order, each hop labeled ``source:event`` ->
    ``source:event``.  The canary prober stamps this on every journey
    verdict, re-using the trace assembly instead of growing a
    second timing path; unstamped spans are skipped, < 2 stamped spans
    yield no hops."""
    stamped = []
    for s in spans:
        try:
            ts = float(s.get("ts", 0.0))
        except (TypeError, ValueError):
            continue
        if ts <= 0.0:
            continue
        source = str(s.get("source", "") or "")
        event = str(s.get("event", "") or "")
        label = f"{source}:{event}" if source else event
        stamped.append((ts, label))
    stamped.sort(key=lambda pair: pair[0])
    hops = []
    for (t0, l0), (t1, l1) in zip(stamped, stamped[1:]):
        hops.append({"from": l0, "to": l1, "dt_s": round(t1 - t0, 6)})
    total = (round(stamped[-1][0] - stamped[0][0], 6)
             if len(stamped) >= 2 else 0.0)
    return {"hops": hops, "total_s": total}


class StragglerDetector:
    """Windowed per-replica latency p50 vs the fleet median.

    Each poll hands :meth:`update` every scraped replica's *cumulative*
    bucket counts for the watched phase; the detector differences them
    against the previous poll (new observations only), keeps a sliding
    window of the last ``window`` polls' deltas, and estimates each
    replica's p50 over the window.  A replica whose p50 exceeds
    ``factor`` times the fleet median of those p50s for ``polls``
    consecutive updates is flagged; one in-bounds update clears it.
    Replicas with fewer than ``min_count`` windowed observations (idle,
    freshly started, or dead) get no verdict and are never flagged.  A
    replica MISSING from an update (failed scrape, death) keeps its flag
    and its countdown frozen — a degrading replica whose scrape just
    timed out must not silently shed its placement penalty; only an
    explicit in-bounds verdict clears."""

    def __init__(self, factor: float = 3.0, polls: int = 3,
                 window: int = 8, min_count: int = 3) -> None:
        self.factor = float(factor)
        self.polls = int(polls)
        self.window = int(window)
        self.min_count = int(min_count)
        self._lock = threading.Lock()
        self._last_cum: dict[str, dict[float, float]] = {}  # ict: guarded-by(self._lock)
        self._windows: dict[str, collections.deque] = {}  # ict: guarded-by(self._lock)
        self._consec: dict[str, int] = {}  # ict: guarded-by(self._lock)
        self._flagged: set[str] = set()  # ict: guarded-by(self._lock)

    def update(self, cum_by_replica: dict[str, dict[float, float]]) -> dict:
        """One poll's verdict: ``{"p50": {...}, "median": float|None,
        "stragglers": set, "fired": [...], "cleared": [...]}``."""
        with self._lock:
            p50: dict[str, float] = {}
            for rid, cum in cum_by_replica.items():
                prev = self._last_cum.get(rid, {})
                delta = {le: max(n - prev.get(le, 0.0), 0.0)
                         for le, n in cum.items()}
                self._last_cum[rid] = dict(cum)
                win = self._windows.get(rid)
                if win is None:
                    win = self._windows[rid] = collections.deque(
                        maxlen=self.window)
                win.append(delta)
                summed: dict[float, float] = {}
                for d in win:
                    for le, n in d.items():
                        summed[le] = summed.get(le, 0.0) + n
                total = max(summed.values()) if summed else 0.0
                if total >= self.min_count:
                    q = obs_metrics.quantile_from_cum(summed, 0.5)
                    if q is not None:
                        p50[rid] = q
            median = None
            if len(p50) >= 2:
                ordered = sorted(p50.values())
                mid = len(ordered) // 2
                median = (ordered[mid] if len(ordered) % 2
                          else 0.5 * (ordered[mid - 1] + ordered[mid]))
            fired, cleared = [], []
            for rid in cum_by_replica:
                slow = (median is not None and median > 0
                        and rid in p50
                        and p50[rid] > self.factor * median)
                if slow:
                    self._consec[rid] = self._consec.get(rid, 0) + 1
                    if (self._consec[rid] >= self.polls
                            and rid not in self._flagged):
                        self._flagged.add(rid)
                        fired.append(rid)
                else:
                    self._consec[rid] = 0
                    if rid in self._flagged:
                        self._flagged.discard(rid)
                        cleared.append(rid)
            return {"p50": p50, "median": median,
                    "stragglers": set(self._flagged),
                    "fired": fired, "cleared": cleared}

    def stragglers(self) -> set[str]:
        with self._lock:
            return set(self._flagged)

    def forget(self, replica_id: str) -> None:
        """Drop one replica's windows/flag — scale-down removal (its id
        may be reused by a future spawn and must start clean)."""
        with self._lock:
            self._last_cum.pop(replica_id, None)
            self._windows.pop(replica_id, None)
            self._consec.pop(replica_id, None)
            self._flagged.discard(replica_id)


# --- incident bundles ---


def write_incident_bundle(directory: str, *, reason: str,
                          replica_id: str = "", job_id: str = "",
                          trace_id: str = "",
                          placements: list[dict] | None = None,
                          replicas: list[dict] | None = None,
                          metrics_text: str = "",
                          flight_events: list[dict] | None = None,
                          trace: dict | None = None) -> str | None:
    """One self-contained fleet incident under ``directory``.

    Layout: ``incident-<unixms>-<hex6>/`` holding ``manifest.json``
    (reason, placement-table and registry snapshots, trace context),
    ``metrics.prom`` (the replica's last good scrape), ``flight.json``
    (its cached flight ring), and ``trace.json`` (the stitched trace,
    for job-scoped incidents).  Built under a ``.part`` name and renamed;
    oldest bundles beyond :data:`MAX_INCIDENTS_KEPT` swept; returns the
    path or None — forensics must never become a second failure (the
    ``write_repro_bundle`` contract)."""
    try:
        os.makedirs(directory, exist_ok=True)
        name = (f"incident-{int(time.time() * 1000):013d}-"
                f"{uuid.uuid4().hex[:6]}")
        final = os.path.join(directory, name)
        tmp = f"{final}.part"
        os.makedirs(tmp)
        manifest = {
            "reason": reason,
            "ts": round(time.time(), 6),
            "pid": os.getpid(),
            "replica_id": replica_id,
            "job_id": job_id,
            "trace_id": trace_id,
            "placements": placements or [],
            "replicas": replicas or [],
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as fh:
            json.dump(manifest, fh, indent=1, default=str)
            fh.write("\n")
        if metrics_text:
            with open(os.path.join(tmp, "metrics.prom"), "w") as fh:
                fh.write(metrics_text)
        with open(os.path.join(tmp, "flight.json"), "w") as fh:
            json.dump({"events": flight_events or []}, fh, indent=1,
                      default=str)
            fh.write("\n")
        if trace is not None:
            with open(os.path.join(tmp, "trace.json"), "w") as fh:
                json.dump(trace, fh, indent=1, default=str)
                fh.write("\n")
        os.replace(tmp, final)
        bundles = sorted(n for n in os.listdir(directory)
                         if n.startswith("incident-")
                         and not n.endswith(".part"))
        for old in bundles[:-MAX_INCIDENTS_KEPT]:
            try:
                shutil.rmtree(os.path.join(directory, old))
            except OSError:
                pass
        return final
    except Exception:  # noqa: BLE001 — best-effort by contract
        return None


def list_incidents(directory: str) -> list[dict]:
    """Bundle inventory for ``GET /fleet/incidents`` (name / reason / ts
    / replica / job / trace)."""
    out: list[dict] = []
    try:
        names = sorted(n for n in os.listdir(directory)
                       if n.startswith("incident-")
                       and not n.endswith(".part"))
    except OSError:
        return out
    for name in names:
        entry = {"name": name, "path": os.path.join(directory, name)}
        try:
            with open(os.path.join(directory, name, "manifest.json")) as fh:
                m = json.load(fh)
            entry.update(reason=m.get("reason"), ts=m.get("ts"),
                         replica_id=m.get("replica_id"),
                         job_id=m.get("job_id"),
                         trace_id=m.get("trace_id"))
        except (OSError, ValueError):
            entry["reason"] = "unreadable manifest"
        out.append(entry)
    return out
