"""Cost & efficiency accounting: per-job device-time attribution and the
per-replica showback ledger.

A copy of ``iterative_cleaner_tpu/obs/costs.py`` (``CostRecord`` fields,
``add_dispatch_share``, ``add_exec_share``, ``add_cache_hit``,
``finalize``, ``CostLedger`` and its ``costs.json``).  One substitute: the
JAX package feeds :func:`add_exec_share` from XLA's cost and memory
analysis of the bucket executable, which torch does not have.  The port's
figures come from :func:`..obs.memory.analyze_batch_route` — the bytes and
float32 operations of one iteration of its two hand kernels
(``fused_fit_moments`` and ``ordered_template``) at the bucket's shape, and
the peak from ``parallel/autoshard.batch_working_set_bytes``.  Compile
seconds are the ``nvcc`` kernel builds a dispatch paid
(``obs.tracing.observe_kernel_build``).

The obs tower measures *health* (latency histograms, queue depths, HBM
peaks) but until this module nothing answered "who consumed what, and how
efficiently": tenants had quotas with zero usage metering, the result
caches counted ``bytes_saved`` attributed to no one, and the memoized
``exec_analysis`` static costs were never compared against achieved
throughput.  Three pieces, all read-only on the math:

- **CostRecord** — one dict per job (``Job.cost``, persisted on the spool
  manifest): device-seconds split by phase, compile-seconds, the static
  bytes/FLOPs model, the coalesced batch size it shared, cache-hit
  avoided cost, and a roofline attainment ratio.  The dispatch worker
  accumulates it (:func:`add_dispatch_share` / :func:`add_exec_share`)
  and finalizes it at the terminal transition (:func:`finalize`).
- **Attribution rules** — a coalesced batch's measured dispatch seconds
  (and its executable's static bytes/FLOPs) are apportioned EQUALLY
  across its K member jobs; a failed dispatch attempt's seconds are
  apportioned the same way (the jobs it retried for consumed the device).
  The load-bearing invariant, asserted by tests and the serve-fleet
  smoke: per replica, the summed attributed device-seconds equal
  Δ``ict_service_dispatch_s`` within 1% — the attributed shares are
  splits of the exact value :func:`obs.tracing.observe_phase` records,
  so conservation holds by construction, not by luck.
- **CostLedger** — the per-replica aggregate (by tenant, shape bucket,
  and route), RLock'd, spool-persisted (``<spool>/costs.json``,
  atomic-rename), restart-resumed.  Every :meth:`~CostLedger.record`
  also bumps the process-global ``ict_cost_*`` counters the fleet
  router's existing poll-tick scrape federates (fleet/costs.py) — zero
  new traffic.  Counters are per-process-life (pre-registered at 0 on
  daemon start, so a restarted replica reports an explicit 0); the ledger file is
  the durable lifetime record served at ``GET /costs``.

**Attainment** is the roofline-style efficiency figure: achieved bytes/s
(the executable's static ``bytes_accessed`` model over the measured
dispatch seconds) against a reference bandwidth — ``ICT_ROOFLINE_GBPS``
when the operator pins one, else the ingest pipeline's measured
effective GB/s (the bandwidth the host actually demonstrated).  On the
card the bytes are those of every iteration the dispatch ran and the
reference is ``ICT_ROOFLINE_GBPS`` alone (:func:`add_exec_share`).  A ratio
near 1 means the dispatch ran as fast as bytes could move; << 1 means
launch overhead or starvation (docs/OBSERVABILITY.md "Cost & efficiency
accounting").
"""

from __future__ import annotations

import json
import os
import threading

from iterative_cleaner_tpu_torch.obs import tracing

#: Tenant label for jobs submitted without one (the fleet router's
#: X-ICT-Tenant convention, fleet/tenants.DEFAULT_TENANT — duplicated
#: here so obs/ never imports fleet/).
DEFAULT_TENANT = "default"

#: Shape-bucket label for records without a decoded shape (the
#: fleet/capacity.UNBUCKETED convention).
UNBUCKETED = "unbucketed"

#: The counter families the ledger renders (all low-cardinality labeled:
#: tenant names are operator-declared, buckets are shape classes, routes
#: a fixed set).  Pre-registered at 0 by :meth:`CostLedger.register_counters`
#: so gt-0 budget alerts can resolve across a clean replica restart
#: (a lazily-registered series would vanish across a restart).
TENANT_COUNTER_FAMILIES = (
    "cost_device_seconds_total",
    "cost_jobs_total",
    "cost_compile_seconds_total",
    "cost_bytes_accessed_total",
    "cost_cache_hits_total",
    "cost_cache_avoided_device_seconds_total",
    "cost_cache_avoided_bytes_total",
)

_ROOFLINE_ENV = "ICT_ROOFLINE_GBPS"


def _pinned_gbps() -> float | None:
    """``ICT_ROOFLINE_GBPS`` when set to a rate > 0, else None."""
    try:
        val = float(os.environ.get(_ROOFLINE_ENV) or 0)
    except ValueError:
        return None
    return val if val > 0 else None


def reference_gbps() -> float | None:
    """The attainment reference bandwidth: ``ICT_ROOFLINE_GBPS`` when
    set (> 0), else the ingest pipeline's measured effective GB/s when
    it has moved bytes this process, else None (attainment unknowable —
    recorded as null, never guessed)."""
    pinned = _pinned_gbps()
    if pinned is not None:
        return pinned
    try:
        from iterative_cleaner_tpu_torch.ingest import pipeline

        gbps = float(pipeline.stats_snapshot().get("effective_gbps", 0.0))
        return gbps if gbps > 0 else None
    except Exception:  # noqa: BLE001 — accounting is best-effort
        return None


def attainment_ratio(bytes_accessed, seconds, ref_gbps=None) -> float | None:
    """Achieved bytes/s over the reference bandwidth; None when either
    side is unknown or degenerate."""
    if ref_gbps is None:
        ref_gbps = reference_gbps()
    if not bytes_accessed or not ref_gbps or not seconds or seconds <= 0:
        return None
    return (float(bytes_accessed) / float(seconds)) / (float(ref_gbps) * 1e9)


def ensure(job) -> dict:
    """The job's CostRecord, initialized on first touch.  All WRITES
    happen on the dispatch-worker thread (one thread owns the device),
    but HTTP handler threads serialize the live Job concurrently
    (``dataclasses.asdict`` iterates these dicts), so every updater
    below follows the atomic-REBIND convention the other manifest
    containers use (exec_analysis, quality): copy via :func:`_mutable`,
    mutate the copy, assign ``job.cost`` once — a reader sees the old
    or the new record, never a dict changing size under iteration."""
    if not job.cost:
        job.cost = {
            "tenant": job.tenant or DEFAULT_TENANT,
            "bucket": UNBUCKETED,
            "route": "",
            "device_s": 0.0,
            "compile_s": 0.0,
            "bytes_accessed": 0.0,
            "flops": 0.0,
            "batch_k": 0,
            "attainment": None,
            "cache_hit": False,
            "avoided_device_s": 0.0,
            "avoided_bytes_accessed": 0.0,
            "phases": {},
        }
    return job.cost


def _mutable(job) -> dict:
    """A fresh copy of the job's record (phases dict included) for the
    copy-mutate-rebind update pattern ensure() documents."""
    cost = dict(ensure(job))
    cost["phases"] = dict(cost.get("phases", {}))
    return cost


def _add_phase(cost: dict, phase: str, seconds: float) -> None:
    phases = cost.setdefault("phases", {})
    phases[phase] = round(phases.get(phase, 0.0) + float(seconds), 6)


def add_phase(job, phase: str, seconds: float) -> None:
    """Accumulate one phase's wall seconds onto the job's record (the
    non-device phases: emit, oracle, cache_emit — the split of
    device-seconds by phase rides in ``phases``)."""
    cost = _mutable(job)
    _add_phase(cost, phase, seconds)
    job.cost = cost


def add_dispatch_share(jobs, dispatch_s: float, compile_s: float = 0.0,
                       ) -> None:
    """Apportion one bucket dispatch's measured seconds (and the compile
    seconds the compile-accounting listener attributed to the window)
    equally across its K member jobs.  Called for FAILED attempts too —
    ``observe_phase('service_dispatch', ..., error=True)`` still counts
    the seconds, so conservation requires the attribution to as well."""
    if not jobs:
        return
    share = float(dispatch_s) / len(jobs)
    compile_share = float(compile_s) / len(jobs)
    for job in jobs:
        cost = _mutable(job)
        cost["device_s"] += share
        cost["compile_s"] += compile_share
        cost["batch_k"] = max(int(cost.get("batch_k", 0)), len(jobs))
        _add_phase(cost, "dispatch", share)
        job.cost = cost


def add_exec_share(jobs, analysis: dict, dispatch_s: float, iterations: int = 1,
                   on_card: bool = False) -> float | None:
    """Apportion the batch executable's static cost model
    (obs/memory.analyze_batch_route: bytes accessed, FLOPs — figures for
    the WHOLE batch, one iteration of both kernels) across the K member jobs, and compute the
    batch's attainment ratio (exported as the
    ``ict_cost_attainment_ratio{shape_bucket}`` gauge and stamped on
    every member's record).  Returns the attainment, or None.

    A replica on the card (``on_card``) counts the kernels' bytes of all
    the dispatch's ``iterations`` and holds them only against
    ``ICT_ROOFLINE_GBPS``, the card's byte rate as the operator states
    it: the ingest pipeline's staged GB/s is a host rate, so without the
    variable its attainment is null.  Elsewhere the JAX rule holds (one
    iteration's bytes against :func:`reference_gbps`)."""
    if not jobs or not analysis:
        return None
    k = len(jobs)
    bytes_total = float(analysis.get("bytes_accessed", 0.0) or 0.0)
    flops_total = float(analysis.get("flops", 0.0) or 0.0)
    if on_card:
        pinned = _pinned_gbps()
        attain = (attainment_ratio(bytes_total * max(int(iterations), 1), dispatch_s,
                                   pinned) if pinned is not None else None)
    else:
        attain = attainment_ratio(bytes_total, dispatch_s)
    bucket = UNBUCKETED
    for job in jobs:
        cost = _mutable(job)
        cost["bytes_accessed"] += bytes_total / k
        cost["flops"] += flops_total / k
        if attain is not None:
            cost["attainment"] = round(attain, 6)
        job.cost = cost
        if job.shape:
            bucket = tracing.shape_bucket_label(job.shape)
    if attain is not None:
        tracing.set_gauge_labeled("cost_attainment_ratio",
                                  {"shape_bucket": bucket}, float(attain))
    return attain


def add_cache_hit(job, origin_cost: dict | None) -> dict:
    """Mark a content-cache hit: zero device cost, the ORIGIN job's
    recorded figures as avoided cost (the showback rule — the
    saving belongs to whoever would have paid the clean)."""
    cost = _mutable(job)
    cost["cache_hit"] = True
    origin_cost = origin_cost or {}
    cost["avoided_device_s"] = round(
        float(origin_cost.get("device_s", 0.0) or 0.0), 6)
    cost["avoided_bytes_accessed"] = float(
        origin_cost.get("bytes_accessed", 0.0) or 0.0)
    job.cost = cost
    return cost


def finalize(job) -> dict:
    """Stamp the identity fields (tenant / shape bucket / route) and
    round the float accumulators — called exactly once per job, right
    before the record lands in the ledger and on the manifest."""
    cost = _mutable(job)
    cost["tenant"] = job.tenant or DEFAULT_TENANT
    if job.shape:
        cost["bucket"] = tracing.shape_bucket_label(job.shape)
    cost["route"] = job.served_by or (
        "error" if job.state == "error" else "")
    if job.state == "error" and cost.get("cache_hit"):
        # A cache hit whose emission failed delivered nothing: counting
        # its avoided cost would over-report the tenant's savings.
        cost["cache_hit"] = False
        cost["avoided_device_s"] = 0.0
        cost["avoided_bytes_accessed"] = 0.0
    for key in ("device_s", "compile_s"):
        cost[key] = round(float(cost.get(key, 0.0)), 6)
    job.cost = cost
    return cost


def _zero_row() -> dict:
    return {"device_s": 0.0, "jobs": 0, "compile_s": 0.0,
            "bytes_accessed": 0.0, "flops": 0.0, "cache_hits": 0,
            "avoided_device_s": 0.0, "avoided_bytes": 0.0}


class CostLedger:
    """Per-replica cost aggregate (tenant / bucket / route), written by
    the dispatch-worker thread (:meth:`record`) and read by the HTTP
    handler threads (:meth:`report`); spool-persisted and
    restart-resumed, so the showback record survives replica restarts
    while the ``ict_cost_*`` counters stay per-process-life (the
    conservation invariant is a counter delta).  RLock, deliberately:
    the flush snapshot takes it lexically (the ICT007 discipline) while
    :meth:`record` already holds it."""

    def __init__(self, path: str = "", replica_id: str = "") -> None:
        self.path = path
        self.replica_id = replica_id
        self._lock = threading.RLock()
        self._tenants: dict[str, dict] = {}  # ict: guarded-by(self._lock)
        self._buckets: dict[str, dict] = {}  # ict: guarded-by(self._lock)
        self._routes: dict[str, dict] = {}  # ict: guarded-by(self._lock)
        self._totals: dict = _zero_row()  # ict: guarded-by(self._lock)
        self._dirty = False  # ict: guarded-by(self._lock)
        self._resumed = False  # ict: guarded-by(self._lock)
        if self.path:
            self._load()

    # --- persistence ---

    @staticmethod
    def _coerce_row(v) -> dict:
        """One resumed aggregate row with every field coerced to its
        numeric type (non-numeric values fall back to 0) — the
        JobSpool.get discipline: a hand-edited or foreign-tool
        costs.json that is valid JSON but schema-drifted must degrade
        to zeros, never plant a TypeError in the dispatch worker's
        later ``record`` arithmetic."""
        row = _zero_row()
        if isinstance(v, dict):
            for key, default in list(row.items()):
                try:
                    row[key] = type(default)(v.get(key, default))
                except (TypeError, ValueError):
                    pass
        return row

    def _load(self) -> None:
        try:
            with open(self.path) as fh:
                d = json.load(fh)
            if not isinstance(d, dict):
                return
        except (OSError, ValueError):
            return
        def table(name: str) -> dict:
            src = d.get(name)
            if not isinstance(src, dict):
                return {}
            return {str(k): self._coerce_row(v) for k, v in src.items()
                    if isinstance(v, dict)}

        with self._lock:
            self._tenants = table("tenants")
            self._buckets = table("buckets")
            self._routes = table("routes")
            self._totals = self._coerce_row(d.get("totals"))
            self._resumed = True

    def flush(self) -> None:
        """Persist the aggregates atomically (.part-rename, the spool
        manifest discipline) when anything changed since the last flush.
        Never raises — the ledger is accounting, the spool manifest
        stays the durable record of the jobs themselves."""
        if not self.path:
            return
        with self._lock:
            if not self._dirty:
                return
            body = json.dumps(self.report(), indent=1, default=str)
            self._dirty = False
        try:
            tmp = f"{self.path}.part"
            with open(tmp, "w") as fh:
                fh.write(body)
                fh.write("\n")
            os.replace(tmp, self.path)
        except OSError:
            with self._lock:
                self._dirty = True   # retry on the next flush cadence

    # --- registration (daemon/router start) ---

    def register_counters(self) -> None:
        """Pre-register every ``ict_cost_*`` family at 0 so they are
        PRESENT on the exposition from the first scrape: the fleet's
        budget-burn alerts are gt thresholds over these series, and a
        lazily-registered counter vanishing across a clean restart would
        let freeze-on-missing pin a fired alert forever."""
        for family in TENANT_COUNTER_FAMILIES:
            tracing.count_labeled(family, {"tenant": DEFAULT_TENANT}, 0.0)
        tracing.count_labeled("cost_bucket_device_seconds_total",
                              {"shape_bucket": UNBUCKETED}, 0.0)
        tracing.count_labeled("cost_route_device_seconds_total",
                              {"route": "sharded"}, 0.0)
        tracing.set_gauge_labeled("cost_attainment_ratio",
                                  {"shape_bucket": UNBUCKETED}, 0.0)

    # --- the write path (dispatch-worker thread) ---

    def record(self, cost: dict) -> None:
        """Fold one finalized CostRecord into the aggregates and bump
        the ``ict_cost_*`` counters the fleet federation scrapes."""
        tenant = str(cost.get("tenant") or DEFAULT_TENANT)
        bucket = str(cost.get("bucket") or UNBUCKETED)
        route = str(cost.get("route") or "unknown")
        device_s = float(cost.get("device_s", 0.0) or 0.0)
        compile_s = float(cost.get("compile_s", 0.0) or 0.0)
        nbytes = float(cost.get("bytes_accessed", 0.0) or 0.0)
        flops = float(cost.get("flops", 0.0) or 0.0)
        hit = bool(cost.get("cache_hit", False))
        avoided_s = float(cost.get("avoided_device_s", 0.0) or 0.0)
        avoided_b = float(cost.get("avoided_bytes_accessed", 0.0) or 0.0)
        with self._lock:
            for row in (self._tenants.setdefault(tenant, _zero_row()),
                        self._buckets.setdefault(bucket, _zero_row()),
                        self._routes.setdefault(route, _zero_row()),
                        self._totals):
                row["device_s"] = round(row["device_s"] + device_s, 6)
                row["jobs"] += 1
                row["compile_s"] = round(row["compile_s"] + compile_s, 6)
                row["bytes_accessed"] += nbytes
                row["flops"] += flops
                if hit:
                    row["cache_hits"] += 1
                    row["avoided_device_s"] = round(
                        row["avoided_device_s"] + avoided_s, 6)
                    row["avoided_bytes"] += avoided_b
            self._dirty = True
        labels = {"tenant": tenant}
        tracing.count_labeled("cost_device_seconds_total", labels, device_s)
        tracing.count_labeled("cost_jobs_total", labels)
        tracing.count_labeled("cost_compile_seconds_total", labels,
                              compile_s)
        tracing.count_labeled("cost_bytes_accessed_total", labels, nbytes)
        if hit:
            tracing.count_labeled("cost_cache_hits_total", labels)
            tracing.count_labeled("cost_cache_avoided_device_seconds_total",
                                  labels, avoided_s)
            tracing.count_labeled("cost_cache_avoided_bytes_total", labels,
                                  avoided_b)
        tracing.count_labeled("cost_bucket_device_seconds_total",
                              {"shape_bucket": bucket}, device_s)
        tracing.count_labeled("cost_route_device_seconds_total",
                              {"route": route}, device_s)

    # --- reads (HTTP handler threads, tests, bench) ---

    def device_seconds(self) -> float:
        with self._lock:
            return float(self._totals["device_s"])

    def report(self) -> dict:
        """The lifetime showback view (``GET /costs`` on the replica):
        per-tenant / bucket / route rows plus the totals.  ``resumed``
        says whether a previous life's figures are folded in — the
        reason these totals may exceed this life's counters."""
        with self._lock:
            return {
                "replica_id": self.replica_id,
                "resumed": self._resumed,
                "totals": dict(self._totals),
                "tenants": {k: dict(v)
                            for k, v in sorted(self._tenants.items())},
                "buckets": {k: dict(v)
                            for k, v in sorted(self._buckets.items())},
                "routes": {k: dict(v)
                           for k, v in sorted(self._routes.items())},
            }
