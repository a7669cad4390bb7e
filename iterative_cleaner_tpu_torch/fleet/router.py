"""The fleet router: one front door for N cleaning-daemon replicas.

Port of ``iterative_cleaner_tpu/fleet/router.py``.

Placement policy (docs/SERVING.md "Fleet"):

- **least-loaded-by-bucket** — candidates are ranked by the scalar load
  off their last ``/healthz`` snapshot (open jobs + every queue depth +
  placements routed since that snapshot), minus a **warm-cache affinity
  bonus** when the submission declares its shape bucket (optional
  ``"shape": [nsub, nchan, nbin]`` in the POST body): a replica whose
  warm pool holds the bucket's executables — or that already has cubes
  of that bucket queued — is preferred, because on it the job compiles
  nothing;
- **drain/death eviction** — a draining replica (``/healthz`` says
  ``draining: true``) or a dead one (``dead_after`` consecutive
  unreachable polls) gets no new placements; a dead replica's open
  placements are **re-routed** to surviving replicas carrying the same
  idempotency key, so the job runs at most once per replica and the
  fleet serves it exactly once while the dead replica stays dead;
- **failover retries** — submission-path transport failures walk the
  remaining candidates, then back off with **full jitter**
  (utils/backoff.py; ``ICT_BACKOFF_SEED`` pins schedules in tests) so N
  routers (or one router's N queued failovers) recovering from the same
  incident don't thundering-herd the revived replica;
- **multi-tenant admission** — per-tenant open-placement quotas (429 +
  ``Retry-After`` on breach) and weighted fair queueing over placement
  grants when submissions contend for the ``--max_inflight`` budget
  (fleet/tenants.py; ``X-ICT-Tenant`` header, absent -> "default").

The router is just another stdlib-HTTP daemon — ``serve-fleet`` on the
CLI, ``ThreadingHTTPServer`` + ``urllib`` inside, zero new dependencies
— and it exposes its own ``/metrics`` (placements, failovers, per-tenant
admissions/rejections, per-replica queue-depth gauges) so the obs tower
sees the fleet as one system.  Trace context crosses the hop: the
router forwards ``X-ICT-Trace`` on proxied submissions and emits
``fleet_placement`` / ``fleet_failover`` events into the event log and
the flight ring.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
import urllib.parse
import uuid
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from iterative_cleaner_tpu_torch.campaign.orchestrator import CampaignOrchestrator
from iterative_cleaner_tpu_torch.campaign.store import CampaignStore
from iterative_cleaner_tpu_torch.fleet import alerts as fleet_alerts
from iterative_cleaner_tpu_torch.fleet import autoscale as fleet_autoscale
from iterative_cleaner_tpu_torch.fleet import cache as fleet_cache
from iterative_cleaner_tpu_torch.fleet import canary as fleet_canary
from iterative_cleaner_tpu_torch.fleet import capacity as fleet_capacity
from iterative_cleaner_tpu_torch.fleet import costs as fleet_costs
from iterative_cleaner_tpu_torch.fleet import history as fleet_history
from iterative_cleaner_tpu_torch.fleet import obs as fleet_obs
from iterative_cleaner_tpu_torch.fleet import slo as fleet_slo
from iterative_cleaner_tpu_torch.fleet import trends as fleet_trends
from iterative_cleaner_tpu_torch.fleet.client import (
    ReplicaClient,
    ReplicaRefused,
    ReplicaUnreachable,
)
from iterative_cleaner_tpu_torch.fleet.registry import Replica, ReplicaRegistry
from iterative_cleaner_tpu_torch.fleet.tenants import (
    DEFAULT_TENANT,
    SYNTHETIC_TENANT,
    QuotaExceeded,
    TenantAdmission,
    WeightedFairQueue,
)
from iterative_cleaner_tpu_torch.fleet import explain as fleet_explain
from iterative_cleaner_tpu_torch.obs import events, flight
from iterative_cleaner_tpu_torch.obs import metrics as obs_metrics
from iterative_cleaner_tpu_torch.obs import tracing as obs_tracing
from iterative_cleaner_tpu_torch.proving import recorder as fleet_recorder
from iterative_cleaner_tpu_torch.service.scheduler import bucket_label
from iterative_cleaner_tpu_torch.utils import backoff

#: Placement-score bonus for a replica whose warm pool already holds the
#: submission's shape bucket (it will compile nothing), and the smaller
#: bonus for one that merely has the bucket queued (its compile is paid
#: or in flight).  Units are "queued cubes": a warm replica wins ties
#: and small load deficits, but a deeply-backlogged warm replica still
#: loses to an idle cold one.
AFFINITY_WARM = 2.5
AFFINITY_QUEUED = 1.25

#: Placement-score PENALTY for a replica the straggler detector has
#: flagged (fleet/obs.py): bigger than both affinity bonuses combined, so
#: a slow-but-warm replica still loses to a healthy cold one, yet finite
#: — a fleet whose every survivor is flagged still places.
STRAGGLER_PENALTY = 4.0

#: Consecutive 404 status polls before an open placement is declared
#: lost (its replica restarted with a cleared spool and genuinely does
#: not know the job) and failed terminally.
MISSING_POLLS_LOST = 3

#: Default ceiling on the file size the fleet cache will hash at
#: placement time (the check runs synchronously in the HTTP handler);
#: ``ICT_FLEET_CACHE_MAX_BYTES`` overrides.
FLEET_CACHE_MAX_BYTES = 256 << 20

#: The backend a port replica reports on ``/healthz`` while it serves on
#: its device (``service/daemon.py``): a move from it to ``"numpy"``
#: between polls is a demotion incident.
DEVICE_BACKEND = "torch"


def _fleet_cache_max_bytes() -> int:
    try:
        return int(os.environ.get("ICT_FLEET_CACHE_MAX_BYTES",
                                  FLEET_CACHE_MAX_BYTES))
    except ValueError:
        return FLEET_CACHE_MAX_BYTES


class FleetBusy(RuntimeError):
    """No replica could take the job right now (all dead, draining, or
    at capacity, or the placement-grant wait timed out) — HTTP 503 with
    Retry-After, the replica admission-cap convention."""


@dataclass
class FleetConfig:
    replicas: tuple = ()             # replica base URLs, e.g. http://h:8750
    host: str = "127.0.0.1"
    port: int = 8790                 # 0 = ephemeral (tests)
    router_id: str = ""              # "" = mint one per process life
    poll_interval_s: float = 1.0     # health-poll + failover-sweep cadence
    dead_after: int = 3              # consecutive unreachable polls -> dead
    replica_timeout_s: float = 10.0  # per router->replica HTTP call
    max_inflight: int = 0            # fleet-wide open-placement budget
                                     # (0 = unbounded); contention beyond it
                                     # is arbitrated by weighted fair queueing
    queue_timeout_s: float = 30.0    # max wait for a placement grant
    failover_retries: int = 2        # extra candidate sweeps per submission
    retry_backoff_s: float = 0.25    # full-jitter base between sweeps
    placement_keep: int = 10000      # terminal placement records kept
    tenant_quotas: dict = field(default_factory=dict)
    tenant_weights: dict = field(default_factory=dict)
    tenant_budgets: dict = field(default_factory=dict)
                                     # advisory device-seconds budgets
                                     # (--tenant NAME:QUOTA:WEIGHT:BUDGET)
                                     # feeding tenant_budget_burn alert
                                     # rules — showback, never admission
                                     # (fleet/costs.py)
    default_quota: int = 0           # per-tenant open-placement cap (0 = off)
    default_weight: float = 1.0
    telemetry: str = ""              # JSON-lines event log (obs/events)
    spool_dir: str = "./ict_fleet_spool"   # router-side durable dir:
                                     # flight-ring dumps (<spool>/flight)
                                     # and incident bundles
                                     # (<spool>/fleet-incidents)
    straggler_factor: float = 3.0    # p50 multiple of the fleet median
                                     # that flags a replica (fleet/obs.py)
    straggler_polls: int = 3         # consecutive slow polls before firing
    straggler_window: int = 8        # polls of latency deltas per p50
    straggler_phase: str = "service_dispatch"  # the watched phase family
    slo_grant_s: float = 1.0         # per-tenant SLO on the WFQ grant
                                     # wait; beyond it (or a grant
                                     # timeout) burns fleet_slo_burn_total
    capacity_window: int = 8         # poll ticks per capacity-model rate
                                     # window (fleet/capacity.py)
    autoscale: str = "off"           # off | advise | act — the elastic
                                     # scaling loop (fleet/autoscale.py);
                                     # advise only emits recommendations
    min_replicas: int = 1            # alive floor the scaler respects
    max_replicas: int = 4            # alive ceiling
    scale_up_eta_s: float = 10.0     # backlog-drain ETA that counts as
                                     # "behind" toward a scale-up
    scale_up_polls: int = 3          # hysteresis: consecutive behind polls
    scale_down_polls: int = 6        # hysteresis: consecutive idle polls
    scale_idle_util: float = 0.05    # fleet utilization under this = idle
    scale_cooldown_s: float = 30.0   # quiet period after any decision
    spawn_retries: int = 3           # full-jitter spawn retry ladder depth
    spawn_args: tuple = ()           # extra ict-serve-torch args for spawned
                                     # subprocess replicas (--spawn_arg)
    history_ticks: int = 128         # poll ticks of federated-metrics
                                     # history retained (fleet/history.py;
                                     # GET /fleet/metrics/history)
    default_alerts: bool = True      # install the default SLO rule pack
                                     # (fleet/alerts.py)
    alert_rules: tuple = ()          # extra rule specs (dicts, the
                                     # --alert_rule JSON shape) on top of
                                     # the default pack
    alert_webhook: str = ""          # POST each firing/resolved
                                     # transition here (full-jitter retry)
    alert_cmd: str = ""              # shell command per transition
                                     # (the JSON on stdin)
    alert_retries: int = 3           # delivery retries per sink
    canary_ticks: int = 0            # poll ticks between canary probe
                                     # rounds (fleet/canary.py; 0 = off)
    slo: tuple = ()                  # declarative SLO objective specs
                                     # (--slo JOURNEY:TARGET:WINDOW_TICKS;
                                     # fleet/slo.py)
    recorder: bool = True            # the production flight recorder
                                     # (proving/recorder.py): always on
                                     # unless --no_recorder / ICT_RECORDER=0
    recorder_segment_kb: int = 256   # open-segment size cap before a
                                     # seal rotates it
    recorder_keep: int = 16          # sealed segments retained
    trends: bool = True              # the durable performance-trend plane
                                     # (fleet/trends.py): multi-resolution
                                     # spool-persisted rollups + the
                                     # regression sentinel; off via
                                     # --no_trends / ICT_TRENDS=0
    trend_keep_raw: int = 128        # raw per-tick points kept per series
    trend_signals: tuple = ()        # extra/override fingerprint signal
                                     # specs (dicts, the --trend_signal
                                     # JSON shape) on top of the default
                                     # set; same-name specs replace
    trend_sentinel_k: int = 3        # consecutive out-of-band windows
                                     # before the sentinel fires
    trend_min_samples: int = 8       # accepted windows before a
                                     # fingerprint arms
    trend_band_mad: float = 4.0      # fingerprint band half-width in
                                     # MAD units
    trend_persist_every: int = 16    # poll ticks between trend-store
                                     # spool writes (stop() always
                                     # persists)
    device: str = "cuda"             # torch device of the replicas the
                                     # smokes build in-process ("cpu"
                                     # runs the kernels' plain versions)
    quiet: bool = False


@dataclass
class Placement:
    """One routed job.  ``job_id`` is the fleet-visible identity — the id
    the FIRST accepting replica minted, which the client holds from its
    202; after a failover the serving replica (and its inner job id)
    change underneath while the fleet id stays stable, and proxied reads
    rewrite the manifest back to it."""

    job_id: str
    tenant: str
    trace_id: str
    payload: dict                   # forwarded verbatim on re-route, with
                                    # the idempotency key inside — the same
                                    # key is what makes re-routes dedupe
    base_url: str
    replica_id: str
    replica_job_id: str
    state: str = "open"             # open -> done | error
    error: str = ""
    attempts: int = 1               # placements incl. failover re-routes
    submitted_s: float = 0.0
    # Every (replica, replica_job_id) this placement has lived on, in
    # placement order — the cross-hop trace assembly walks these to
    # stitch a failed-over job's telemetry from BOTH replicas
    # (fleet/obs.py; mutated only under the router's placement lock).
    hops: list = field(default_factory=list)
    # Fleet-cache hits are placements born terminal: the recorded result
    # summary is served directly by job_manifest (no replica proxy, the
    # origin replica may be long gone) — None for ordinary placements.
    cached: dict | None = None
    missing_polls: int = 0          # consecutive status polls the serving
                                    # replica answered 404 — a revived
                                    # replica whose spool was cleared has
                                    # genuinely lost the job, and the
                                    # placement must fail terminally
                                    # instead of leaking its slot forever
    synthetic: bool = False         # a canary probe placement: it never
                                    # took an admission slot, a WFQ
                                    # grant, or capacity demand, so the
                                    # terminal transition must not hand
                                    # any of them back (fleet/canary.py)


def new_router_id() -> str:
    return f"fr-{uuid.uuid4().hex[:8]}"


def _json_safe(obj):
    """Replace IEEE specials with their string spellings so HTTP replies
    stay strict JSON (json.dumps would emit the non-standard
    ``Infinity`` token; ``float("inf")`` parses the string back)."""
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, float) and (obj != obj or obj in
                                   (float("inf"), float("-inf"))):
        return "nan" if obj != obj else (
            "inf" if obj > 0 else "-inf")
    return obj


class RouterMetrics:
    """The router's own tiny metric registry, rendered as Prometheus
    text on ``/metrics``.  Deliberately NOT the process-global
    obs.tracing registry: fleet tests run a router and three replicas in
    one process, and the router's counters must not bleed into (or read
    from) the replicas' — each HTTP surface exposes exactly its own
    process role."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # (family, ((label, value), ...)) -> float
        self._counters: dict = {}  # ict: guarded-by(self._lock)
        self._gauges: dict = {}  # ict: guarded-by(self._lock)
        # (family, label_pairs) -> [per-bucket counts (len(HIST_BOUNDS)
        # + 1, trailing +Inf overflow), running sum] on the fixed log2
        # bounds — the canary journey-latency histograms.
        self._hists: dict = {}  # ict: guarded-by(self._lock)

    @staticmethod
    def _key(family: str, labels: dict | None):
        return (family, tuple(sorted((labels or {}).items())))

    def count(self, family: str, labels: dict | None = None,
              inc: float = 1.0) -> None:
        key = self._key(family, labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + inc

    def counter_value(self, family: str, labels: dict | None = None) -> float:
        with self._lock:
            return self._counters.get(self._key(family, labels), 0.0)

    def counter_total(self, family: str) -> float:
        with self._lock:
            return sum(v for (fam, _), v in self._counters.items()
                       if fam == family)

    def set_gauge(self, family: str, labels: dict | None,
                  value: float) -> None:
        with self._lock:
            self._gauges[self._key(family, labels)] = float(value)

    def observe_hist(self, family: str, labels: dict | None,
                     value: float) -> None:
        """One observation into a fixed log2-bounds histogram series
        (the obs/tracing bucket walk; series appear on first
        observation or via :meth:`ensure_hist`)."""
        key = self._key(family, labels)
        with self._lock:
            rec = self._hists.get(key)
            if rec is None:
                rec = [[0.0] * (len(obs_tracing.HIST_BOUNDS) + 1), 0.0]
                self._hists[key] = rec
            buckets = rec[0]
            for i, bound in enumerate(obs_tracing.HIST_BOUNDS):
                if value <= bound:
                    buckets[i] += 1.0
                    break
            else:
                buckets[-1] += 1.0
            rec[1] += float(value)

    def ensure_hist(self, family: str, labels: dict | None) -> None:
        """Pre-register one zero-count histogram series (the gauge
        pre-registration lesson applied to histograms: a documented
        family must be live on the first scrape)."""
        key = self._key(family, labels)
        with self._lock:
            self._hists.setdefault(
                key, [[0.0] * (len(obs_tracing.HIST_BOUNDS) + 1), 0.0])

    def replace_gauge_family(self, family: str,
                             entries: dict[tuple, float]) -> None:
        """Swap every sample of one gauge family atomically — per-replica
        and per-bucket gauges are rebuilt from each health poll, and a
        bucket that drained (or a replica that left) must drop off the
        exposition rather than freeze at its last value."""
        with self._lock:
            for key in [k for k in self._gauges if k[0] == family]:
                del self._gauges[key]
            for labels, value in entries.items():
                self._gauges[(family, tuple(sorted(labels)))] = float(value)

    def render(self) -> str:
        """Prometheus text exposition via the ONE shared renderer in
        obs/metrics.py (render_registries) — the registry is deliberately
        separate from the process-global one, the grammar implementation
        is not (pinned by the strict-regex test in tests/test_fleet.py)."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {key: (obs_tracing.HIST_BOUNDS, list(rec[0]), rec[1])
                     for key, rec in self._hists.items()}
        return obs_metrics.render_registries(counters, gauges, hists=hists)


class _Ticket:
    """One submission waiting for a placement grant; written only under
    the router's placement condition lock."""

    __slots__ = ("granted", "abandoned")

    def __init__(self) -> None:
        self.granted = False
        self.abandoned = False


class FleetRouter:
    """Lifecycle + the placement engine.  Thread layout (all daemonic):
    the ThreadingHTTPServer's per-request threads (submissions block in
    the WFQ grant wait; reads are lock-snapshot cheap) and ONE poll
    thread (health refresh, placement-status refresh, failover sweep,
    gauge rebuild).  All shared state sits behind ``self._cond``'s lock
    (placements, inflight budget, WFQ) or the registry's/metrics' own
    locks — acquisition order is always router -> registry/metrics,
    never the reverse."""

    def __init__(self, cfg: FleetConfig, replica_factory=None) -> None:
        if not cfg.replicas:
            raise ValueError("a fleet needs at least one --replica URL")
        self.cfg = cfg
        self.router_id = cfg.router_id or new_router_id()
        self.started_s = time.time()
        self.client = ReplicaClient(timeout_s=cfg.replica_timeout_s)
        self.registry = ReplicaRegistry(
            [u.rstrip("/") for u in cfg.replicas],
            dead_after=cfg.dead_after)
        self.admission = TenantAdmission(
            quotas=cfg.tenant_quotas, default_quota=cfg.default_quota)
        self.metrics = RouterMetrics()
        # RLock, deliberately: the grant pump (_grant_free_slots) takes it
        # lexically so every _inflight mutation sits under a visible
        # ``with self._lock:`` (the ICT007 discipline), and its callers
        # already hold the lock when pumping after a state change.
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._wfq = WeightedFairQueue(
            weights=cfg.tenant_weights, default_weight=cfg.default_weight)
        # The fleet observability plane (fleet/obs.py): per-replica
        # /metrics + flight-ring scrape cache, the bounded cross-hop span
        # store, and the windowed straggler detector — each owns its own
        # lock, always acquired AFTER the router's (never while holding
        # theirs), so the router -> registry/metrics order extends to
        # router -> obs cleanly.
        self.scrapes = fleet_obs.ScrapeCache()
        self.traces = fleet_obs.TraceStore()
        self.straggler = fleet_obs.StragglerDetector(
            factor=cfg.straggler_factor, polls=cfg.straggler_polls,
            window=cfg.straggler_window)
        # The capacity model (fleet/capacity.py): fed by the same poll
        # tick, rendered as ict_fleet_capacity_* gauges and
        # GET /fleet/capacity; its lock too sits strictly after the
        # router's in the acquisition order.
        self.capacity = fleet_capacity.CapacityModel(
            window=cfg.capacity_window,
            dispatch_phase=cfg.straggler_phase)
        # The alerting plane: the bounded federated-metrics
        # history ring fed once per poll tick from the exposition the
        # router already serves (zero new scrape traffic), and the
        # declarative rule engine evaluated over it.  Both own their own
        # locks, acquired strictly AFTER the router's RLock and never
        # while calling out — the router -> obs/capacity order extends to
        # history/alerts unchanged.
        self.history = fleet_history.MetricsHistory(keep=cfg.history_ticks)
        rules: list[fleet_alerts.AlertRule] = []
        if cfg.default_alerts:
            rules.extend(fleet_alerts.default_rule_pack(
                poll_interval_s=cfg.poll_interval_s,
                scale_up_eta_s=cfg.scale_up_eta_s,
                autoscale=cfg.autoscale))
        # Tenant budgets install their advisory burn rules next to the
        # default pack (fleet/costs.py; present regardless of
        # --no_default_alerts — a declared budget nobody watches would
        # be a lie); operator --alert_rule names still override.
        rules.extend(fleet_costs.budget_rules(cfg.tenant_budgets))
        # SLO burn-rate rules (fleet/slo.py): two multiwindow
        # rules per declared objective over the router-computed
        # ict_sli_burn_rate gauge, installed the budget_rules way —
        # before the operator loop, so --alert_rule names still replace.
        self._slo_objectives = fleet_slo.parse_slo_specs(cfg.slo)
        rules.extend(fleet_slo.burn_rules(self._slo_objectives))
        # The regression sentinel's bridge rule (fleet/trends.py):
        # one source="trend" rule over the
        # ict_fleet_perf_regression gauge the trend plane republishes
        # each tick — it fires per series, so one rule covers every
        # fingerprint key.  Installed the budget_rules way, before the
        # operator loop, so --alert_rule names still replace.
        self._trends_enabled = (cfg.trends
                                and os.environ.get("ICT_TRENDS",
                                                   "1") != "0")
        if self._trends_enabled:
            rules.extend(fleet_trends.trend_rules())
        for spec in cfg.alert_rules:
            rule = (spec if isinstance(spec, fleet_alerts.AlertRule)
                    else fleet_alerts.parse_rule(spec))
            # An operator rule re-using a default name REPLACES the
            # default (how a threshold is tuned without --no_default_alerts).
            rules = [r for r in rules if r.name != rule.name]
            rules.append(rule)
        self.alerts = fleet_alerts.AlertEngine(
            rules, history_ticks=cfg.history_ticks)
        self.alert_sinks = fleet_alerts.AlertSinks(
            webhook=cfg.alert_webhook, command=cfg.alert_cmd,
            retries=cfg.alert_retries,
            retry_backoff_s=cfg.retry_backoff_s, quiet=cfg.quiet,
            note=lambda sink, status: self.metrics.count(
                "fleet_alert_notifications_total",
                {"sink": sink, "status": status}))
        # The elastic-scaling loop (fleet/autoscale.py), off by default.
        # The supervisor spawns in-process replicas when the embedder
        # hands in a factory (tests, the autoscale smoke) and real
        # ict-serve-torch subprocesses otherwise, rooted under the router
        # spool.
        self.supervisor = None
        self.autoscaler = None
        if cfg.autoscale != "off":
            factory = replica_factory or fleet_autoscale.\
                SubprocessReplicaFactory(
                    os.path.join(cfg.spool_dir, "replicas"),
                    extra_args=("--device", cfg.device, *cfg.spawn_args))
            self.supervisor = fleet_autoscale.ReplicaSupervisor(
                factory, self.registry, self.client,
                spawn_retries=cfg.spawn_retries,
                retry_backoff_s=cfg.retry_backoff_s,
                note_spawn_failure=lambda: self.metrics.count(
                    "fleet_scale_events_total",
                    {"direction": "up", "reason": "spawn_failed"}),
                quiet=cfg.quiet)
            self.autoscaler = fleet_autoscale.Autoscaler(
                fleet_autoscale.AutoscaleConfig(
                    mode=cfg.autoscale,
                    min_replicas=cfg.min_replicas,
                    max_replicas=cfg.max_replicas,
                    scale_up_eta_s=cfg.scale_up_eta_s,
                    up_polls=cfg.scale_up_polls,
                    down_polls=cfg.scale_down_polls,
                    idle_utilization=cfg.scale_idle_util,
                    cooldown_s=cfg.scale_cooldown_s))
        # The fleet-wide content-addressed result index (fleet/cache.py;
        # the reuse half): learned from the terminal
        # manifests the status polls already observe, checked at
        # placement time so byte-identical resubmissions return without
        # touching any replica.  Owns its own lock, acquired strictly
        # after the router's, never while calling out.
        self.result_index = fleet_cache.FleetResultIndex()
        # The cost-accounting fold (fleet/costs.py): rebuilt once per
        # poll tick from the scrape cache, served at GET /fleet/costs.
        self._costs_snapshot: dict = {}  # ict: guarded-by(self._lock)
        # Pre-register the budget gauge at 0 for every budgeted tenant
        # (the daemon's ict_cost_* pre-registration lesson, router
        # side): the burn rules are gt thresholds, and the series must
        # exist before the first placement for firing AND resolution to
        # work from the first tick.
        self.metrics.replace_gauge_family(
            "fleet_tenant_budget_used_pct",
            {(("tenant", t),): 0.0 for t in cfg.tenant_budgets})
        # The survey-campaign orchestrator (campaign/): spool-persisted
        # under <spool>/campaigns/, rehydrated NOW so a restarted router
        # resumes open campaigns from its first poll tick.  Its lock
        # orders strictly after the router's: it snapshots its own state,
        # calls place_job/job_manifest UNLOCKED, then re-acquires to
        # record (campaign/orchestrator.py).
        self.campaigns = CampaignOrchestrator(
            CampaignStore(os.path.join(cfg.spool_dir, "campaigns")),
            self, quiet=cfg.quiet)
        # Pre-register every ict_campaign_* gauge family — zero-valued
        # aggregates plus whatever the rehydrate brought back — so the
        # documented families are live on every exposition from the
        # first scrape (the budget-gauge pre-registration lesson;
        # tests/test_metric_docs.py), not only once a campaign exists.
        for family, entries in self.campaigns.gauge_families().items():
            self.metrics.replace_gauge_family(family, entries)
        # The SLI/error-budget plane (fleet/slo.py) — ALWAYS constructed
        # (SLIs render for every journey even with no --slo objectives;
        # the spool-persisted ledger rehydrates budget accounting across
        # restarts) — and the black-box canary prober (fleet/canary.py)
        # probing the router's own public HTTP surface on the
        # --canary_ticks cadence.
        self.slo = fleet_slo.SloPlane(
            self._slo_objectives, cfg.spool_dir, metrics=self.metrics,
            quiet=cfg.quiet)
        self.canary = fleet_canary.CanaryProber(
            cfg.spool_dir,
            lambda: f"http://{self.cfg.host}:{self.port}",
            quiet=cfg.quiet)
        self.canary.slo = self.slo
        self.canary.on_mask_mismatch = self._canary_mismatch
        # Poll ticks until the next canary round (counts down each
        # _slo_tick when probing is enabled; first round fires on the
        # first tick so the smoke and a fresh fleet get a verdict
        # immediately).
        self._ticks_to_canary = 1 if cfg.canary_ticks > 0 else 0  # ict: guarded-by(self._lock)
        # Pre-register the whole SLI/canary surface at zero (the budget
        # gauge lesson): gauges via the plane's own families, counters
        # and the journey-latency histogram as explicit zero series, so
        # every documented ict_sli_*/ict_canary_* family is live on the
        # first scrape and burn rules can fire AND resolve from tick 1.
        for family, entries in self.slo.gauge_families().items():
            self.metrics.replace_gauge_family(family, entries)
        for j in fleet_slo.JOURNEYS:
            self.metrics.count("sli_good_events_total", {"journey": j},
                               inc=0.0)
            self.metrics.count("sli_bad_events_total", {"journey": j},
                               inc=0.0)
        for j in fleet_slo.CANARY_JOURNEYS:
            for outcome in ("ok", "fail"):
                self.metrics.count("canary_probes_total",
                                   {"journey": j, "outcome": outcome},
                                   inc=0.0)
            self.metrics.count("canary_mask_mismatches_total",
                               {"journey": j}, inc=0.0)
            self.metrics.ensure_hist(fleet_slo.CANARY_HIST_FAMILY,
                                     {"journey": j})
        # The production flight recorder (proving/recorder.py):
        # every REAL submission lands on a bounded, rotated segment set
        # under <spool>/fleet-traces in the proving-ground trace grammar
        # — synthetic canary/soak traffic is refused inside record(), by
        # construction, and ICT_RECORDER=0 (or --no_recorder) disables
        # recording while keeping the read surface live.  Its lock sits
        # strictly after the router's, file appends only, never HTTP.
        self.recorder = fleet_recorder.FlightRecorder(
            os.path.join(cfg.spool_dir, "fleet-traces"),
            max_segment_kb=cfg.recorder_segment_kb,
            keep=cfg.recorder_keep,
            enabled=(cfg.recorder
                     and os.environ.get("ICT_RECORDER", "1") != "0"),
            quiet=cfg.quiet)
        # Counter mirrors are delta-fed from the recorder's own totals
        # once per poll tick (_recorder_tick); the whole ict_recorder_*
        # surface is pre-registered at zero NOW (the budget-gauge
        # lesson) so every documented family is live on the first scrape.
        self._recorder_seen: dict = {}  # ict: guarded-by(self._lock)
        for fam in ("recorder_entries_total", "recorder_excluded_total",
                    "recorder_dropped_total",
                    "recorder_segments_sealed_total"):
            self.metrics.count(fam, inc=0.0)
        self._recorder_tick()
        # The durable performance-trend plane (fleet/trends.py):
        # multi-resolution spool-persisted rollups over the SAME
        # parsed exposition the history ring records (zero new scrape
        # traffic), performance fingerprints, and the regression
        # sentinel.  Rehydrated NOW from <spool>/trends so the rings
        # survive a restart; its locks sit strictly after the router's.
        self.trends = None
        if self._trends_enabled:
            specs = {s.name: s for s in fleet_trends.default_signals()}
            for spec in cfg.trend_signals:
                s = (spec if isinstance(spec, fleet_trends.SignalSpec)
                     else fleet_trends.parse_signal(spec))
                specs[s.name] = s
            baseline = os.path.join(
                os.path.dirname(os.path.dirname(
                    os.path.dirname(os.path.abspath(__file__)))),
                "docs", "bench_baseline_cpu.json")
            self.trends = fleet_trends.TrendPlane(fleet_trends.TrendConfig(
                spool_dir=cfg.spool_dir,
                keep_raw=cfg.trend_keep_raw,
                signals=tuple(specs.values()),
                sentinel_k=cfg.trend_sentinel_k,
                min_samples=cfg.trend_min_samples,
                band_mad=cfg.trend_band_mad,
                persist_every=cfg.trend_persist_every,
                baseline_path=baseline if os.path.isfile(baseline) else "",
                quiet=cfg.quiet))
        # Pre-register the whole ict_fleet_trend_* surface at zero (the
        # budget-gauge lesson) so every documented family is live on the
        # first scrape regardless of whether a rollup has sealed or a
        # persist has run; the regression counter rides along so the
        # sentinel's firing increment is a delta on an existing series.
        self.metrics.count("fleet_trend_ticks_total", inc=0.0)
        for res in fleet_trends.RESOLUTIONS:
            self.metrics.count("fleet_trend_rollups_total",
                               {"resolution": f"{res}s"}, inc=0.0)
        self.metrics.count("fleet_trend_persist_total", inc=0.0)
        self.metrics.count("fleet_trend_persist_errors_total", inc=0.0)
        self.metrics.count("fleet_perf_regressions_total", inc=0.0)
        self.metrics.set_gauge("fleet_trend_enabled", None,
                               1.0 if self.trends is not None else 0.0)
        self.metrics.set_gauge("fleet_trend_series", None,
                               float(self.trends.store.series_count())
                               if self.trends is not None else 0.0)
        # Persist-counter delta mirror (the recorder discipline: the
        # plane's totals are authoritative, counters only move forward).
        self._trend_persist_seen: dict = {}  # ict: guarded-by(self._lock)
        # Streaming-session proxy routes: fleet session id -> (replica
        # base_url, trace_id), bounded FIFO so an abandoned session can
        # never grow the map without bound.
        self._session_routes: dict[str, tuple] = {}  # ict: guarded-by(self._lock)
        # Last observed (audit_divergences, backend) per replica: the
        # incident watch fires a bundle when divergences move or a
        # replica demotes torch -> numpy between polls.
        self._health_seen: dict[str, tuple[float, str]] = {}  # ict: guarded-by(self._lock)
        self._last_poll_mono = 0.0  # monotonic stamp of the last completed poll_tick  # ict: guarded-by(self._lock)
        self._placements: dict[str, Placement] = {}  # ict: guarded-by(self._lock)
        # True while an acted scale-up's spawn thread runs: the
        # autoscaler takes no new verdict mid-spawn (the fleet's size is
        # in motion), but the poll loop itself stays live behind it.
        self._scale_in_flight = False  # ict: guarded-by(self._lock)
        # idempotency key -> fleet job id ("" while a placement carrying
        # the key is in flight): the ROUTER-side half of the dedupe — a
        # client retry with a pinned key must not run the job again on a
        # DIFFERENT replica (the replica-side map only covers retries
        # that land on the same one).  Trimmed with the placement table.
        self._idem_index: dict[str, str] = {}  # ict: guarded-by(self._lock)
        self._inflight = 0  # ict: guarded-by(self._lock)
        # One shared full-jitter RNG for failover backoff; drawn under its
        # own lock (random.Random is not documented thread-safe, and the
        # ICT_BACKOFF_SEED test hook wants one reproducible stream).
        self._rng_lock = threading.Lock()
        self._backoff_rng = backoff.make_rng()  # ict: guarded-by(self._rng_lock)
        self._stop_evt = threading.Event()
        self._threads: list[threading.Thread] = []
        self._server = None
        self.port = cfg.port

    @property
    def flight_dir(self) -> str:
        return os.path.join(self.cfg.spool_dir, "flight")

    @property
    def incident_dir(self) -> str:
        return os.path.join(self.cfg.spool_dir, "fleet-incidents")

    @property
    def alert_dir(self) -> str:
        return os.path.join(self.cfg.spool_dir, "fleet-alerts")

    # --- lifecycle ---

    def start(self) -> None:
        # Same contract as the daemon: telemetry="" must MEAN "honor
        # ICT_TELEMETRY / disabled", never inherit a predecessor's sink.
        events.configure(self.cfg.telemetry or None)
        flight.note("router_starting", router_id=self.router_id,
                    replicas=len(self.cfg.replicas))
        # Synchronous first poll: replica identities and load snapshots
        # exist before the first placement decision.
        self.registry.poll_once(self.client)
        self._update_replica_gauges()
        th = threading.Thread(target=self._poll_loop, daemon=True,
                              name=f"ict-fleet-poll-{self.router_id}")
        th.start()
        self._threads.append(th)
        self._server = ThreadingHTTPServer(
            (self.cfg.host, self.cfg.port), _RouterHandler)
        self._server.daemon_threads = True
        self._server.router = self
        self.port = self._server.server_address[1]
        th = threading.Thread(target=self._server.serve_forever, daemon=True,
                              name=f"ict-fleet-http-{self.router_id}")
        th.start()
        self._threads.append(th)
        if not self.cfg.quiet:
            alive = sum(1 for r in self.registry.snapshot() if r["alive"])
            print(f"ict-fleet: router {self.router_id} listening on "
                  f"http://{self.cfg.host}:{self.port} "
                  f"({alive}/{len(self.cfg.replicas)} replicas alive)",
                  file=sys.stderr)

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
        if self.supervisor is not None:
            # Managed replicas die with their router (their spools keep
            # any unfinished accepted work for the next life).
            self.supervisor.stop_all()
        self.alert_sinks.stop()
        self._stop_evt.set()
        with self._lock:
            self._cond.notify_all()
        for th in self._threads:
            th.join(timeout=10)
        # Final trend-store persist AFTER the poll thread is down (no
        # tick can race the snapshot): a restarted router rehydrates
        # rings byte-identical to what this life last saw.
        if self.trends is not None:
            self.trends.persist(force=True)

    # --- the poll loop: health, status refresh, failover, gauges ---

    def _poll_loop(self) -> None:
        while not self._stop_evt.wait(self.cfg.poll_interval_s):
            try:
                self.poll_tick()
            except Exception as exc:  # noqa: BLE001 — the fleet control
                # loop (death detection, failover, grant pump) must
                # outlive any one tick's surprise; poll_tick itself stays
                # raising so tests and the smoke see errors loudly.
                self.metrics.count("fleet_poll_errors_total")
                if not self.cfg.quiet:
                    print(f"ict-fleet: poll tick failed ({exc!r}); "
                          "continuing", file=sys.stderr)

    def poll_tick(self) -> None:
        """One maintenance pass; public so tests (and the smoke check)
        can drive the loop deterministically instead of sleeping."""
        newly_dead = self.registry.poll_once(self.client)
        for rep in newly_dead:
            if not self.cfg.quiet:
                print(f"ict-fleet: replica {rep.replica_id or rep.base_url} "
                      f"is dead after {rep.consecutive_failures} failed "
                      "health checks; re-routing its open placements",
                      file=sys.stderr)
            # Death eviction takes its flight ring and metrics to the
            # grave — except for what the scrape cache already holds:
            # snapshot it into an incident bundle NOW.
            self._note_incident("replica_death",
                                replica_id=rep.replica_id or rep.base_url)
        self._scrape_replicas()
        self._watch_replica_health()
        self._refresh_open_placements()
        self._failover_sweep()
        self._update_replica_gauges()
        self._update_capacity()
        self._update_costs()
        self._campaign_tick()
        self._slo_tick()
        self._recorder_tick()
        self._autoscale_tick()
        self._history_alert_tick()
        self._trim_placements()
        with self._lock:
            self._last_poll_mono = time.monotonic()
        # Replica capacity may have freed (placements turned terminal) —
        # wake any submissions parked in the WFQ grant wait.
        self._grant_free_slots()

    def _scrape_replicas(self) -> None:
        """Metrics federation's inbound half: pull every live replica's
        ``/metrics`` (strict-parsed) and ``/debug/flight`` (the
        best-effort pre-death cache) into the scrape cache, feed the
        straggler detector, and rebuild the staleness/straggler gauges.
        Scrapes run CONCURRENTLY (the registry poll_once discipline): one
        wedged replica costs the tick one timeout, not one per healthy
        replica behind it."""
        # Every ALIVE replica is scraped — a draining one still serves
        # accepted work and its latency belongs in the fleet view.
        rows = [r for r in self.registry.snapshot() if r["alive"]]

        def scrape(row: dict):
            rid = row["replica_id"] or row["base_url"]
            try:
                text = self.client.metrics_text(row["base_url"])
                families = obs_metrics.parse_exposition(text)
            except (ReplicaUnreachable, ReplicaRefused, ValueError):
                # Liveness is the health poll's job; a failed scrape just
                # marks the cached copy stale (visible on the age gauge).
                return rid, None, None, None
            try:
                ring = self.client.flight(row["base_url"])
                flight_events = list(ring.get("events", []))
            except (ReplicaUnreachable, ReplicaRefused):
                flight_events = None   # keep the previous cached ring
            return rid, text, families, flight_events

        if rows:
            with ThreadPoolExecutor(
                    max_workers=min(8, len(rows)),
                    thread_name_prefix="ict-fleet-scrape") as pool:
                results = list(pool.map(scrape, rows))
        else:
            results = []
        for rid, text, families, flight_events in results:
            if families is None:
                self.scrapes.note_failure(rid)
            else:
                self.scrapes.update(rid, text, families, flight_events)
        snap = self.scrapes.snapshot()
        cum = {rid: fleet_obs.phase_hist_cum(rec["families"],
                                             self.cfg.straggler_phase)
               for rid, rec in snap.items() if rec["ok"]}
        verdict = self.straggler.update(cum)
        for rid in verdict["fired"]:
            self.metrics.count("fleet_straggler_flags_total",
                               {"replica": rid})
            if events.active():
                events.emit("fleet_straggler", replica_id=rid,
                            p50_s=verdict["p50"].get(rid),
                            fleet_median_s=verdict["median"])
            if not self.cfg.quiet:
                print(f"ict-fleet: replica {rid} flagged as a straggler "
                      f"(p50 {verdict['p50'].get(rid)}s vs fleet median "
                      f"{verdict['median']}s); de-prioritizing placements",
                      file=sys.stderr)
        for rid in verdict["cleared"]:
            if events.active():
                events.emit("fleet_straggler_cleared", replica_id=rid)
            if not self.cfg.quiet:
                print(f"ict-fleet: replica {rid} recovered; straggler "
                      "flag cleared", file=sys.stderr)
        ages = self.scrapes.ages()
        self.metrics.replace_gauge_family(
            "fleet_scrape_ok",
            {(("replica", rid),): (1.0 if rec["ok"] else 0.0)
             for rid, rec in snap.items()})
        self.metrics.replace_gauge_family(
            "fleet_scrape_age_seconds",
            {(("replica", rid),): age for rid, age in ages.items()})
        # A flagged replica whose scrape just failed stays on the gauge
        # (the detector keeps its flag) — union, not just this tick's cum.
        self.metrics.replace_gauge_family(
            "fleet_stragglers",
            {(("replica", rid),): (1.0 if rid in verdict["stragglers"]
                                   else 0.0)
             for rid in set(cum) | verdict["stragglers"]})
        self.metrics.replace_gauge_family(
            "fleet_replica_p50_seconds",
            {(("replica", rid),): p for rid, p in verdict["p50"].items()})

    def _watch_replica_health(self) -> None:
        """Fire an incident bundle when a replica's correctness health
        moves between polls: audit divergences counted up, or the backend
        demoted from the device backend to the numpy oracle (the worker
        ladder's top rung)."""
        for row in self.registry.snapshot():
            rid = row["replica_id"] or row["base_url"]
            if not row["alive"]:
                continue
            div = float(row.get("audit_divergences", 0) or 0)
            backend = str(row.get("backend", "") or "")
            with self._lock:
                prev = self._health_seen.get(rid)
                self._health_seen[rid] = (div, backend)
            if prev is None:
                continue
            if div > prev[0]:
                self._note_incident("audit_divergence", replica_id=rid)
            if prev[1] == DEVICE_BACKEND and backend == "numpy":
                self._note_incident("backend_demotion", replica_id=rid)

    def _note_incident(self, reason: str, replica_id: str = "",
                       job_id: str = "", trace_id: str = "") -> str | None:
        """Snapshot the fleet's state into one incident bundle
        (fleet/obs.py): placement table, registry, the replica's last
        good scrape + cached flight ring, and — for job-scoped incidents
        — the stitched trace."""
        scrape = self.scrapes.snapshot().get(replica_id, {})
        trace = None
        if trace_id:
            code, payload = self.fleet_trace(trace_id)
            if code == 200:
                trace = payload
        with self._lock:
            placements = [{
                "job_id": p.job_id, "tenant": p.tenant,
                "trace_id": p.trace_id, "state": p.state,
                "replica_id": p.replica_id, "attempts": p.attempts,
            } for p in self._placements.values()]
        path = fleet_obs.write_incident_bundle(
            self.incident_dir, reason=reason, replica_id=replica_id,
            job_id=job_id, trace_id=trace_id, placements=placements,
            replicas=self.registry.snapshot(),
            metrics_text=scrape.get("text", ""),
            flight_events=scrape.get("flight"), trace=trace)
        self.metrics.count("fleet_incidents_total", {"reason": reason})
        if events.active():
            events.emit("fleet_incident", trace_id=trace_id, reason=reason,
                        replica_id=replica_id, job_id=job_id,
                        bundle=path or "")
        return path

    def _refresh_open_placements(self) -> None:
        with self._lock:
            open_now = [p for p in self._placements.values()
                        if p.state == "open"]
        # One wedged replica must not stall every placement's refresh for
        # a timeout each: after the first transport failure to a URL this
        # tick, its remaining placements are skipped (the death countdown
        # and the failover sweep own them from here).
        unreachable_now: set[str] = set()
        for p in open_now:
            rep = self.registry.get(p.base_url)
            if (rep is None or not rep.alive
                    or p.base_url in unreachable_now):
                continue   # the failover sweep owns unreachable replicas
            try:
                manifest = self.client.job(p.base_url, p.replica_job_id)
            except ReplicaRefused as exc:
                if exc.status != 404:
                    continue
                # A 404 right after accept is just spool-visibility lag —
                # but a replica that KEEPS not knowing the job has lost it
                # (restarted with a cleared spool inside the death
                # window): fail the placement terminally instead of
                # leaking its slot and quota forever.
                with self._lock:
                    p.missing_polls += 1
                    gone = p.missing_polls >= MISSING_POLLS_LOST
                if gone:
                    self._mark_terminal(
                        p, "error",
                        error=f"job {p.replica_job_id} vanished from "
                              f"replica {p.replica_id} (restarted with a "
                              "cleared spool?)")
                continue
            except ReplicaUnreachable:
                unreachable_now.add(p.base_url)
                dead = self.registry.note_unreachable(p.base_url)
                if dead is not None:
                    if not self.cfg.quiet:
                        print(f"ict-fleet: replica {dead.replica_id} died "
                              "mid-status-poll", file=sys.stderr)
                    # Every alive->dead flip writes its incident bundle,
                    # whichever path observed it (poll_tick covers the
                    # health-poll flips).
                    self._note_incident(
                        "replica_death",
                        replica_id=dead.replica_id or dead.base_url)
                continue
            with self._lock:
                p.missing_polls = 0
            self._observe_manifest(p, manifest)

    def _failover_sweep(self) -> None:
        """Re-route every open placement whose replica is dead.  Runs on
        the poll thread only; a sweep that cannot place (everyone busy)
        leaves the placement open for the next tick — re-routing is
        idempotent because the replica-side idempotency key rides inside
        the stored payload."""
        with self._lock:
            stranded = [p for p in self._placements.values()
                        if p.state == "open"]
        for p in stranded:
            rep = self.registry.get(p.base_url)
            if rep is not None and rep.alive:
                continue
            from_id = p.replica_id or p.base_url
            try:
                new_rep, body = self._submit_with_failover(
                    p.payload, p.trace_id, exclude={p.base_url})
            except FleetBusy:
                continue           # next tick retries
            except ReplicaRefused as exc:
                # A re-route the fleet *rejected* (e.g. the surviving
                # replicas' --root refuses the path): the job can never
                # complete — surface it as a terminal error instead of
                # sweeping it forever.
                self._mark_terminal(p, "error", error=str(exc))
                continue
            with self._lock:
                p.base_url = new_rep.base_url
                p.replica_id = new_rep.replica_id
                p.replica_job_id = str(body.get("id", p.replica_job_id))
                p.attempts += 1
                p.hops.append({"replica_id": new_rep.replica_id,
                               "base_url": new_rep.base_url,
                               "replica_job_id": p.replica_job_id,
                               "ts": round(time.time(), 6)})
            self.metrics.count("fleet_failovers_total",
                               {"from_replica": from_id})
            self.traces.record(p.trace_id, "fleet_failover",
                               job_id=p.job_id, from_replica=from_id,
                               to_replica=new_rep.replica_id,
                               attempts=p.attempts)
            if events.active():
                events.emit("fleet_failover", trace_id=p.trace_id,
                            job_id=p.job_id, from_replica=from_id,
                            to_replica=new_rep.replica_id,
                            tenant=p.tenant, attempts=p.attempts)
            if not self.cfg.quiet:
                print(f"ict-fleet: job {p.job_id} re-routed "
                      f"{from_id} -> {new_rep.replica_id}", file=sys.stderr)
            # The failover incident carries the stitched trace — the
            # dead hop's spans come from the pre-death flight cache.
            self._note_incident("failover", replica_id=from_id,
                                job_id=p.job_id, trace_id=p.trace_id)

    def _update_replica_gauges(self) -> None:
        snap = self.registry.snapshot()
        states = {"alive": 0, "draining": 0, "dead": 0}
        depth: dict[tuple, float] = {}
        buckets: dict[tuple, float] = {}
        for row in snap:
            rid = row["replica_id"] or row["base_url"]
            if not row["alive"]:
                states["dead"] += 1
            elif row["draining"]:
                states["draining"] += 1
            else:
                states["alive"] += 1
            for queue in ("open_jobs", "load_queue_depth",
                          "dispatch_queue_depth", "bucketed_cubes"):
                depth[(("queue", queue), ("replica", rid))] = float(
                    row.get(queue, 0) or 0)
            for bucket, n in row["bucket_queue_depths"].items():
                buckets[(("bucket", str(bucket)), ("replica", rid))] = float(n)
        self.metrics.replace_gauge_family(
            "fleet_replicas",
            {(("state", s),): float(n) for s, n in states.items()})
        self.metrics.replace_gauge_family("fleet_replica_queue_depth", depth)
        self.metrics.replace_gauge_family(
            "fleet_replica_bucket_queue_depth", buckets)
        with self._lock:
            open_n = sum(1 for p in self._placements.values()
                         if p.state == "open")
            queued = len(self._wfq)
        self.metrics.replace_gauge_family(
            "fleet_open_placements", {(): float(open_n)})
        self.metrics.replace_gauge_family(
            "fleet_queued_submissions", {(): float(queued)})

    def _update_capacity(self) -> None:
        """Fold this tick's registry + scrape snapshots into the capacity
        model and republish every ict_fleet_capacity_* /
        ict_fleet_backlog_eta_seconds gauge family whole (fleet/capacity.py
        — the figures every scale decision must be reconstructible
        from)."""
        self.capacity.update(self.registry.snapshot(),
                             self.scrapes.snapshot())
        for family, entries in self.capacity.gauge_families().items():
            self.metrics.replace_gauge_family(family, entries)

    def _update_costs(self) -> None:
        """Fold this tick's scrape cache into the fleet cost view
        (fleet/costs.py) and republish the budget-usage and
        conservation-ratio gauge families whole — the same
        snapshot-then-replace discipline as the capacity model, zero new
        scrape traffic."""
        snap = fleet_costs.fold(self.registry.snapshot(),
                                self.scrapes.snapshot(),
                                self.cfg.tenant_budgets)
        with self._lock:
            self._costs_snapshot = snap
        for family, entries in fleet_costs.gauge_families(
                snap, self.cfg.tenant_budgets).items():
            self.metrics.replace_gauge_family(family, entries)

    def _campaign_tick(self) -> None:
        """Advance every open campaign (observe placed archives, submit
        pending ones under their pinned idempotency keys, finish settled
        campaigns — campaign/orchestrator.py) and republish the
        ``ict_campaign_*`` gauge families whole, the capacity/cost
        snapshot-then-replace discipline.  Runs right after the cost
        fold so a tick that completes an archive also sees its
        CostRecord land in the same pass."""
        self.campaigns.tick()
        for family, entries in self.campaigns.gauge_families().items():
            self.metrics.replace_gauge_family(family, entries)

    def _slo_tick(self) -> None:
        """One tick of the SLI/error-budget plane (fleet/slo.py): fold
        the grant-wait counters into the derived ``admission``
        journey, kick a canary probe round when the --canary_ticks
        cadence says so (on the prober's own thread — the poll loop
        never blocks on a probe), close the ledger tick, and republish
        every ``ict_sli_*`` gauge family whole (the capacity/cost
        snapshot-then-replace discipline).  Runs BEFORE the autoscale
        tick so this tick's budget state is the signal the scaler
        reads."""
        # Good events for the admission journey are the admissions the
        # router granted (synthetic probes skip admission entirely, so
        # canary traffic can never move this SLI); bad events are the
        # grant-wait burns.
        self.slo.note_admission(
            burned_total=self.metrics.counter_total("fleet_slo_burn_total"),
            placed_total=self.metrics.counter_total(
                "fleet_tenant_admissions_total"))
        if self.cfg.canary_ticks > 0:
            with self._lock:
                self._ticks_to_canary -= 1
                fire = self._ticks_to_canary <= 0
                if fire:
                    self._ticks_to_canary = self.cfg.canary_ticks
            if fire:
                self.canary.maybe_start()
        self.slo.end_tick()
        for family, entries in self.slo.gauge_families().items():
            self.metrics.replace_gauge_family(family, entries)

    def _canary_mismatch(self, verdict: dict) -> None:
        """A canary probe observed a mask that is NOT bit-identical to
        the stored oracle answer — the one correctness signal the fleet
        exists to protect.  Full incident bundle, the audit-divergence
        discipline."""
        self._note_incident("canary_mask_mismatch",
                            job_id=str(verdict.get("job_id", "") or ""),
                            trace_id=str(verdict.get("trace_id", "") or ""))
        if not self.cfg.quiet:
            print(f"ict-fleet: CANARY mask mismatch on journey "
                  f"{verdict.get('journey')!r} "
                  f"(trace {verdict.get('trace_id') or '-'})",
                  file=sys.stderr)

    def _autoscale_tick(self) -> None:
        """The control loop's acting half: reap finished drains, ask the
        Autoscaler for this tick's verdict, and (in act mode) execute it
        — spawn on the supervisor's full-jitter ladder (on its OWN
        thread: a slow or failing spawn must not stall health polling,
        failover sweeps, or grant refresh — the one-wedged-replica
        discipline applies to spawns too), or drain-then-stop the
        least-loaded managed replica.  Every decision, advised, acted,
        or un-executable, is counted
        (fleet_scale_events_total{direction,reason}), event-logged,
        flight-ringed, and written as an incident-style decision
        bundle."""
        if self.autoscaler is None:
            return
        for rec in self.supervisor.reap_drained():
            # Drain-then-stop completed: the replica finished its
            # accepted work and left the fleet — scrub its scrape,
            # straggler, and health-watch state so the gauges don't
            # carry a ghost.  Those caches key on the id the replica
            # ADVERTISED, which need not equal the managed id.
            rid = rec["replica_id"]
            self.scrapes.forget(rid)
            self.straggler.forget(rid)
            self.alerts.forget(rid)
            with self._lock:
                self._health_seen.pop(rid, None)
            if events.active():
                events.emit("fleet_scale_down_complete", replica_id=rid,
                            managed_id=rec["managed_id"])
            flight.note("fleet_scale_down_complete", replica_id=rid,
                        managed_id=rec["managed_id"])
            if not self.cfg.quiet:
                print(f"ict-fleet: managed replica {rid} drained and "
                      "stopped", file=sys.stderr)
        with self._lock:
            if self._scale_in_flight:
                return   # one lifecycle action at a time: no new verdict
                # while a spawn thread runs (its outcome changes `alive`)
        snap = self.registry.snapshot()
        alive = sum(1 for r in snap if r["alive"] and not r["draining"])
        decision = self.autoscaler.tick(
            self.capacity.snapshot(), alive=alive,
            managed_up=len(self.supervisor.up_ids()),
            slo_burn_total=self.metrics.counter_total(
                "fleet_slo_burn_total"),
            stragglers=len(self.straggler.stragglers()),
            slo_budget_remaining=self.slo.min_budget_remaining())
        if decision is None:
            return
        direction, reason = decision["direction"], decision["reason"]
        # The decision exists from this point on, whatever its outcome:
        # counted first, so the counter can never miss one.
        self.metrics.count("fleet_scale_events_total",
                           {"direction": direction, "reason": reason})
        if self.cfg.autoscale != "act":
            self._record_scale_outcome(decision, "fleet_scale_advised",
                                       acted=False)
            return
        if direction == "up":
            with self._lock:
                self._scale_in_flight = True
            # Daemonic and deliberately NOT in self._threads: stop()
            # must not wait out a 60 s spawn; a spawn that completes
            # after stop() is unwound inside _execute_scale_up.
            threading.Thread(
                target=self._execute_scale_up, args=(decision,),
                daemon=True,
                name=f"ict-fleet-scale-{self.router_id}").start()
            return
        # direction == "down": one bounded HTTP call (replica_timeout_s),
        # fine on the poll thread; the drain itself completes over later
        # ticks (reap_drained above).
        victim = self._pick_scale_down_victim()
        veto = self._canary_scale_veto(victim) if victim else ""
        if veto:
            # Budget state as an autoscaler input: a failing
            # canary journey means users may already be getting wrong or
            # no answers — shrinking the last replica warm for the
            # canary bucket would destroy the capacity serving the very
            # journey that is failing.  The decision is consumed (the
            # Autoscaler armed its cooldown), so it must stay visible:
            # recorded as vetoed, never silently dropped.
            decision["error"] = veto
            self._record_scale_outcome(decision, "fleet_scale_vetoed",
                                       acted=False)
            return
        if not victim or not self.supervisor.begin_drain(victim):
            # Un-executable down decision (nothing drainable, or the
            # drain call failed).  The Autoscaler already consumed the
            # decision — cooldown armed, streaks reset — so it must NOT
            # vanish from the telemetry: record it as failed.
            decision["error"] = ("no drainable managed replica"
                                 if not victim else
                                 f"drain of {victim} refused/unreachable")
            self._record_scale_outcome(decision, "fleet_scale_failed",
                                       acted=False)
            return
        decision["replica_id"] = victim
        if events.active():
            events.emit("fleet_drain_requested", replica_id=victim,
                        drain=True, initiator="autoscaler")
        flight.note("fleet_drain_requested", replica_id=victim,
                    drain=True, initiator="autoscaler")
        self.registry.poll_once(self.client)
        self._record_scale_outcome(decision, "fleet_scale_down",
                                   acted=True)

    def _execute_scale_up(self, decision: dict) -> None:
        """The spawn half of an acted scale-up, off the poll thread.
        While it runs, `_scale_in_flight` parks further verdicts (the
        fleet's size is in motion); the poll loop itself keeps running —
        health, failover, capacity all stay live behind a slow spawn."""
        try:
            try:
                handle = self.supervisor.spawn_replica()
            except fleet_autoscale.SpawnFailed as exc:
                # Every failed attempt was already counted under
                # reason="spawn_failed"; the giving-up is recorded too.
                decision["error"] = str(exc)
                self._record_scale_outcome(decision, "fleet_scale_failed",
                                           acted=False)
                return
            if self._stop_evt.is_set():
                # The router stopped while the spawn was in flight:
                # unwind rather than leak a replica nobody supervises.
                handle.stop()
                self.registry.remove(handle.base_url)
                return
            decision["replica_id"] = handle.replica_id
            # The new replica joins the registry now; poll it immediately
            # so it is placeable on the next decision, not the one after.
            self.registry.poll_once(self.client)
            self._record_scale_outcome(decision, "fleet_scale_up",
                                       acted=True)
        finally:
            with self._lock:
                self._scale_in_flight = False

    def _record_scale_outcome(self, decision: dict, event: str,
                              acted: bool) -> None:
        """The explainability tail every decision gets: event log +
        flight ring + stderr + the incident-style decision bundle."""
        replica_id = decision.get("replica_id", "")
        if events.active():
            events.emit(event, direction=decision["direction"],
                        reason=decision["reason"], replica_id=replica_id,
                        error=decision.get("error", ""),
                        signals=decision.get("signals", {}))
        flight.note(event, direction=decision["direction"],
                    reason=decision["reason"], replica_id=replica_id)
        if not self.cfg.quiet:
            verb = ("scaling" if acted else
                    "advising scale" if event == "fleet_scale_advised"
                    else "FAILED scaling")
            print(f"ict-fleet: {verb} {decision['direction']} "
                  f"(reason: {decision['reason']}"
                  f"{'; replica ' + replica_id if replica_id else ''}"
                  f"{'; ' + decision['error'] if decision.get('error') else ''})",
                  file=sys.stderr)
        # The decision bundle: the write_incident_bundle discipline
        # applied to scale decisions — the signals that fired it ride in
        # the manifest, the capacity gauges in metrics.prom.  Bundle
        # reason mirrors the event: scale_up / scale_down /
        # scale_advised / scale_failed.
        self._note_scale_bundle(decision, event[len("fleet_"):])

    def _canary_scale_veto(self, victim: str) -> str:
        """The scale-down veto: with any canary journey
        failing, refuse to drain the LAST replica serving the canary
        shape bucket — removing it would take down the only capacity the
        failing journey still routes to.  Returns the veto reason, or ""
        to let the drain proceed.  ``victim`` is the supervisor's
        managed id; the registry speaks base URLs, so the check maps
        through ``up_urls``."""
        failing = self.slo.failing_journeys()
        if not failing:
            return ""
        by_managed = {mid: url
                      for url, mid in self.supervisor.up_urls().items()}
        victim_url = by_managed.get(victim, "")
        bucket = bucket_label(fleet_canary.CANARY_SHAPE)
        others_warm = [
            rep for rep in self.registry.candidates()
            if rep.base_url != victim_url
            # A numpy replica has no executables to warm — it serves any
            # bucket at full speed immediately, so it always counts.
            and (rep.health.get("backend") == "numpy"
                 or bucket in rep.warm_buckets()
                 or rep.queued_buckets().get(bucket, 0) > 0)]
        if others_warm:
            return ""
        return (f"scale-down vetoed: canary journey(s) "
                f"{', '.join(sorted(failing))} failing and no other "
                f"replica serves the canary bucket {bucket!r}")

    def _pick_scale_down_victim(self) -> str:
        """The least-loaded managed-up replica — never a statically
        configured one (operators own those), never the last replica.
        Matched by base URL (the supervisor's identity), not by the
        replica's self-reported id, which any --replica_id can set."""
        managed = self.supervisor.up_urls()
        if not managed:
            return ""
        cands = [(rep.load(), managed[rep.base_url])
                 for rep in self.registry.candidates()
                 if rep.base_url in managed]
        return min(cands)[1] if cands else ""

    def _note_scale_bundle(self, decision: dict, reason: str) -> None:
        """One incident-style decision bundle per scale decision: the
        manifest carries the decision + its input signals, metrics.prom
        the router's own exposition (the capacity gauges included), so
        the decision replays from the exported figures alone."""
        with self._lock:
            placements = [{
                "job_id": p.job_id, "tenant": p.tenant,
                "trace_id": p.trace_id, "state": p.state,
                "replica_id": p.replica_id, "attempts": p.attempts,
            } for p in self._placements.values()]
        path = fleet_obs.write_incident_bundle(
            self.incident_dir, reason=reason,
            replica_id=decision.get("replica_id", ""),
            placements=placements, replicas=self.registry.snapshot(),
            metrics_text=self.metrics.render(),
            flight_events=None,
            trace={"decision": decision,
                   "capacity": self.capacity.snapshot(),
                   "autoscale": self.autoscaler.state()})
        self.metrics.count("fleet_incidents_total", {"reason": reason})
        if events.active():
            events.emit("fleet_incident", reason=reason,
                        replica_id=decision.get("replica_id", ""),
                        bundle=path or "")

    def _history_alert_tick(self) -> None:
        """One tick of the alerting plane: append the CURRENT federated
        exposition (router registry + cached per-replica series + merged
        families — the exact ``GET /fleet/metrics`` body, built from the
        snapshots this tick already took, so alert evaluation never adds
        scrape traffic) to the history ring, evaluate every rule over the
        ring, and fan out each transition — counter, gauge, event log,
        flight ring, on-disk bundle (firings), webhook/command sinks.

        The render-then-parse round trip is deliberate, not an
        oversight: it guarantees the history records EXACTLY what a
        scraper of ``GET /fleet/metrics`` would parse (same family
        grouping, same collision semantics, one grammar implementation)
        at the cost of re-tokenizing one exposition per tick — a few ms
        at fleet scale, on the poll thread's 1 s cadence."""
        families = obs_metrics.parse_exposition(self.fleet_metrics())
        rec = self.history.append(families)
        # The trend plane folds the SAME parsed tick in (zero extra
        # parse work) and republishes the regression gauge; like
        # fleet_alerts_firing below, that gauge lands in the NEXT
        # tick's history record, which is exactly when the
        # perf_regression rule evaluates it.
        self._trend_tick(families, rec["ts"])
        verdict = self.alerts.evaluate(self.history)
        for alert in verdict["fired"]:
            self.metrics.count("fleet_alerts_total",
                               {"rule": alert["rule"],
                                "severity": alert["severity"]})
            if events.active():
                events.emit("fleet_alert_firing", rule=alert["rule"],
                            severity=alert["severity"],
                            labels=alert["labels"], value=alert["value"])
            flight.note("fleet_alert_firing", rule=alert["rule"],
                        severity=alert["severity"], labels=alert["labels"])
            # The firing bundle: the rule, the evaluated samples, and the
            # history window that fired it — reconstructible from disk.
            window = int(alert["predicate"].get("window", 1)) + 1
            rule = next((r for r in self.alerts.rules
                         if r.name == alert["rule"]), None)
            bundle = fleet_alerts.write_alert_bundle(
                self.alert_dir, alert=alert,
                rule=rule.to_json() if rule else {},
                window=self.history.to_json(ticks=window)["ticks"])
            if not self.cfg.quiet:
                print(f"ict-fleet: ALERT {alert['severity']} "
                      f"{alert['rule']} firing "
                      f"({alert['labels'] or 'fleet'}; "
                      f"value {alert['value']}"
                      f"{'; bundle ' + bundle if bundle else ''})",
                      file=sys.stderr)
            self.alert_sinks.notify(alert)
        for alert in verdict["resolved"]:
            if events.active():
                events.emit("fleet_alert_resolved", rule=alert["rule"],
                            severity=alert["severity"],
                            labels=alert["labels"], value=alert["value"])
            flight.note("fleet_alert_resolved", rule=alert["rule"],
                        severity=alert["severity"], labels=alert["labels"])
            if not self.cfg.quiet:
                print(f"ict-fleet: alert {alert['rule']} resolved "
                      f"({alert['labels'] or 'fleet'})", file=sys.stderr)
            self.alert_sinks.notify(alert)
        # Firing gauge: rebuilt whole per tick (resolution reads as 0,
        # not absence).  It lands in the NEXT tick's history record —
        # the gauge describes the ring, so it cannot also be inside the
        # tick it describes.
        self.metrics.replace_gauge_family(
            "fleet_alerts_firing",
            {(("rule", name),): float(n)
             for name, n in self.alerts.firing_counts().items()})

    def _trend_tick(self, families: list, ts: float) -> None:
        """One tick of the trend plane (fleet/trends.py): fold the
        already-parsed exposition into the multi-resolution store,
        evaluate due fingerprint windows, republish the
        ``ict_fleet_perf_regression`` gauge (every ever-fired key stays
        present at 0 — the alert engine freezes on missing series), and
        fan each sentinel transition out: counter, event log, flight
        ring, and — for firings — a trend incident bundle carrying the
        offending window, the violated fingerprint, and the bench
        baseline cross-check where the signal is machine-independent."""
        if self.trends is None:
            return
        out = self.trends.tick(families, ts)
        self.metrics.count("fleet_trend_ticks_total")
        for res_label, sealed in out["rollups"].items():
            if sealed:
                self.metrics.count("fleet_trend_rollups_total",
                                   {"resolution": res_label},
                                   inc=float(sealed))
        self.metrics.set_gauge("fleet_trend_series", None,
                               float(self.trends.store.series_count()))
        pstats = self.trends.persist_stats()
        with self._lock:
            prev = self._trend_persist_seen
            self._trend_persist_seen = dict(pstats)
            deltas = {k: pstats[k] - prev.get(k, 0) for k in pstats}
        for fam, key in (("fleet_trend_persist_total", "persist_total"),
                         ("fleet_trend_persist_errors_total",
                          "persist_errors")):
            if deltas.get(key, 0) > 0:
                self.metrics.count(fam, inc=float(deltas[key]))
        self.metrics.replace_gauge_family("fleet_perf_regression",
                                          out["gauge"])
        for firing in out["fired"]:
            self.metrics.count("fleet_perf_regressions_total")
            bundle = fleet_trends.write_trend_bundle(
                self.trends.bundle_dir,
                firing={k: firing[k] for k in ("signal", "labels",
                                               "value", "band", "center",
                                               "streak", "spec")},
                fingerprint=firing["fingerprint"],
                window=firing.get("window") or [],
                baseline_check=firing.get("baseline_check"))
            if events.active():
                events.emit("fleet_perf_regression",
                            signal=firing["signal"],
                            labels=firing["labels"],
                            value=firing["value"], band=firing["band"])
            flight.note("fleet_perf_regression", signal=firing["signal"],
                        labels=firing["labels"], value=firing["value"])
            if not self.cfg.quiet:
                print(f"ict-fleet: PERF REGRESSION {firing['signal']} "
                      f"({firing['labels'] or 'fleet'}; value "
                      f"{firing['value']:.4g} outside {firing['band']}"
                      f"{'; bundle ' + bundle if bundle else ''})",
                      file=sys.stderr)
        for rec2 in out["resolved"]:
            if events.active():
                events.emit("fleet_perf_regression_resolved",
                            signal=rec2["signal"], labels=rec2["labels"],
                            value=rec2["value"])
            flight.note("fleet_perf_regression_resolved",
                        signal=rec2["signal"], labels=rec2["labels"])
            if not self.cfg.quiet:
                print(f"ict-fleet: perf regression {rec2['signal']} "
                      f"recovered ({rec2['labels'] or 'fleet'})",
                      file=sys.stderr)

    def _trim_placements(self) -> None:
        """Bound the placement table by evicting the oldest TERMINAL
        records beyond ``placement_keep`` (job ids are time-sortable, the
        spool-trim rationale) — open placements are never touched."""
        with self._lock:
            terminal = sorted(jid for jid, p in self._placements.items()
                              if p.state != "open")
            for jid in terminal[: max(0, len(terminal)
                                      - self.cfg.placement_keep)]:
                del self._placements[jid]
            # The idempotency index follows the placement table: an entry
            # whose placement was trimmed can no longer dedupe (in-flight
            # "" reservations are owned by their placing thread).
            for key in [k for k, jid in self._idem_index.items()
                        if jid and jid not in self._placements]:
                del self._idem_index[key]

    # --- placement ---

    def place_job(self, payload: dict, tenant: str, trace_id: str) -> dict:
        """Admit + grant + place one submission; returns the 202 body.
        Raises QuotaExceeded (-> 429), FleetBusy (-> 503), ReplicaRefused
        (the replica's own 4xx passes through)."""
        # The tenant is stamped INTO the payload here, authoritatively —
        # not just by the HTTP handler — so every in-process caller (the
        # campaign orchestrator) and every failover re-route of this
        # payload carries the same identity the admission ledger and the
        # cost showback charged; a payload already stamped (a retried
        # submission) keeps its tenant rather than silently rebranding
        # to the default.
        tenant = str(tenant or payload.get("tenant", "") or DEFAULT_TENANT)
        # Synthetic canary traffic (fleet/canary.py) is normalized HERE,
        # authoritatively: the flag and the reserved tenant imply each
        # other, so every downstream exclusion (admission, WFQ grant,
        # capacity demand, cost showback, cache-salt scoping) keys on one
        # consistent identity however the probe entered (direct POST, a
        # synthetic campaign's orchestrator placement, a failover
        # re-route of either).
        if payload.get("synthetic") or tenant == SYNTHETIC_TENANT:
            payload["synthetic"] = True
            tenant = SYNTHETIC_TENANT
        payload["tenant"] = tenant
        key = str(payload.get("idempotency_key", "") or "")
        known = self._resolve_idem(key)
        if known is not None:
            return known
        try:
            cached = self._resolve_cached(payload, tenant, trace_id, key)
            if cached is not None:
                return cached
            return self._place_fresh(payload, tenant, trace_id, key)
        except BaseException:
            self._drop_idem_reservation(key)
            raise

    def _resolve_idem(self, key: str) -> dict | None:
        """Router-side idempotency: a key this router already placed
        resolves to its existing fleet job (whatever replica serves it
        now) instead of running again — the replica-side map only covers
        retries that happen to land on the same replica.  Returns the
        reply to serve, or None after reserving the key for a fresh
        placement (the caller owns the reservation)."""
        if not key:
            return None
        with self._lock:
            known = self._idem_index.get(key)
            if known is None:
                self._idem_index[key] = ""   # reservation: we place it
                return None
        if known == "":
            # Another handler thread is mid-placement on this key; a 503
            # tells the client to retry into the resolved entry.
            raise FleetBusy(f"a submission with idempotency key {key!r} "
                            "is being placed; retry shortly")
        code, manifest = self.job_manifest(known)
        if code == 200:
            self.metrics.count("fleet_deduped_submissions_total")
            return {**manifest, "router_id": self.router_id}
        # The placement was trimmed from the table: place afresh.
        with self._lock:
            self._idem_index[key] = ""
        return None

    def _drop_idem_reservation(self, key: str) -> None:
        with self._lock:
            if key and self._idem_index.get(key) == "":
                del self._idem_index[key]

    def _resolve_cached(self, payload: dict, tenant: str, trace_id: str,
                        key: str) -> dict | None:
        """Fleet-wide content-addressed reuse, checked at placement time
        (fleet/cache.py): hash the submitted file's bytes and, when every
        alive candidate replica advertises the same config/version salt,
        answer a recorded byte-identical submission with its finished
        result — a fleet job born terminal.  No quota, no WFQ grant, no
        placement, and deliberately NO demand counted toward the
        capacity model: a cache hit consumes no fleet capacity.  Returns
        the 202 body to serve, or None to place normally."""
        if payload.get("audit") or payload.get("profile"):
            # An explicit per-job audit (shadow-oracle replay) or
            # profiler capture needs a replica: answering from the cache
            # would silently skip the very check the submitter asked for
            # (the replica-side tier honors audit-on-hit; the router
            # tier cannot).
            self.metrics.count("fleet_cache_skips_total",
                               {"reason": "per_job_flags"})
            return None
        if len(self.result_index) == 0:
            return None       # cold index: don't pay the file hash
        try:
            size = os.path.getsize(str(payload.get("path", "") or ""))
        except OSError:
            return None
        if size > _fleet_cache_max_bytes():
            # Bound the placement-path I/O: hashing runs synchronously in
            # the HTTP handler, and a campaign of huge unique archives
            # would pay a full extra file read per submission for mostly
            # misses.  The reuse tier targets small-cube campaign
            # traffic; big cubes place normally.
            self.metrics.count("fleet_cache_skips_total",
                               {"reason": "file_too_large"})
            return None
        salt = fleet_cache.unanimous_salt(self.registry.snapshot())
        if not salt:
            # Mixed-salt fleet (mid-rollout) or nobody advertises one:
            # never guess which config would have served the job.
            self.metrics.count("fleet_cache_skips_total",
                               {"reason": "no_unanimous_salt"})
            return None
        if payload.get("synthetic"):
            # Canary probes live in their own salt scope (the recording
            # half suffixes identically): a probe can hit entries other
            # probes learned — the cache journey NEEDS that — but can
            # never be served a real tenant's entry nor seed one real
            # traffic would reuse.
            salt = salt + "|synthetic"
        from iterative_cleaner_tpu_torch.ingest import cas

        digest = cas.file_digest(str(payload.get("path", "") or ""))
        if not digest:
            return None
        entry = self.result_index.lookup(digest, salt)
        if entry is None:
            self.metrics.count("fleet_cache_misses_total")
            return None
        if not entry.get("out_path") or not os.path.exists(
                entry["out_path"]):
            # The recorded output no longer exists (operator archived or
            # swept the cleaned files; the index outlives them): place
            # normally so the submission regenerates its output — a
            # born-terminal manifest pointing at a dead path would be a
            # lie.  The replica-side cache tier still spares the device
            # work and writes a fresh output for THIS path.
            self.metrics.count("fleet_cache_skips_total",
                               {"reason": "output_missing"})
            return None
        origin = entry.pop("origin")
        # Time-sortable like replica-minted job ids ('{ms:013d}-{hex}'):
        # _trim_placements evicts the lexically-smallest terminal ids,
        # and an unsortable prefix would let stale cache stubs outlive
        # (and crowd out) recent real placements.
        job_id = f"{int(time.time() * 1000):013d}-fc{uuid.uuid4().hex[:6]}"
        manifest = {**entry, "path": str(payload.get("path", "") or ""),
                    "served_by": "fleet-cache", "origin": origin}
        # The served manifest's cost record is the HIT's (zero device
        # time, the origin's figures as avoided cost) — not the origin's
        # own record, which stays under its own job id.
        origin_cost = entry.get("cost") or {}
        manifest["cost"] = {
            "tenant": tenant, "route": "fleet-cache", "cache_hit": True,
            "device_s": 0.0, "compile_s": 0.0,
            "avoided_device_s": float(origin_cost.get("device_s", 0.0)
                                      or 0.0),
            "avoided_bytes_accessed": float(
                origin_cost.get("bytes_accessed", 0.0) or 0.0),
        }
        placement = Placement(
            job_id=job_id, tenant=tenant, trace_id=trace_id,
            payload=payload, base_url="",
            replica_id=origin.get("replica_id", ""),
            replica_job_id=origin.get("job_id", ""), state="done",
            submitted_s=time.time(), cached=manifest,
            synthetic=bool(payload.get("synthetic")))
        with self._lock:
            self._placements[job_id] = placement
            if key:
                self._idem_index[key] = job_id
        self.metrics.count("fleet_cache_hits_total")
        # Cube bytes that never moved because of this hit (f32 cube of
        # the recorded shape) — the campaign-dedupe savings figure.
        shape = entry.get("shape") or []
        if shape:
            nbytes = 4.0
            for dim in shape:
                nbytes *= float(dim)
            self.metrics.count("fleet_cache_bytes_saved_total",
                               inc=nbytes)
        # Avoided cost, attributed to the SUBMITTING tenant with the
        # origin job's recorded figures (obs/costs.py's cache-hit rule,
        # router tier): the manifest the index learned carries the
        # origin's CostRecord.
        self.metrics.count("fleet_cost_cache_avoided_seconds_total",
                           {"tenant": tenant},
                           inc=float(origin_cost.get("device_s", 0.0)
                                     or 0.0))
        # Born-terminal placements get a COMPLETE trace (submit →
        # fleet_cache_hit → done): there is no replica hop to walk, so
        # the stitcher serves these router spans alone — never an
        # "unavailable" hop probe at the long-gone origin replica.
        self.traces.record(trace_id, "fleet_submit", job_id=job_id,
                           tenant=tenant)
        self.traces.record(trace_id, "fleet_cache_hit", job_id=job_id,
                           origin_job_id=origin.get("job_id", ""),
                           replica_id=origin.get("replica_id", ""),
                           tenant=tenant)
        self.traces.record(trace_id, "fleet_done", job_id=job_id,
                           served_by="fleet-cache")
        if events.active():
            # path/idem_key/shape ride along so a cache-served submission
            # (which never reaches a replica's job_submitted) is still
            # replayable from the event log (proving/traces.py).
            events.emit("fleet_cache_hit", trace_id=trace_id,
                        job_id=job_id,
                        origin_job_id=origin.get("job_id", ""),
                        replica_id=origin.get("replica_id", ""),
                        tenant=tenant,
                        path=str(payload.get("path", "") or ""),
                        idem_key=key,
                        shape=[int(v) for v in shape],
                        cache_salt=salt)
        # Recorder hook, cache half: a born-terminal hit never reaches a
        # replica's job_submitted, so this is its ONLY tape entry
        # (entry="cache", the grammar's cache-served marker).
        self.recorder.record(
            path=str(payload.get("path", "") or ""), tenant=tenant,
            idem_key=key, shape=tuple(shape), bucket=self._bucket_of(payload),
            salt=salt, trace_id=trace_id, entry="cache",
            synthetic=bool(payload.get("synthetic")))
        # Deliberately NOT counted in fleet_jobs_completed_total: that
        # counter is the exactly-once ledger of placements the fleet
        # actually ran, and the smoke/tests pin it against replica-side
        # completions; reuse has its own hit/byte counters.
        return {**manifest, "id": job_id, "state": "done",
                "tenant": tenant, "trace_id": trace_id,
                "replica_id": origin.get("replica_id", ""),
                "router_id": self.router_id}

    def _place_fresh(self, payload: dict, tenant: str, trace_id: str,
                     key: str) -> dict:
        synthetic = bool(payload.get("synthetic"))
        # Synthetic canary probes bypass the ENTIRE admission plane:
        # no quota ledger entry, no admissions count (the admission
        # journey's good-event source), no WFQ grant (they must never
        # displace a real tenant's slot) — the terminal transition
        # releases nothing for them (Placement.synthetic, symmetric).
        if not synthetic:
            try:
                self.admission.admit(tenant)
            except QuotaExceeded:
                self.metrics.count("fleet_tenant_rejections_total",
                                   {"tenant": tenant})
                raise
            self.metrics.count("fleet_tenant_admissions_total",
                               {"tenant": tenant})
            try:
                self._await_grant(tenant)
            except BaseException:
                self.admission.release(tenant)
                raise
        try:
            rep, body = self._submit_with_failover(payload, trace_id)
        except BaseException:
            if not synthetic:
                self._release_slot()
                self.admission.release(tenant)
            raise
        placement = Placement(
            job_id=str(body.get("id", "")),
            tenant=tenant, trace_id=trace_id, payload=payload,
            base_url=rep.base_url, replica_id=rep.replica_id,
            replica_job_id=str(body.get("id", "")),
            submitted_s=time.time(), synthetic=synthetic)
        placement.hops.append({"replica_id": rep.replica_id,
                               "base_url": rep.base_url,
                               "replica_job_id": placement.replica_job_id,
                               "ts": round(time.time(), 6)})
        with self._lock:
            existing = self._placements.get(placement.job_id)
            duplicate = existing is not None and existing.state == "open"
            if not duplicate:
                self._placements[placement.job_id] = placement
            if key:
                self._idem_index[key] = placement.job_id
        if duplicate:
            # The replica deduped a client-pinned idempotency key onto a
            # job this router already tracks as OPEN: the original
            # placement keeps the in-flight slot and the quota count, so
            # the retry's admit/grant must be handed back here — silently
            # replacing the record would leak one of each per retry.
            if not synthetic:
                self._release_slot()
                self.admission.release(tenant)
            return {**body, "tenant": tenant, "router_id": self.router_id}
        self.metrics.count("fleet_placements_total",
                           {"replica": rep.replica_id or rep.base_url})
        # Fresh demand only: failover re-routes and idempotent dedupes
        # never reach here, so the capacity model's demand rate counts
        # each submission exactly once.  Synthetic probes count NOTHING:
        # demand the canary itself injected would feed the very
        # autoscaler signal the canary is supposed to measure.
        if not synthetic:
            self.capacity.note_placement(self._bucket_of(payload))
        self.traces.record(trace_id, "fleet_submit", job_id=placement.job_id,
                           tenant=tenant)
        self.traces.record(trace_id, "fleet_placement",
                           job_id=placement.job_id,
                           replica_id=rep.replica_id, tenant=tenant,
                           bucket=self._bucket_of(payload))
        if events.active():
            events.emit("fleet_placement", trace_id=trace_id,
                        job_id=placement.job_id,
                        replica_id=rep.replica_id, tenant=tenant,
                        bucket=self._bucket_of(payload),
                        idem_key=key)
        # The production flight recorder's fresh-placement hook: one
        # entry per real submission, as it happens (synthetic probes are
        # refused inside record(), by construction; failover re-routes
        # and idempotent dedupes never reach here, so each arrival is
        # recorded exactly once — the record_trace dedupe, live).
        self.recorder.record(
            path=str(payload.get("path", "") or ""), tenant=tenant,
            idem_key=key, shape=tuple(payload.get("shape") or ()),
            bucket=self._bucket_of(payload), trace_id=trace_id,
            entry="service", synthetic=synthetic)
        return {**body, "tenant": tenant, "router_id": self.router_id}

    def _await_grant(self, tenant: str) -> None:
        """Weighted-fair wait for an in-flight slot.  With no budget
        configured the grant is immediate; under contention, grants pop
        in WFQ order as slots free (placements observed terminal).  A
        grant wait beyond the per-tenant SLO target (``slo_grant_s``) —
        or a timeout — burns ``fleet_slo_burn_total{tenant}``, the
        admission-path half of the SLO layer (fleet/obs.py)."""
        ticket = _Ticket()
        t0 = time.monotonic()
        deadline = t0 + self.cfg.queue_timeout_s
        try:
            with self._lock:
                self._wfq.push(tenant, ticket)
                self._grant_free_slots()
                while not ticket.granted:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or self._stop_evt.is_set():
                        ticket.abandoned = True
                        raise FleetBusy(
                            f"no placement slot within "
                            f"{self.cfg.queue_timeout_s:g}s "
                            f"({self._inflight} in flight at the "
                            f"--max_inflight budget); retry later")
                    self._cond.wait(remaining)
        except FleetBusy:
            self.metrics.count("fleet_slo_burn_total", {"tenant": tenant})
            raise
        if time.monotonic() - t0 > self.cfg.slo_grant_s:
            self.metrics.count("fleet_slo_burn_total", {"tenant": tenant})

    def _grant_free_slots(self) -> None:
        """Pop WFQ tickets into free in-flight slots and wake their
        waiters.  Takes the (reentrant) placement lock itself, so every
        call site — callers already holding it included — keeps the
        mutation lexically guarded."""
        with self._lock:
            while len(self._wfq) and (
                    not self.cfg.max_inflight
                    or self._inflight < self.cfg.max_inflight):
                popped = self._wfq.pop()
                if popped is None:
                    break
                _tenant, ticket = popped
                if ticket.abandoned:
                    continue
                ticket.granted = True
                self._inflight += 1
            self._cond.notify_all()

    def _release_slot(self) -> None:
        with self._lock:
            self._inflight -= 1
            self._grant_free_slots()

    @staticmethod
    def _bucket_of(payload: dict) -> str:
        shape = payload.get("shape")
        if (isinstance(shape, (list, tuple)) and len(shape) == 3
                and all(isinstance(v, (int, float)) for v in shape)):
            return bucket_label(shape)
        return ""

    def _ranked_candidates(self, bucket: str,
                           exclude: set[str]) -> list[Replica]:
        cands = [r for r in self.registry.candidates()
                 if r.base_url not in exclude]
        flagged = self.straggler.stragglers()

        def score(rep: Replica) -> float:
            s = rep.load()
            if bucket:
                if bucket in rep.warm_buckets():
                    s -= AFFINITY_WARM
                if rep.queued_buckets().get(bucket, 0) > 0:
                    s -= AFFINITY_QUEUED
            # A flagged straggler is de-prioritized, never excluded: a
            # fleet whose every survivor is slow must still place.
            if rep.replica_id in flagged:
                s += STRAGGLER_PENALTY
            return s

        # Deterministic tie-break on replica identity, so tests (and two
        # routers sharing one fleet) rank identically from identical
        # snapshots.
        cands.sort(key=lambda r: (score(r), r.replica_id or r.base_url))
        return cands

    def _submit_with_failover(self, payload: dict, trace_id: str,
                              exclude: set[str] | None = None):
        """Walk the ranked candidates; on transport failure note the
        death countdown and move on; on 503 (busy/draining) move on; on
        any other refusal propagate (the client's problem, not the
        fleet's).  Between sweeps, full-jitter backoff."""
        exclude = set(exclude or ())
        bucket = self._bucket_of(payload)
        last_err: Exception | None = None
        for sweep in range(1 + max(self.cfg.failover_retries, 0)):
            if sweep:
                with self._rng_lock:
                    delay = backoff.full_jitter(
                        self.cfg.retry_backoff_s, sweep - 1,
                        rng=self._backoff_rng)
                time.sleep(delay)
            for rep in self._ranked_candidates(bucket, exclude):
                try:
                    body = self.client.submit(rep.base_url, payload,
                                              trace_id=trace_id)
                except ReplicaUnreachable as exc:
                    last_err = exc
                    dead = self.registry.note_unreachable(rep.base_url)
                    if dead is not None:
                        self._note_incident(
                            "replica_death",
                            replica_id=dead.replica_id or dead.base_url)
                    continue
                except ReplicaRefused as exc:
                    if exc.status == 503:   # at capacity, or draining
                        last_err = exc
                        continue
                    raise
                self.registry.note_placed(rep.base_url)
                return rep, body
        raise FleetBusy(f"no replica accepted the job: "
                        f"{last_err or 'no live replicas'}")

    # --- reads ---

    def placement_snapshot(self, job_id: str) -> dict | None:
        """One placement's routing facts as a plain dict (the explain
        plane's substrate) — copied under the lock, no live references
        escape."""
        with self._lock:
            p = self._placements.get(job_id)
            if p is None:
                return None
            return {
                "job_id": p.job_id, "tenant": p.tenant,
                "trace_id": p.trace_id, "state": p.state,
                "error": p.error, "replica_id": p.replica_id,
                "base_url": p.base_url,
                "replica_job_id": p.replica_job_id,
                "attempts": p.attempts, "submitted_s": p.submitted_s,
                "shape": list(p.payload.get("shape") or []),
                "hops": [dict(h) for h in p.hops],
                "cached": dict(p.cached) if p.cached is not None else None,
                "synthetic": p.synthetic,
            }

    def job_manifest(self, job_id: str) -> tuple[int, dict]:
        with self._lock:
            p = self._placements.get(job_id)
        if p is None:
            return 404, {"error": "no such job"}
        if p.cached is not None:
            # A fleet-cache hit: born terminal, served from the recorded
            # summary — the origin replica may be gone, no proxy call.
            return 200, {**p.cached, "id": p.job_id, "state": p.state,
                         "replica_id": p.replica_id, "tenant": p.tenant,
                         "trace_id": p.trace_id}
        rep = self.registry.get(p.base_url)
        if p.state == "open" and (rep is None or rep.alive):
            try:
                manifest = self.client.job(p.base_url, p.replica_job_id)
            except ReplicaRefused as exc:
                return exc.status, exc.body
            except ReplicaUnreachable:
                dead = self.registry.note_unreachable(p.base_url)
                if dead is not None:
                    self._note_incident(
                        "replica_death",
                        replica_id=dead.replica_id or dead.base_url)
                manifest = None
            if manifest is not None:
                self._observe_manifest(p, manifest)
                return 200, {**manifest, "id": p.job_id,
                             "replica_id": p.replica_id,
                             "tenant": p.tenant}
        if p.state == "open":
            # The replica is unreachable and the failover sweep has not
            # re-placed the job yet: report it still pending so clients
            # keep polling through the hole.
            return 200, {"id": p.job_id, "state": "pending",
                         "replica_id": p.replica_id, "tenant": p.tenant,
                         "trace_id": p.trace_id, "attempts": p.attempts,
                         "detail": "replica unreachable; failover pending"}
        # Terminal and remembered: serve the replica's full manifest when
        # it is KNOWN reachable, the cached summary otherwise — a dead
        # replica (it may stay dead for days) must not cost every read a
        # connection timeout and a pinned handler thread.
        if rep is not None and rep.alive:
            try:
                manifest = self.client.job(p.base_url, p.replica_job_id)
                # Re-record the (idempotent, newest-wins) cache entry:
                # the FIRST done observation can precede the replica's
                # CostRecord finalization (it rides the post-dispatch
                # telemetry pass, seconds late on a bucket's first
                # dispatch), so a later read refreshes the learned
                # entry with the finalized avoided-cost figures.
                if manifest.get("state") == "done":
                    self._cache_record(p, manifest)
                return 200, {**manifest, "id": p.job_id,
                             "replica_id": p.replica_id, "tenant": p.tenant}
            except ReplicaRefused:
                pass
            except ReplicaUnreachable:
                dead = self.registry.note_unreachable(p.base_url)
                if dead is not None:
                    self._note_incident(
                        "replica_death",
                        replica_id=dead.replica_id or dead.base_url)
        return 200, {"id": p.job_id, "state": p.state,
                     "error": p.error or None,
                     "replica_id": p.replica_id, "tenant": p.tenant,
                     "trace_id": p.trace_id, "attempts": p.attempts}

    def _observe_manifest(self, p: Placement, manifest: dict) -> None:
        state = str(manifest.get("state", ""))
        if state in ("done", "error"):
            self._mark_terminal(p, state,
                                error=str(manifest.get("error") or ""))
        if state == "done":
            # The fleet cache's learning half: every DONE manifest that
            # carries its content keys (file_digest + cache_salt, stamped
            # at replica ingest) becomes the recorded answer for the next
            # byte-identical submission — observed here because the
            # status polls already fetch these manifests, zero extra
            # traffic.
            if self._cache_record(p, manifest):
                self.metrics.replace_gauge_family(
                    "fleet_cache_entries",
                    {(): float(len(self.result_index))})

    def _cache_record(self, p: Placement, manifest: dict) -> bool:
        """Record one DONE manifest into the fleet result index, with a
        synthetic placement's entry re-salted into the canary scope
        (``<salt>|synthetic``, the `_resolve_cached` lookup's twin) so
        probe results and real tenants' results can never serve each
        other."""
        if p.synthetic and manifest.get("cache_salt"):
            manifest = {**manifest,
                        "cache_salt": str(manifest["cache_salt"])
                        + "|synthetic"}
        return self.result_index.record(manifest,
                                        origin_replica=p.replica_id)

    def _mark_terminal(self, p: Placement, state: str,
                       error: str = "") -> None:
        """Idempotent terminal transition: the quota and in-flight slot
        are released exactly once however many readers observe it."""
        with self._lock:
            if p.state != "open":
                return
            p.state = state
            p.error = error
            if not p.synthetic:
                self._inflight -= 1
                self._grant_free_slots()
        # A synthetic probe never took a quota entry or an in-flight
        # slot (fleet/canary.py), so there is nothing to hand back —
        # releasing would corrupt the real tenants' accounting.
        if not p.synthetic:
            self.admission.release(p.tenant)
        self.metrics.count("fleet_jobs_completed_total", {"state": state})
        self.traces.record(p.trace_id, f"fleet_{state}", job_id=p.job_id,
                           replica_id=p.replica_id,
                           **({"error": error} if error else {}))

    def fleet_metrics(self) -> str:
        """``GET /fleet/metrics``: the router's own exposition, then every
        cached replica scrape re-labeled ``{replica=...}``, then the
        merged fleet families — all three sections from consistent
        snapshots, so the merged totals equal the per-replica sums they
        sit next to (fleet/obs.py)."""
        snap = self.scrapes.snapshot()
        scrapes = {rid: rec["families"] for rid, rec in snap.items()
                   if rec.get("families")}
        return self.metrics.render() + fleet_obs.federated_exposition(scrapes)

    def fleet_capacity(self) -> dict:
        """``GET /fleet/capacity``: the capacity model's last snapshot
        (fleet figures, per-replica utilization/rates, per-bucket
        backlog/demand/cost/ETA) plus the autoscaler's state — the JSON
        twin of the ict_fleet_capacity_* gauge families.  IEEE specials
        are stringified (``"inf"``) so the reply is STRICT JSON — the
        gauge twin keeps the numeric ``+Inf`` under the exposition
        grammar."""
        snap = _json_safe(self.capacity.snapshot())
        snap.setdefault("fleet", {})
        snap.setdefault("replicas", {})
        snap.setdefault("buckets", {})
        snap["stragglers"] = sorted(self.straggler.stragglers())
        snap["autoscale"] = (self.autoscaler.state()
                             if self.autoscaler is not None else None)
        # Keyed by the replica's ADVERTISED id (joinable against the
        # /healthz rows and the capacity per-replica figures), with the
        # supervisor's managed id alongside — the two id domains need
        # not agree (--replica_id is the daemon's own business).
        managed: dict[str, dict] = {}
        if self.supervisor is not None:
            by_url = {r["base_url"]: (r["replica_id"] or r["base_url"])
                      for r in self.registry.snapshot()}
            for mid, rec in self.supervisor.managed_info().items():
                rid = by_url.get(rec["base_url"], rec["base_url"])
                managed[rid] = {"state": rec["state"], "managed_id": mid}
        snap["managed_replicas"] = managed
        return snap

    def fleet_alerts(self) -> dict:
        """``GET /fleet/alerts``: the firing set, the rule table (with
        per-rule firing-series counts), the recent firing/resolved
        transitions, and the on-disk bundle inventory — strict JSON, the
        ``/fleet/capacity`` IEEE-specials discipline."""
        return _json_safe({
            "firing": self.alerts.firing(),
            "rules": self.alerts.rules_table(),
            "recent": self.alerts.recent(),
            "bundles": fleet_alerts.list_alert_bundles(self.alert_dir),
            "history_ticks": self.history.size(),
            "sinks": {"webhook": bool(self.cfg.alert_webhook),
                      "cmd": bool(self.cfg.alert_cmd)},
        })

    def fleet_costs(self) -> dict:
        """``GET /fleet/costs``: the cost-accounting fold — per-tenant
        showback rows (device-seconds, jobs, compile-seconds, cache
        savings, budget usage), per-bucket device time + attainment,
        per-route split, and per-replica conservation ratios — strict
        JSON, the ``/fleet/capacity`` IEEE-specials discipline."""
        with self._lock:
            snap = dict(self._costs_snapshot)
        return _json_safe({**snap, "router_id": self.router_id,
                           "conservation_tolerance":
                               fleet_costs.CONSERVATION_TOLERANCE})

    def fleet_metrics_history(self, ticks: int | None = None,
                              families: tuple = ()) -> dict:
        """``GET /fleet/metrics/history``: the bounded ring of per-tick
        federated expositions, lossless (each tick's families re-render
        byte-exact).  Sample values are the exposition's raw strings —
        ``+Inf``/``NaN`` spellings included — so the reply stays strict
        JSON with no IEEE specials to stringify.  ``families`` (the
        ``?families=`` comma-separated name-prefix filter) narrows each
        tick to the matching families so trend/alert tooling stops
        shipping the full exposition per tick; the filtered ticks stay
        round-trippable through the same strict grammar."""
        return self.history.to_json(ticks=ticks, families=families)

    def fleet_trends(self, family: str = "", resolution: str = "raw",
                     window: int | None = None) -> dict:
        """``GET /fleet/trends``: the trend plane's fingerprint export,
        firing regressions, bundle inventory, and — with ``?family=`` —
        the ring data at one resolution (fleet/trends.py).  Strict JSON,
        the ``/fleet/capacity`` IEEE-specials discipline."""
        if self.trends is None:
            return {"enabled": False}
        return _json_safe(self.trends.trends_json(
            family=family, resolution=resolution, window=window))

    def _recorder_tick(self) -> None:
        """Republish the recorder's gauge families and delta-feed its
        counter mirrors from the recorder's own totals (counters only
        move forward; the recorder's figures are authoritative)."""
        st = self.recorder.stats()
        with self._lock:
            prev = self._recorder_seen
            self._recorder_seen = {
                k: st[k] for k in ("entries_total", "excluded_total",
                                   "dropped_total", "sealed_total")}
            deltas = {k: st[k] - prev.get(k, 0)
                      for k in self._recorder_seen}
        for fam, key in (
                ("recorder_entries_total", "entries_total"),
                ("recorder_excluded_total", "excluded_total"),
                ("recorder_dropped_total", "dropped_total"),
                ("recorder_segments_sealed_total", "sealed_total")):
            if deltas.get(key, 0) > 0:
                self.metrics.count(fam, inc=float(deltas[key]))
        self.metrics.set_gauge("recorder_enabled", None,
                               1.0 if st["enabled"] else 0.0)
        self.metrics.set_gauge("recorder_segments", None,
                               float(st["segments"]))
        self.metrics.set_gauge("recorder_segment_bytes", None,
                               float(st["segment_bytes"]))
        self.metrics.set_gauge("recorder_open_entries", None,
                               float(st["open_entries"]))

    def fleet_traces(self, segment: str = "",
                     t_start: float | None = None,
                     t_end: float | None = None) -> tuple[int, dict]:
        """``GET /fleet/traces``: the recorder's sealed-segment inventory
        (+ live stats), or — with ``?segment=`` / ``?t0=&t1=`` — one
        windowed export as a replayable trace document (``trace`` is the
        JSON-line list: write each element as one line and the file
        loads through ``proving.traces.load_trace`` unchanged)."""
        if segment or t_start is not None or t_end is not None:
            try:
                doc = self.recorder.export(segment=segment,
                                           t_start=t_start, t_end=t_end)
            except KeyError:
                return 404, {"error": f"no sealed segment {segment!r}"}
            return 200, {"router_id": self.router_id, "trace": doc}
        return 200, {"router_id": self.router_id,
                     "directory": self.recorder.out_dir,
                     "recorder": self.recorder.stats(),
                     "segments": self.recorder.segments()}

    def fleet_explain_job(self, job_id: str) -> tuple[int, dict]:
        """``GET /fleet/explain/<job_id>``: the seven-plane causal
        report for one job (fleet/explain.py) — trace, cost/roofline,
        zap attribution, audit verdict, quality, cache/coalesce
        disposition, SLO journeys — each stamped with live/spool/
        unavailable provenance.  Strict JSON (the /fleet/capacity
        IEEE-specials discipline: SLO quantiles can be infinite)."""
        code, report = fleet_explain.explain_job(self, job_id)
        return code, _json_safe(report)

    def fleet_trace(self, trace_id: str) -> tuple[int, dict]:
        """``GET /fleet/trace/<id>``: one stitched cross-hop timeline.

        Router spans (submit/placement/failover/terminal) interleave with
        each hop's replica-side spans: a live hop's come from its
        persisted ``GET /jobs/<id>/trace``; a dead hop's from the
        pre-death flight-ring cache (filtered to this trace id)."""
        router_spans = self.traces.spans(trace_id)
        job_id = self.traces.job_for(trace_id)
        with self._lock:
            p = self._placements.get(job_id) if job_id else None
            if p is None:
                # The span store may have evicted an old trace the
                # placement table still remembers (or vice versa).
                p = next((q for q in self._placements.values()
                          if q.trace_id == trace_id), None)
            if p is not None:
                job_id = p.job_id
                state = p.state
                hops = [dict(h) for h in p.hops]
            else:
                state, hops = "", []
        if not router_spans and p is None:
            return 404, {"error": f"no trace {trace_id!r} in the span "
                                  "store or the placement table"}
        sources: dict[str, str] = {}
        hop_spans: dict[str, list[dict]] = {}
        for hop in hops:
            rid = hop["replica_id"] or hop["base_url"]
            rep = self.registry.get(hop["base_url"])
            if rep is not None and rep.alive:
                try:
                    tr = self.client.job_trace(hop["base_url"],
                                               hop["replica_job_id"])
                except (ReplicaUnreachable, ReplicaRefused):
                    pass
                else:
                    spans = [{"source": rid, "event": "replica_job",
                              "state": tr.get("state"),
                              "served_by": tr.get("served_by"),
                              "loops": tr.get("loops"),
                              "termination": tr.get("termination")}]
                    spans += [{"source": rid, "event": "iteration", **rec}
                              for rec in tr.get("timeline", [])]
                    hop_spans[rid] = spans
                    sources[rid] = "live"
            if rid not in hop_spans:
                # The dead-hop path: whatever of this trace the poll
                # loop's flight-ring cache caught before the replica died.
                cached = [{"source": rid, **rec}
                          for rec in self.scrapes.flight_events(rid)
                          if rec.get("trace_id") == trace_id]
                if cached:
                    hop_spans[rid] = cached
                    sources[rid] = "flight-cache"
                else:
                    hop_spans[rid] = [{"source": rid,
                                       "event": "replica_trace_unavailable"}]
                    sources[rid] = "unavailable"
        stitched: list[dict] = []
        for span in sorted(router_spans, key=lambda s: s.get("ts", 0.0)):
            stitched.append(span)
            rid = span.get("to_replica") or span.get("replica_id") or ""
            if (span.get("event") in ("fleet_placement", "fleet_failover")
                    and rid in hop_spans):
                stitched.extend(hop_spans.pop(rid))
        for leftovers in hop_spans.values():
            stitched.extend(leftovers)
        return 200, {"trace_id": trace_id, "job_id": job_id,
                     "state": state, "hops": hops, "sources": sources,
                     "spans": stitched}

    # --- the streaming-session proxy (the canary session journey's
    # substrate, and a real user path: one front door for streams too) ---

    #: Bound on remembered session routes (FIFO eviction) — an abandoned
    #: session must not grow the map forever.
    SESSION_ROUTES_KEEP = 1024

    def session_open(self, body: dict) -> tuple[int, dict]:
        """``POST /sessions``: place a streaming session on the
        least-loaded candidate and remember the route (session id ->
        replica) for its blocks/finish/status calls.  Sessions pin to
        ONE replica for their whole life — a stream's state lives in
        that replica's OnlineSession; there is no failover re-route."""
        cands = self._ranked_candidates("", set())
        if not cands:
            return 503, {"error": "no live replica to host the session"}
        rep = cands[0]
        try:
            reply = self.client.session_open(rep.base_url, body)
        except ReplicaRefused as exc:
            return exc.status, exc.body
        except ReplicaUnreachable as exc:
            return 502, {"error": f"replica unreachable on session "
                                  f"open: {exc}"}
        sid = str(reply.get("id", ""))
        trace_id = str(reply.get("trace_id", "") or "")
        if sid:
            with self._lock:
                self._session_routes[sid] = (rep.base_url, trace_id)
                while (len(self._session_routes)
                       > self.SESSION_ROUTES_KEEP):
                    self._session_routes.pop(
                        next(iter(self._session_routes)))
        if trace_id:
            # The router adopts the REPLICA-minted trace id (the create
            # reply carries it), so the fleet-side spans interleave with
            # the replica's own session telemetry under one id.
            self.traces.record(trace_id, "fleet_session_open",
                               session_id=sid,
                               replica_id=rep.replica_id)
        return 201, {**reply, "replica_id": rep.replica_id,
                     "router_id": self.router_id}

    def _session_route(self, sid: str) -> tuple | None:
        with self._lock:
            return self._session_routes.get(sid)

    def session_block(self, sid: str,
                      payload: bytes) -> tuple[int, dict]:
        route = self._session_route(sid)
        if route is None:
            return 404, {"error": f"no session {sid!r} routed through "
                                  "this router"}
        try:
            reply = self.client.session_block(route[0], sid, payload)
        except ReplicaRefused as exc:
            return exc.status, exc.body
        except ReplicaUnreachable as exc:
            return 502, {"error": f"replica unreachable mid-stream: {exc}"}
        return 200, {**reply, "router_id": self.router_id}

    def session_finish(self, sid: str) -> tuple[int, dict]:
        route = self._session_route(sid)
        if route is None:
            return 404, {"error": f"no session {sid!r} routed through "
                                  "this router"}
        try:
            reply = self.client.session_finish(route[0], sid)
        except ReplicaRefused as exc:
            return exc.status, exc.body
        except ReplicaUnreachable as exc:
            return 502, {"error": f"replica unreachable on finish: {exc}"}
        if route[1]:
            self.traces.record(route[1], "fleet_session_finish",
                               session_id=sid,
                               state=str(reply.get("state", "")))
        return 200, {**reply, "router_id": self.router_id}

    def session_get(self, sid: str) -> tuple[int, dict]:
        route = self._session_route(sid)
        if route is None:
            return 404, {"error": f"no session {sid!r} routed through "
                                  "this router"}
        try:
            reply = self.client.session_get(route[0], sid)
        except ReplicaRefused as exc:
            return exc.status, exc.body
        except ReplicaUnreachable as exc:
            return 502, {"error": f"replica unreachable: {exc}"}
        return 200, {**reply, "router_id": self.router_id}

    def fleet_slo(self) -> dict:
        """``GET /fleet/slo``: the SLI/error-budget report (per-journey
        availability/correctness/latency quantiles, burn rates, budget
        remaining, last verdicts) plus the prober's own state — strict
        JSON, the /fleet/capacity IEEE-specials discipline."""
        return _json_safe({
            **self.slo.report(),
            "canary": {
                "enabled": self.cfg.canary_ticks > 0,
                "cadence_ticks": self.cfg.canary_ticks,
                "rounds": self.canary.rounds(),
                "busy": self.canary.busy(),
            },
            "router_id": self.router_id,
        })

    def health(self) -> dict:
        from iterative_cleaner_tpu_torch import __version__

        snap = self.registry.snapshot()
        ages = self.scrapes.ages()
        for row in snap:
            # Per-replica scrape staleness on the router's own health
            # contract (the satellite parity with replica /healthz).
            row["scrape_age_s"] = ages.get(
                row["replica_id"] or row["base_url"])
        with self._lock:
            open_n = sum(1 for p in self._placements.values()
                         if p.state == "open")
            queued = len(self._wfq)
            inflight = self._inflight
            last_poll = self._last_poll_mono
        return {
            "status": "ok",
            "router_id": self.router_id,
            "version": __version__,
            "uptime_s": round(time.time() - self.started_s, 3),
            "last_poll_age_s": (round(time.monotonic() - last_poll, 3)
                                if last_poll else None),
            "replicas": snap,
            "replicas_alive": sum(1 for r in snap
                                  if r["alive"] and not r["draining"]),
            "stragglers": sorted(self.straggler.stragglers()),
            "open_placements": open_n,
            "queued_submissions": queued,
            "inflight": inflight,
            "max_inflight": self.cfg.max_inflight,
            # The capacity/autoscale state: the same figures
            # the gauges export, summarized for load balancers and
            # fleet_top.
            "capacity": _json_safe(
                self.capacity.snapshot().get("fleet", {})),
            "autoscale": (self.autoscaler.state()
                          if self.autoscaler is not None else None),
            # The alerting plane's firing summary: enough for
            # a load balancer or fleet_top to see "something is firing"
            # without a second request; GET /fleet/alerts has the rest.
            "alerts": self._alerts_summary(),
            # The campaign plane (campaign/): open-campaign count,
            # aggregate archive states, and recent per-campaign rows —
            # the fleet_top CAMPAIGNS section's feed.
            "campaigns": _json_safe(self.campaigns.summary()),
            # The fleet result cache (fleet/cache.py): index size and
            # cumulative hit/miss counters, summarized for fleet_top.
            "result_cache": {
                "entries": len(self.result_index),
                "hits": int(self.metrics.counter_value(
                    "fleet_cache_hits_total")),
                "misses": int(self.metrics.counter_value(
                    "fleet_cache_misses_total")),
            },
            # The SLI/error-budget plane (fleet/slo.py): enough for a
            # load balancer or fleet_top to see "a journey is failing"
            # without a second request; GET /fleet/slo has the rest.
            "slo": {
                "objectives": len(self._slo_objectives),
                "failing_journeys": self.slo.failing_journeys(),
                "min_budget_remaining_pct": _json_safe(
                    self.slo.min_budget_remaining()),
                "canary_enabled": self.cfg.canary_ticks > 0,
                "canary_rounds": self.canary.rounds(),
            },
        }

    def _alerts_summary(self) -> dict:
        firing = self.alerts.firing()
        return {
            "firing": len(firing),
            "critical": sum(1 for a in firing
                            if a["severity"] == "critical"),
            "rules": sorted({a["rule"] for a in firing}),
        }

    def drain_replica(self, replica_id: str, flag: bool) -> tuple[int, dict]:
        rep = self.registry.by_id(replica_id)
        if rep is None:
            return 404, {"error": f"no replica {replica_id!r} in the fleet"}
        try:
            body = self.client.drain(rep.base_url, flag)
        except ReplicaRefused as exc:
            return exc.status, exc.body
        except ReplicaUnreachable as exc:
            return 503, {"error": f"replica unreachable: {exc}"}
        # Operator-initiated drains leave a trace-level record (event log
        # + flight ring) — a replica that stopped taking placements must
        # be explainable from the telemetry, not just observable in the
        # registry.
        if events.active():
            events.emit("fleet_drain_requested", replica_id=replica_id,
                        drain=bool(flag), initiator="operator")
        flight.note("fleet_drain_requested", replica_id=replica_id,
                    drain=bool(flag), initiator="operator")
        # Reflect the drain in the registry immediately — waiting for the
        # next poll would leave a placement window on a draining replica.
        self.registry.poll_once(self.client)
        return 200, body


class _RouterHandler(BaseHTTPRequestHandler):
    # Bound every socket read (the replica-API rule): a client that
    # under-sends its declared body must time out, not pin this handler
    # thread and its FD forever.
    timeout = 30.0

    def log_message(self, fmt, *args):  # noqa: A003 — stdlib signature
        if not self.server.router.cfg.quiet:
            BaseHTTPRequestHandler.log_message(self, fmt, *args)

    def _reply(self, code: int, payload: dict,
               headers: dict | None = None) -> None:
        body = (json.dumps(payload) + "\n").encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if isinstance(payload, dict) and payload.get("trace_id"):
            self.send_header("X-ICT-Trace", str(payload["trace_id"]))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self, limit: int = 1 << 20) -> bytes:
        # POST /campaigns raises the cap to 8 MB: a survey manifest
        # listing tens of thousands of absolute paths is legitimate
        # input, while every other route keeps the tight default.
        try:
            n = int(self.headers.get("Content-Length", 0))
        except (TypeError, ValueError):
            n = 0
        return self.rfile.read(max(0, min(n, limit)))

    def do_GET(self) -> None:  # noqa: N802 — stdlib signature
        router = self.server.router
        if self.path == "/healthz":
            self._reply(200, router.health())
        elif self.path == "/metrics":
            body = router.metrics.render().encode()
            self.send_response(200)
            self.send_header("Content-Type", obs_metrics.CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path == "/fleet/metrics":
            body = router.fleet_metrics().encode()
            self.send_response(200)
            self.send_header("Content-Type", obs_metrics.CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path.split("?", 1)[0] == "/fleet/metrics/history":
            query = urllib.parse.parse_qs(
                urllib.parse.urlsplit(self.path).query)
            try:
                ticks = int(query["ticks"][0]) if "ticks" in query else None
            except ValueError:
                ticks = -1
            if ticks is not None and ticks < 0:
                self._reply(400, {"error": "bad ?ticks= value; want an "
                                           "int >= 0"})
                return
            families = tuple(
                p for p in str(query.get("families", [""])[0]).split(",")
                if p)
            self._reply(200, router.fleet_metrics_history(
                ticks=ticks, families=families))
        elif self.path.split("?", 1)[0] == "/fleet/trends":
            query = urllib.parse.parse_qs(
                urllib.parse.urlsplit(self.path).query)
            resolution = str(query.get("resolution", ["raw"])[0])
            try:
                window = (int(query["window"][0])
                          if "window" in query else None)
                if window is not None and window < 1:
                    raise ValueError
            except ValueError:
                self._reply(400, {"error": "bad ?window= value; want an "
                                           "int >= 1"})
                return
            try:
                self._reply(200, router.fleet_trends(
                    family=str(query.get("family", [""])[0]),
                    resolution=resolution, window=window))
            except ValueError as exc:
                self._reply(400, {"error": str(exc)})
        elif self.path == "/fleet/alerts":
            self._reply(200, router.fleet_alerts())
        elif self.path == "/fleet/capacity":
            self._reply(200, router.fleet_capacity())
        elif self.path == "/fleet/costs":
            self._reply(200, router.fleet_costs())
        elif self.path == "/fleet/slo":
            self._reply(200, router.fleet_slo())
        elif self.path.split("?", 1)[0] == "/fleet/traces":
            query = urllib.parse.parse_qs(
                urllib.parse.urlsplit(self.path).query)

            def _f(name):
                if name not in query:
                    return None
                return float(query[name][0])

            try:
                segment = str(query.get("segment", [""])[0])
                t_start, t_end = _f("t0"), _f("t1")
            except ValueError:
                self._reply(400, {"error": "bad ?t0=/?t1= value; want "
                                           "absolute unix seconds"})
                return
            code, payload = router.fleet_traces(
                segment=segment, t_start=t_start, t_end=t_end)
            self._reply(code, payload)
        elif self.path.startswith("/fleet/explain/"):
            jid = self.path[len("/fleet/explain/"):]
            code, payload = router.fleet_explain_job(jid)
            self._reply(code, payload)
        elif self.path.startswith("/fleet/trace/"):
            tid = self.path[len("/fleet/trace/"):]
            code, payload = router.fleet_trace(tid)
            self._reply(code, payload)
        elif self.path == "/fleet/incidents":
            self._reply(200, {
                "directory": router.incident_dir,
                "incidents": fleet_obs.list_incidents(router.incident_dir)})
        elif self.path == "/replicas":
            self._reply(200, {"replicas": router.registry.snapshot()})
        elif self.path == "/campaigns":
            self._reply(200, {"campaigns": _json_safe(
                router.campaigns.list())})
        elif self.path.startswith("/campaigns/"):
            cid = self.path[len("/campaigns/"):]
            view = router.campaigns.get(cid)
            if view is None:
                self._reply(404, {"error": f"no campaign {cid!r}"})
            else:
                self._reply(200, _json_safe(view))
        elif self.path.startswith("/jobs/"):
            jid = self.path[len("/jobs/"):]
            code, payload = router.job_manifest(jid)
            self._reply(code, payload)
        elif self.path.startswith("/sessions/"):
            sid = self.path[len("/sessions/"):]
            code, payload = router.session_get(sid)
            self._reply(code, payload)
        else:
            self._reply(404, {"error": f"no such route {self.path!r}"})

    def do_POST(self) -> None:  # noqa: N802 — stdlib signature
        router = self.server.router
        if self.path == "/jobs":
            self._post_job()
            return
        if self.path == "/campaigns":
            try:
                manifest = json.loads(
                    self._read_body(limit=8 << 20) or b"{}")
            except ValueError as exc:
                self._reply(400, {"error": f"bad manifest JSON: {exc}"})
                return
            try:
                row = router.campaigns.create(manifest)
            except ValueError as exc:
                self._reply(400, {"error": str(exc)})
                return
            self._reply(200, _json_safe(row))
            return
        if (self.path.startswith("/campaigns/")
                and self.path.endswith("/cancel")):
            cid = self.path[len("/campaigns/"): -len("/cancel")]
            row = router.campaigns.cancel(cid)
            if row is None:
                self._reply(404, {"error": f"no campaign {cid!r}"})
            else:
                self._reply(200, _json_safe(row))
            return
        if self.path == "/sessions":
            try:
                body = json.loads(self._read_body() or b"{}")
                if not isinstance(body, dict):
                    raise ValueError("body must be a JSON object")
            except ValueError as exc:
                self._reply(400, {"error": f"bad session body: {exc}"})
                return
            code, payload = router.session_open(body)
            self._reply(code, payload)
            return
        if (self.path.startswith("/sessions/")
                and self.path.endswith("/blocks")):
            sid = self.path[len("/sessions/"): -len("/blocks")]
            # Raw block bytes, same cap the single-replica daemon
            # enforces (online/blocks.py) so the proxy never truncates
            # a body the replica would have accepted.
            from iterative_cleaner_tpu_torch.online.blocks import MAX_BLOCK_BYTES
            code, payload = router.session_block(
                sid, self._read_body(limit=MAX_BLOCK_BYTES))
            self._reply(code, payload)
            return
        if (self.path.startswith("/sessions/")
                and self.path.endswith("/finish")):
            sid = self.path[len("/sessions/"): -len("/finish")]
            code, payload = router.session_finish(sid)
            self._reply(code, payload)
            return
        if (self.path.startswith("/replicas/")
                and self.path.endswith("/drain")):
            rid = self.path[len("/replicas/"): -len("/drain")]
            try:
                body = json.loads(self._read_body() or b"{}")
                flag = bool(body.get("drain", True)) \
                    if isinstance(body, dict) else True
            except ValueError:
                flag = True
            code, payload = router.drain_replica(rid, flag)
            self._reply(code, payload)
            return
        self._reply(404, {"error": f"no such route {self.path!r}"})

    def _post_job(self) -> None:
        router = self.server.router
        try:
            body = json.loads(self._read_body() or b"{}")
            path = body["path"]
            payload = {
                "path": str(path),
                "profile": bool(body.get("profile", False)),
                "audit": bool(body.get("audit", False)),
                # The client may pin its own idempotency key (its retry
                # across routers then dedupes too); otherwise the router
                # mints one — it is what makes failover re-routes safe.
                "idempotency_key": str(body.get("idempotency_key", "")
                                       or f"fleet-{uuid.uuid4().hex[:16]}"),
                # Canary probes self-identify; place_job rebrands them
                # onto the reserved synthetic tenant so every exclusion
                # plane (admission, capacity, costs, cache salt) keys
                # off one identity (fleet/slo.py "synthetic traffic").
                "synthetic": bool(body.get("synthetic", False)),
            }
            shape = body.get("shape")
            if shape is not None:
                payload["shape"] = [int(v) for v in shape]
        except (ValueError, KeyError, TypeError) as exc:
            self._reply(400, {"error": f"bad request body: {exc!r}; expected "
                                       '{"path": "/abs/archive"}'})
            return
        tenant = str(self.headers.get("X-ICT-Tenant", "")
                     or DEFAULT_TENANT)
        # The tenant crosses the hop inside the payload (and therefore
        # rides failover re-routes verbatim): the replica stamps it on
        # the job so the cost ledger's showback attribution and the
        # router's admission accounting can never disagree about who a
        # job belongs to (obs/costs.py).
        payload["tenant"] = tenant
        trace_id = str(self.headers.get("X-ICT-Trace", "")
                       or events.new_trace_id())
        try:
            reply = router.place_job(payload, tenant, trace_id)
        except QuotaExceeded as exc:
            self._reply(429, {"error": str(exc)},
                        headers={"Retry-After": "5"})
            return
        except FleetBusy as exc:
            self._reply(503, {"error": str(exc)},
                        headers={"Retry-After": "5"})
            return
        except ReplicaRefused as exc:
            self._reply(exc.status, exc.body)
            return
        except Exception as exc:  # noqa: BLE001 — the client deserves a 500
            self._reply(500, {"error": f"placement failed: {exc}"})
            return
        self._reply(202, reply)


# --- CLI ---

def build_fleet_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ict-serve-fleet-torch",
        description="Fleet router: spreads jobs across N ict-serve-torch "
                    "replicas with shape-bucket affinity, drain/death "
                    "failover, and multi-tenant admission "
                    '(docs/SERVING.md "Fleet")')
    p.add_argument("--replica", action="append", default=[], metavar="URL",
                   help="replica base URL, e.g. http://host:8750 "
                        "(repeatable; at least one unless --smoke)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8790,
                   help="router HTTP port (0 = ephemeral; default 8790)")
    p.add_argument("--router_id", default="", metavar="ID",
                   help="stable router identity on /healthz and event-log "
                        "lines (default: mint one per process life)")
    p.add_argument("--poll_interval_s", type=float, default=1.0, metavar="S",
                   help="health-poll / failover-sweep cadence (default 1.0)")
    p.add_argument("--dead_after", type=int, default=3, metavar="N",
                   help="consecutive unreachable health checks before a "
                        "replica is dead and its open placements re-route "
                        "(default 3)")
    p.add_argument("--max_inflight", type=int, default=0, metavar="N",
                   help="fleet-wide open-placement budget; submissions "
                        "beyond it wait in weighted-fair order "
                        "(0 = unbounded; default 0)")
    p.add_argument("--queue_timeout_s", type=float, default=30.0, metavar="S",
                   help="max wait for a placement slot before 503 "
                        "(default 30)")
    p.add_argument("--failover_retries", type=int, default=2, metavar="N",
                   help="extra full-jitter candidate sweeps per submission "
                        "(default 2)")
    p.add_argument("--retry_backoff_s", type=float, default=0.25, metavar="S",
                   help="full-jitter backoff base between sweeps "
                        "(default 0.25)")
    p.add_argument("--tenant", action="append", default=[],
                   metavar="NAME:QUOTA:WEIGHT[:BUDGET]",
                   help="per-tenant admission spec (repeatable): QUOTA open "
                        "placements (0 = unbounded), WFQ WEIGHT, and an "
                        "optional ADVISORY device-seconds BUDGET feeding "
                        "the tenant_budget_burn alert rules (warning at "
                        "80%%, critical at 100%% — rules, never admission "
                        "changes), e.g. --tenant survey:64:3:3600 "
                        "--tenant adhoc:8:1")
    p.add_argument("--default_quota", type=int, default=0, metavar="N",
                   help="open-placement quota for undeclared tenants "
                        "(0 = unbounded; default 0)")
    p.add_argument("--default_weight", type=float, default=1.0, metavar="W",
                   help="WFQ weight for undeclared tenants (default 1.0)")
    p.add_argument("--telemetry", default="", metavar="PATH",
                   help="append fleet_placement/fleet_failover events to "
                        "PATH as JSON lines (ICT_TELEMETRY equivalent)")
    p.add_argument("--spool", default="./ict_fleet_spool", metavar="DIR",
                   help="router-side durable directory: flight-ring dumps "
                        "on SIGTERM/SIGINT (DIR/flight) and incident "
                        "bundles on death eviction / failover / "
                        "audit-divergence demotion (DIR/fleet-incidents; "
                        "default ./ict_fleet_spool)")
    p.add_argument("--straggler_factor", type=float, default=3.0,
                   metavar="F",
                   help="flag a replica whose latency p50 exceeds F times "
                        "the fleet median (default 3.0; must be > 1)")
    p.add_argument("--straggler_polls", type=int, default=3, metavar="K",
                   help="consecutive slow polls before the straggler flag "
                        "fires (default 3)")
    p.add_argument("--straggler_window", type=int, default=8, metavar="N",
                   help="polls of latency-histogram deltas in each p50 "
                        "window (default 8)")
    p.add_argument("--straggler_phase", default="service_dispatch",
                   metavar="PHASE",
                   help="the scraped latency-histogram phase the straggler "
                        "p50s watch (default service_dispatch)")
    p.add_argument("--slo_grant_s", type=float, default=1.0, metavar="S",
                   help="per-tenant SLO on the placement-grant wait; a "
                        "longer wait (or a grant timeout) burns "
                        "fleet_slo_burn_total{tenant} (default 1.0)")
    p.add_argument("--capacity_window", type=int, default=8, metavar="N",
                   help="poll ticks per capacity-model rate window "
                        "(utilization / service / demand rates; default 8)")
    p.add_argument("--autoscale", choices=("off", "advise", "act"),
                   default="off",
                   help="elastic scaling loop driven by the capacity "
                        "model + SLO/straggler signals: 'advise' only "
                        "emits recommendations (events, counters, "
                        "decision bundles), 'act' spawns/drains replicas "
                        "(default off; docs/OBSERVABILITY.md)")
    p.add_argument("--min_replicas", type=int, default=1, metavar="N",
                   help="alive-replica floor the scaler respects "
                        "(default 1)")
    p.add_argument("--max_replicas", type=int, default=4, metavar="N",
                   help="alive-replica ceiling for scale-ups (default 4)")
    p.add_argument("--scale_up_eta_s", type=float, default=10.0,
                   metavar="S",
                   help="backlog-drain ETA that counts one poll as "
                        "'behind'; --scale_up_polls consecutive behind "
                        "polls fire a scale-up (default 10)")
    p.add_argument("--scale_up_polls", type=int, default=3, metavar="K",
                   help="hysteresis: consecutive behind polls before a "
                        "scale-up decision (default 3)")
    p.add_argument("--scale_down_polls", type=int, default=6, metavar="K",
                   help="hysteresis: consecutive idle polls (zero "
                        "backlog + demand, utilization under "
                        "--scale_idle_util) before a drain-then-stop "
                        "scale-down (default 6)")
    p.add_argument("--scale_idle_util", type=float, default=0.05,
                   metavar="F",
                   help="fleet utilization below which an idle poll "
                        "counts toward scale-down (default 0.05)")
    p.add_argument("--scale_cooldown_s", type=float, default=30.0,
                   metavar="S",
                   help="quiet period after any scale decision — the "
                        "anti-flapping guard (default 30)")
    p.add_argument("--spawn_retries", type=int, default=3, metavar="N",
                   help="full-jitter retries when a replica spawn fails "
                        "(default 3; each failure counts "
                        "fleet_scale_events_total{reason=spawn_failed})")
    p.add_argument("--spawn_arg", action="append", default=[],
                   metavar="ARG",
                   help="extra ict-serve-torch argument for autoscaler-spawned "
                        "subprocess replicas (repeatable), e.g. "
                        "--spawn_arg=--backend=numpy")
    p.add_argument("--history_ticks", type=int, default=128, metavar="N",
                   help="poll ticks of federated-metrics history retained "
                        "and served at GET /fleet/metrics/history; the "
                        "alert predicates evaluate over this ring "
                        "(default 128)")
    p.add_argument("--alert_rule", action="append", default=[],
                   metavar="JSON",
                   help="one declarative alert rule as a JSON object "
                        '(repeatable), e.g. \'{"name": "hot", "severity": '
                        '"warning", "family": '
                        '"ict_fleet_backlog_eta_seconds", "predicate": '
                        '{"op": "gt", "value": 30}, "for_ticks": 3}\'; a '
                        "rule re-using a default-pack name replaces that "
                        'default (docs/OBSERVABILITY.md "Alerting & '
                        'history")')
    p.add_argument("--alert_rules", default="", metavar="PATH",
                   help="JSON file holding a list of alert-rule objects "
                        "(same shape as --alert_rule), applied after the "
                        "default pack")
    p.add_argument("--no_default_alerts", action="store_true",
                   help="do not install the default SLO rule pack (audit "
                        "divergence, scrape staleness, unscaled backlog, "
                        "backend demotion, spool disk, compile-cache "
                        "thrash)")
    p.add_argument("--alert_webhook", default="", metavar="URL",
                   help="POST each alert firing/resolved transition to "
                        "URL as JSON (full-jitter retries; delivery "
                        "outcomes on "
                        "ict_fleet_alert_notifications_total)")
    p.add_argument("--alert_cmd", default="", metavar="CMD",
                   help="run CMD (a shell command) per alert transition "
                        "with the JSON on stdin — the pager/hook shape "
                        "(full-jitter retries, 10 s timeout)")
    p.add_argument("--alert_retries", type=int, default=3, metavar="N",
                   help="full-jitter delivery retries per alert sink "
                        "(default 3)")
    p.add_argument("--canary_ticks", type=int, default=0, metavar="N",
                   help="poll ticks between black-box canary probe rounds "
                        "through the router's own HTTP surface (fresh job, "
                        "cache resubmit, streaming session, micro-campaign; "
                        "each verdict bit-checks the mask against a stored "
                        "oracle; 0 = off, the default)")
    p.add_argument("--slo", action="append", default=[],
                   metavar="JOURNEY:TARGET:WINDOW_TICKS",
                   help="declarative SLO objective, repeatable — e.g. "
                        "fresh:0.99:512; registers two multiwindow "
                        "burn-rate alert rules per objective and a "
                        "spool-persisted error-budget ledger "
                        "(journeys: " + ", ".join(fleet_slo.JOURNEYS) + ")")
    p.add_argument("--no_recorder", action="store_true",
                   help="disable the production flight recorder (on by "
                        "default: every real submission is appended to a "
                        "bounded, rotated trace-segment set under "
                        "<spool>/fleet-traces, replayable via 'ict-clean-torch "
                        "prove --replay'; ICT_RECORDER=0 equivalent)")
    p.add_argument("--recorder_segment_kb", type=int, default=256,
                   metavar="KB",
                   help="open-segment size cap before the recorder seals "
                        "and rotates it (default 256)")
    p.add_argument("--recorder_keep", type=int, default=16, metavar="N",
                   help="sealed trace segments retained; the oldest are "
                        "swept beyond it (default 16)")
    p.add_argument("--no_trends", action="store_true",
                   help="disable the durable performance-trend plane (on "
                        "by default: multi-resolution rollup rings over "
                        "the federated exposition persisted under "
                        "<spool>/trends, per-bucket performance "
                        "fingerprints, and the regression sentinel "
                        "firing ict_fleet_perf_regression through the "
                        "alert engine; ICT_TRENDS=0 equivalent)")
    p.add_argument("--trend_signal", action="append", default=[],
                   metavar="JSON",
                   help="one fingerprint signal spec as a JSON object "
                        "(repeatable), e.g. '{\"name\": \"warm_jobs\", "
                        "\"mode\": \"gauge\", \"direction\": \"low\", "
                        "\"family\": "
                        "\"ict_fleet_capacity_replica_service_rate\", "
                        "\"group_by\": [\"replica\"]}'; a spec re-using "
                        "a default-set name replaces that default "
                        '(docs/OBSERVABILITY.md "Performance trends")')
    p.add_argument("--trend_keep_raw", type=int, default=128, metavar="N",
                   help="raw per-tick trend points retained per series "
                        "before the 1-minute/1-hour rollup rings take "
                        "over (default 128)")
    p.add_argument("--trend_sentinel_k", type=int, default=3, metavar="K",
                   help="consecutive out-of-band windows before the "
                        "regression sentinel fires (default 3)")
    p.add_argument("--trend_min_samples", type=int, default=8, metavar="N",
                   help="accepted in-band windows before a fingerprint "
                        "arms its sentinel (default 8)")
    p.add_argument("--trend_band_mad", type=float, default=4.0,
                   metavar="X",
                   help="fingerprint band half-width in MAD units "
                        "(default 4.0)")
    p.add_argument("--trend_persist_every", type=int, default=16,
                   metavar="N",
                   help="poll ticks between trend-store spool writes; "
                        "stop() always persists (default 16)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the replicas the router builds: "
                        "the smokes' in-process replicas and the "
                        "autoscaler's spawned ones (default: cuda; pass "
                        "'cpu' to run on the CPU)")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("--smoke", action="store_true",
                   help="offline self-check: 2 in-process replicas behind "
                        "the router, jobs submitted through it, one replica "
                        "killed mid-queue, every job must complete exactly "
                        "once with oracle-identical masks; one JSON line")
    return p


def parse_tenant_specs(specs: list[str]) -> tuple[dict, dict, dict]:
    """``NAME:QUOTA:WEIGHT[:BUDGET]`` -> (quotas, weights, budgets).
    BUDGET is an optional ADVISORY device-seconds budget (> 0) feeding
    the tenant_budget_burn alert rules (fleet/costs.py) — it never
    changes admission; quotas stay the only admission lever."""
    quotas: dict[str, int] = {}
    weights: dict[str, float] = {}
    budgets: dict[str, float] = {}
    for spec in specs:
        try:
            parts = spec.split(":")
            if len(parts) == 3:
                name, quota, weight = parts
                budget = ""
            elif len(parts) == 4:
                name, quota, weight, budget = parts
            else:
                raise ValueError
            if not name:
                raise ValueError
            quotas[name] = int(quota)
            weights[name] = float(weight)
            if quotas[name] < 0 or weights[name] <= 0:
                raise ValueError
            if len(parts) == 4:
                # An EMPTY fourth field ('survey:64:3:' — a trailing
                # colon typo, or an empty $BUDGET shell variable) is the
                # malformation that looks most like an intended budget:
                # reject it loudly instead of silently unmetering the
                # tenant.
                budgets[name] = float(budget)
                if budgets[name] <= 0:
                    raise ValueError
        except ValueError:
            raise ValueError(
                f"bad --tenant spec {spec!r}; expected "
                "NAME:QUOTA:WEIGHT[:BUDGET] like survey:64:3 or "
                "survey:64:3:3600 (quota >= 0, weight > 0, optional "
                "advisory device-seconds budget > 0)") from None
    return quotas, weights, budgets


def fleet_config_from_args(args: argparse.Namespace) -> FleetConfig:
    if not args.replica and not args.smoke:
        raise ValueError("at least one --replica URL is required "
                         "(or --smoke for the self-check)")
    if args.dead_after < 1:
        raise ValueError(f"--dead_after must be >= 1, got {args.dead_after}")
    if args.max_inflight < 0:
        raise ValueError(f"--max_inflight must be >= 0 (0 = unbounded), "
                         f"got {args.max_inflight}")
    if args.straggler_factor <= 1:
        raise ValueError(f"--straggler_factor must be > 1 (a replica AT "
                         f"the median is not a straggler), got "
                         f"{args.straggler_factor}")
    if args.straggler_polls < 1:
        raise ValueError(f"--straggler_polls must be >= 1, got "
                         f"{args.straggler_polls}")
    if args.straggler_window < 1:
        raise ValueError(f"--straggler_window must be >= 1, got "
                         f"{args.straggler_window}")
    if args.capacity_window < 1:
        raise ValueError(f"--capacity_window must be >= 1, got "
                         f"{args.capacity_window}")
    if args.min_replicas < 1:
        raise ValueError(f"--min_replicas must be >= 1, got "
                         f"{args.min_replicas}")
    if args.max_replicas < args.min_replicas:
        raise ValueError(f"--max_replicas ({args.max_replicas}) must be "
                         f">= --min_replicas ({args.min_replicas})")
    if args.scale_up_polls < 1 or args.scale_down_polls < 1:
        raise ValueError("--scale_up_polls/--scale_down_polls must be "
                         ">= 1 (the hysteresis windows)")
    if args.scale_cooldown_s < 0:
        raise ValueError(f"--scale_cooldown_s must be >= 0, got "
                         f"{args.scale_cooldown_s}")
    if args.history_ticks < 1:
        raise ValueError(f"--history_ticks must be >= 1, got "
                         f"{args.history_ticks}")
    if args.alert_retries < 0:
        raise ValueError(f"--alert_retries must be >= 0, got "
                         f"{args.alert_retries}")
    if args.canary_ticks < 0:
        raise ValueError(f"--canary_ticks must be >= 0 (0 = off), got "
                         f"{args.canary_ticks}")
    if args.recorder_segment_kb < 1:
        raise ValueError(f"--recorder_segment_kb must be >= 1, got "
                         f"{args.recorder_segment_kb}")
    if args.recorder_keep < 1:
        raise ValueError(f"--recorder_keep must be >= 1, got "
                         f"{args.recorder_keep}")
    if args.trend_keep_raw < 1:
        raise ValueError(f"--trend_keep_raw must be >= 1, got "
                         f"{args.trend_keep_raw}")
    if args.trend_sentinel_k < 1:
        raise ValueError(f"--trend_sentinel_k must be >= 1, got "
                         f"{args.trend_sentinel_k}")
    if args.trend_min_samples < 2:
        raise ValueError(f"--trend_min_samples must be >= 2 (a band "
                         f"needs a spread), got {args.trend_min_samples}")
    if args.trend_band_mad <= 0:
        raise ValueError(f"--trend_band_mad must be > 0, got "
                         f"{args.trend_band_mad}")
    if args.trend_persist_every < 1:
        raise ValueError(f"--trend_persist_every must be >= 1, got "
                         f"{args.trend_persist_every}")
    trend_signals: list[dict] = []
    for raw in args.trend_signal:
        try:
            spec = json.loads(raw)
        except ValueError as exc:
            raise ValueError(f"bad --trend_signal JSON {raw!r}: {exc}"
                             ) from None
        fleet_trends.parse_signal(spec)  # validate NOW, at the CLI surface
        trend_signals.append(spec)
    fleet_slo.parse_slo_specs(args.slo)  # validate NOW, at the CLI surface
    alert_rules: list[dict] = []
    for raw in args.alert_rule:
        try:
            spec = json.loads(raw)
        except ValueError as exc:
            raise ValueError(f"bad --alert_rule JSON {raw!r}: {exc}"
                             ) from None
        fleet_alerts.parse_rule(spec)   # validate NOW, at the CLI surface
        alert_rules.append(spec)
    if args.alert_rules:
        try:
            with open(args.alert_rules) as fh:
                file_rules = json.load(fh)
        except (OSError, ValueError) as exc:
            raise ValueError(f"cannot read --alert_rules "
                             f"{args.alert_rules!r}: {exc}") from None
        if not isinstance(file_rules, list):
            raise ValueError(f"--alert_rules {args.alert_rules!r} must "
                             "hold a JSON list of rule objects")
        for spec in file_rules:
            fleet_alerts.parse_rule(spec)
            alert_rules.append(spec)
    quotas, weights, budgets = parse_tenant_specs(args.tenant)
    return FleetConfig(
        replicas=tuple(args.replica),
        host=args.host,
        port=args.port,
        router_id=args.router_id,
        poll_interval_s=args.poll_interval_s,
        dead_after=args.dead_after,
        max_inflight=args.max_inflight,
        queue_timeout_s=args.queue_timeout_s,
        failover_retries=args.failover_retries,
        retry_backoff_s=args.retry_backoff_s,
        tenant_quotas=quotas,
        tenant_weights=weights,
        tenant_budgets=budgets,
        default_quota=args.default_quota,
        default_weight=args.default_weight,
        telemetry=args.telemetry,
        spool_dir=args.spool,
        straggler_factor=args.straggler_factor,
        straggler_polls=args.straggler_polls,
        straggler_window=args.straggler_window,
        straggler_phase=args.straggler_phase,
        slo_grant_s=args.slo_grant_s,
        capacity_window=args.capacity_window,
        autoscale=args.autoscale,
        min_replicas=args.min_replicas,
        max_replicas=args.max_replicas,
        scale_up_eta_s=args.scale_up_eta_s,
        scale_up_polls=args.scale_up_polls,
        scale_down_polls=args.scale_down_polls,
        scale_idle_util=args.scale_idle_util,
        scale_cooldown_s=args.scale_cooldown_s,
        spawn_retries=args.spawn_retries,
        spawn_args=tuple(args.spawn_arg),
        history_ticks=args.history_ticks,
        default_alerts=not args.no_default_alerts,
        alert_rules=tuple(alert_rules),
        alert_webhook=args.alert_webhook,
        alert_cmd=args.alert_cmd,
        alert_retries=args.alert_retries,
        canary_ticks=args.canary_ticks,
        slo=tuple(args.slo),
        recorder=not args.no_recorder,
        recorder_segment_kb=args.recorder_segment_kb,
        recorder_keep=args.recorder_keep,
        trends=not args.no_trends,
        trend_keep_raw=args.trend_keep_raw,
        trend_signals=tuple(trend_signals),
        trend_sentinel_k=args.trend_sentinel_k,
        trend_min_samples=args.trend_min_samples,
        trend_band_mad=args.trend_band_mad,
        trend_persist_every=args.trend_persist_every,
        device=args.device,
        quiet=args.quiet,
    )


def _merged_counters_equal(families) -> bool:
    """Check one parsed /fleet/metrics exposition's federation invariant:
    every merged counter total equals the sum of the per-replica series
    it was built from (summed in sorted-replica order, the same order the
    merge used, so float totals match bit-for-bit).  Shared by the smoke
    and the e2e tests."""
    merged: dict[tuple, float] = {}
    per_replica: dict[tuple, list] = {}
    for fam in families:
        if fam.kind != "counter":
            continue
        for name, labels, raw in fam.samples:
            value = obs_metrics.sample_value(raw)
            d = dict(labels)
            if fam.name.startswith("ict_fleet_"):
                merged[(name, labels)] = value
            elif "replica" in d:
                rid = d.pop("replica")
                key = (fleet_obs.merged_name(name),
                       tuple(p for p in labels if p[0] != "replica"))
                per_replica.setdefault(key, []).append((rid, value))
    if not per_replica:
        return False
    for key, entries in per_replica.items():
        total = 0.0
        for _rid, value in sorted(entries):
            total += value
        if merged.get(key) != total:
            return False
    return True


def run_fleet_smoke(cfg: FleetConfig) -> int:
    """Offline fleet self-check: 2 in-process replicas behind one router;
    several jobs submitted THROUGH the router; the replica holding a
    parked (undispatched) job is killed; every job must complete exactly
    once with masks bit-identical to the numpy oracle and the shadow
    audit clean; at least one failover must be recorded.  The fleet
    observability plane is asserted end to end on top: the merged
    ``GET /fleet/metrics`` scrape passes the strict exposition grammar
    with merged counters exactly equal to the per-replica sums and a
    nonzero ``fleet_jobs_completed``, the induced failover yields a
    stitched ``GET /fleet/trace`` spanning both replicas, and at least
    one incident bundle lands on disk.  A campaign lane then
    runs a small survey manifest through ``POST /campaigns`` — one
    duplicate archive served born-terminal by the fleet result cache, a
    late-joined third replica killed mid-campaign — and asserts
    exactly-once completion, oracle-identical masks, and a QA roll-up +
    per-campaign cost row on the view.  A trend lane arms an
    injected fingerprint on a synthetic speed gauge, drives a synthetic
    slowdown through sentinel firing -> ``perf_regression`` alert ->
    trend incident bundle -> live ``GET /fleet/trends`` view, then
    recovery until both resolve.  One JSON line, rc 0/1 — the CI lane
    next to ``serve --smoke``."""
    import tempfile
    import urllib.request

    import numpy as np

    from iterative_cleaner_tpu_torch.config import CleanConfig
    from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
    from iterative_cleaner_tpu_torch.io.npz import NpzIO
    from iterative_cleaner_tpu_torch.io.synthetic import make_archive
    from iterative_cleaner_tpu_torch.models.surgical import finalize_weights
    from iterative_cleaner_tpu_torch.obs import tracing
    from iterative_cleaner_tpu_torch.ops.preprocess import preprocess
    from iterative_cleaner_tpu_torch.service.daemon import CleaningService
    from iterative_cleaner_tpu_torch.service.daemon import ServeConfig
    from iterative_cleaner_tpu_torch.service.jobs import TERMINAL

    def serve_cfg(tag: str, tmp: str, deadline_s: float,
                  bucket_cap: int = 0, coalesce: int = 1) -> ServeConfig:
        return ServeConfig(
            spool_dir=os.path.join(tmp, f"spool_{tag}"), port=0,
            replica_id=f"smoke-{tag}", deadline_s=deadline_s,
            bucket_cap=bucket_cap, coalesce=coalesce,
            device=cfg.device, quiet=True,
            clean=CleanConfig(backend="torch", quiet=True))

    result = {"smoke": "FAIL"}
    with tempfile.TemporaryDirectory(prefix="ict_fleet_smoke_") as tmp:
        paths = []
        for i in range(3):
            p = os.path.join(tmp, f"smoke{i}.npz")
            NpzIO().save(make_archive(nsub=4, nchan=16, nbin=64,
                                      seed=200 + i), p)
            paths.append(p)
        # Replica a parks decoded cubes (huge deadline + a wide explicit
        # bucket that never fills): the job placed on it is accepted-but-
        # undispatched when it dies — exactly the failover case the
        # router must cover.  Replica b drains fast.
        svc_a = CleaningService(serve_cfg("a", tmp, deadline_s=3600.0,
                                          bucket_cap=8))
        # Replica b runs the coalescing rung (bucket_cap 1 x coalesce 2 =
        # a 2-cube flush threshold): the throughput-tier phase below
        # submits two same-shape cubes back to back and asserts they
        # shared ONE dispatch, masks bit-identical throughout.
        svc_b = CleaningService(serve_cfg("b", tmp, deadline_s=1.0,
                                          bucket_cap=1, coalesce=2))
        svc_a.start()
        svc_b.start()
        # Hermetic overrides only (the run_smoke idiom): replicas and the
        # port are the smoke's own; every other operator flag
        # (--dead_after, --poll_interval_s, tenant specs, --telemetry, -q)
        # is honored so the smoke exercises the configured behavior —
        # with a faster-than-default poll/death cadence when the operator
        # left them at the defaults, to keep the CI lane snappy.
        poll_s = (0.2 if cfg.poll_interval_s == FleetConfig.poll_interval_s
                  else cfg.poll_interval_s)
        dead_after = (2 if cfg.dead_after == FleetConfig.dead_after
                      else cfg.dead_after)
        router = FleetRouter(FleetConfig(**{
            **cfg.__dict__,
            "replicas": (f"http://127.0.0.1:{svc_a.port}",
                         f"http://127.0.0.1:{svc_b.port}"),
            "port": 0,
            "poll_interval_s": poll_s,
            "dead_after": dead_after,
            # Hermetic: incident bundles and flight dumps land in the
            # smoke's own tempdir, never the operator's spool.
            "spool_dir": os.path.join(tmp, "router_spool"),
            # The alerts lane: a tiny-threshold injected rule
            # that MUST fire while placements are open and resolve once
            # the fleet drains — one full firing -> resolved lifecycle
            # cycle, asserted below alongside the operator's own rules.
            "alert_rules": tuple(cfg.alert_rules) + ({
                "name": "smoke_open_placements", "severity": "info",
                "family": "ict_fleet_open_placements",
                "predicate": {"op": "gt", "value": 0}, "for_ticks": 1,
                "description": "serve-fleet --smoke injected rule"},),
            # The costs lane: a deliberately tiny advisory
            # budget that ONE dispatch's device-seconds must blow
            # through, driving a full tenant_budget_burn firing ->
            # resolved cycle through the alert plane below.
            "tenant_budgets": {**cfg.tenant_budgets, "smokecost": 1e-4},
            # The canary/SLO lane: a default objective per
            # journey when the operator gave none, so the burn-rate
            # rules register and the error-budget ledger runs.  Probe
            # cadence stays OFF — the lane drives one round
            # synchronously so the exactly-once deltas asserted above
            # stay deterministic.
            "slo": tuple(cfg.slo) or tuple(
                f"{j}:0.99:64" for j in fleet_slo.JOURNEYS),
            "canary_ticks": 0,
            # The trend lane: a synthetic per-replica speed
            # gauge published straight into the router registry, watched
            # by an injected fingerprint signal with a tiny arm/fire
            # ladder — the lane below drives healthy ticks (arms),
            # a slowdown (sentinel fires -> perf_regression alert ->
            # trend incident bundle), then recovery (resolves).
            "trend_signals": tuple(cfg.trend_signals) + ({
                "name": "smoke_speed", "mode": "gauge",
                "direction": "low",
                "family": "ict_fleet_smoke_trend_speed",
                "group_by": ["replica"], "window": 1,
                "min_samples": 3, "sentinel_k": 2},),
        }))
        router.start()
        jobs = {}
        svc_c = None    # the campaign lane's late-joining third replica
        try:
            base = f"http://{router.cfg.host}:{router.port}"
            before_done = tracing.counters_snapshot().get(
                "service_jobs_done", 0)
            before_fallbacks = tracing.counters_snapshot().get(
                "service_oracle_fallbacks", 0)
            for p in paths:
                req = urllib.request.Request(
                    f"{base}/jobs",
                    data=json.dumps({"path": p, "audit": True,
                                     "shape": [4, 16, 64]}).encode(),
                    headers={"Content-Type": "application/json"})
                jobs[p] = json.load(urllib.request.urlopen(req, timeout=30))
            placed_on_a = [j for j in jobs.values()
                           if j.get("replica_id") == "smoke-a"]
            # Wait until replica a has actually decoded and PARKED its
            # job(s) (bucketed, not yet dispatched), then kill it.
            deadline = time.time() + 120
            while time.time() < deadline:
                health = json.load(urllib.request.urlopen(
                    f"http://127.0.0.1:{svc_a.port}/healthz", timeout=10))
                if health.get("bucketed_cubes", 0) >= len(placed_on_a) > 0:
                    break
                time.sleep(0.05)
            # One deterministic scrape pass BEFORE the crash: the dead
            # replica's pre-death metrics + flight ring must be in the
            # router's cache for the incident bundle and the stitched
            # trace (the poll loop would usually have done this already).
            router.poll_tick()
            svc_a.stop()    # the "crash": parked jobs stay in its spool
            # Router polls mark a dead and re-route; wait for every job
            # (under its fleet id) to turn terminal through the router.
            deadline = time.time() + 300
            states = {}
            while time.time() < deadline:
                states = {p: json.load(urllib.request.urlopen(
                    f"{base}/jobs/{j['id']}", timeout=10))
                    for p, j in jobs.items()}
                if all(s.get("state") in TERMINAL for s in states.values()):
                    break
                time.sleep(0.1)
            all_done = all(s.get("state") == "done"
                           for s in states.values())
            # Exactly once: the fleet-wide completion count (both
            # replicas share this process's tracing registry) moved by
            # exactly len(paths).
            done_delta = tracing.counters_snapshot().get(
                "service_jobs_done", 0) - before_done
            svc_b.auditor.drain(60)
            health_b = json.load(urllib.request.urlopen(
                f"http://127.0.0.1:{svc_b.port}/healthz", timeout=10))
            masks_ok = all_done
            if all_done:
                cfg_np = CleanConfig(backend="numpy")
                for p in paths:
                    want, _nbs, _nbc = finalize_weights(
                        clean_cube(*preprocess(NpzIO().load(p)),
                                   cfg_np).weights, cfg_np)
                    got = NpzIO().load(states[p]["out_path"])
                    if not np.array_equal(got.weights, want):
                        masks_ok = False
            failovers = router.metrics.counter_total("fleet_failovers_total")
            # --- the fleet observability plane, end to end ---
            # Merged /fleet/metrics: strict grammar (the parse IS the
            # check), merged counters exactly the sum of the per-replica
            # series next to them, and the completion counter moved.
            fleet_text = urllib.request.urlopen(
                f"{base}/fleet/metrics", timeout=10).read().decode()
            fleet_ok = False
            try:
                fams = obs_metrics.parse_exposition(fleet_text)
            except ValueError:
                fams = []
            if fams:
                fleet_ok = (_merged_counters_equal(fams)
                            and router.metrics.counter_value(
                                "fleet_jobs_completed_total",
                                {"state": "done"}) == len(paths))
            # Stitched cross-hop trace: a failed-over job's timeline must
            # carry spans from BOTH replicas under its one trace id.
            trace_ok = False
            for j in jobs.values():
                trace = json.load(urllib.request.urlopen(
                    f"{base}/fleet/trace/{j['trace_id']}", timeout=10))
                span_sources = {s.get("source") for s in trace["spans"]}
                if {"smoke-a", "smoke-b"} <= span_sources:
                    trace_ok = True
                    break
            incidents = json.load(urllib.request.urlopen(
                f"{base}/fleet/incidents", timeout=10))["incidents"]
            # --- the alerting plane, end to end ---
            # The injected rule fired while placements were open; with
            # every job terminal, drive ticks until it resolves (bounded
            # — the background loop may already have).
            deadline = time.time() + 60
            while time.time() < deadline:
                router.poll_tick()
                if not any(a["rule"] == "smoke_open_placements"
                           for a in router.alerts.firing()):
                    break
                time.sleep(0.05)
            alerts_view = json.load(urllib.request.urlopen(
                f"{base}/fleet/alerts", timeout=10))
            cycle = [t["state"] for t in alerts_view["recent"]
                     if t["rule"] == "smoke_open_placements"]
            alert_fired = router.metrics.counter_value(
                "fleet_alerts_total", {"rule": "smoke_open_placements",
                                       "severity": "info"})
            # The counter must be VISIBLE through the federated scrape,
            # and the history endpoint must serve re-renderable ticks.
            alert_text = urllib.request.urlopen(
                f"{base}/fleet/metrics", timeout=10).read().decode()
            counter_visible = False
            try:
                for fam in obs_metrics.parse_exposition(alert_text):
                    if fam.name != "ict_fleet_alerts_total":
                        continue
                    for _n, labels, raw in fam.samples:
                        if (dict(labels).get("rule")
                                == "smoke_open_placements"
                                and obs_metrics.sample_value(raw) >= 1):
                            counter_visible = True
            except ValueError:
                pass
            history_view = json.load(urllib.request.urlopen(
                f"{base}/fleet/metrics/history?ticks=4", timeout=10))
            bundles = fleet_alerts.list_alert_bundles(router.alert_dir)
            alerts_ok = (alert_fired >= 1 and counter_visible
                         and cycle[:2] == ["firing", "resolved"]
                         and not any(a["rule"] == "smoke_open_placements"
                                     for a in alerts_view["firing"])
                         and any(b.get("rule") == "smoke_open_placements"
                                 for b in bundles)
                         and len(history_view["ticks"]) >= 1)
            # --- the throughput tier: coalescing +
            # fleet-wide content-addressed reuse, end to end ---
            # Two fresh same-shape cubes submitted back to back must
            # share ONE coalesced dispatch on replica b (bucket_cap 1 x
            # coalesce 2), each mask bit-identical to its own oracle.
            def submit(p, extra=None, headers=None):
                req = urllib.request.Request(
                    f"{base}/jobs",
                    data=json.dumps({"path": p, **(extra or {})}).encode(),
                    headers={"Content-Type": "application/json",
                             **(headers or {})})
                return json.load(urllib.request.urlopen(req, timeout=30))

            co_paths = []
            for i in range(2):
                p2 = os.path.join(tmp, f"coalesce{i}.npz")
                NpzIO().save(make_archive(nsub=4, nchan=16, nbin=64,
                                          seed=500 + i), p2)
                co_paths.append(p2)
            co_before = tracing.labeled_snapshot()
            co_jobs = {p2: submit(p2, {"shape": [4, 16, 64]})
                       for p2 in co_paths}
            co_states = {}
            deadline = time.time() + 300
            while time.time() < deadline:
                co_states = {p2: json.load(urllib.request.urlopen(
                    f"{base}/jobs/{j['id']}", timeout=10))
                    for p2, j in co_jobs.items()}
                if all(s.get("state") in TERMINAL
                       for s in co_states.values()):
                    break
                time.sleep(0.05)
            co_delta = {
                key: val - co_before.get(key, 0.0)
                for key, val in tracing.labeled_snapshot().items()
                if key[0] == "coalesce_batch_size_total"}
            coalesced_dispatches = sum(
                val for (_fam, labels), val in co_delta.items()
                if int(dict(labels).get("k", "1")) >= 2)
            co_masks_ok = all(s.get("state") == "done"
                              for s in co_states.values())
            if co_masks_ok:
                cfg_np = CleanConfig(backend="numpy")
                for p2 in co_paths:
                    want, _nbs, _nbc = finalize_weights(
                        clean_cube(*preprocess(NpzIO().load(p2)),
                                   cfg_np).weights, cfg_np)
                    got = NpzIO().load(co_states[p2]["out_path"])
                    if not np.array_equal(got.weights, want):
                        co_masks_ok = False
            coalesce_ok = coalesced_dispatches >= 1 and co_masks_ok
            # A byte-identical resubmission (fresh idempotency key, the
            # original served on ANOTHER placement) must hit the router's
            # fleet-wide result cache: born terminal, byte-identical
            # output, and ZERO replica-side work (service_jobs_done does
            # not move).
            done_before_dup = tracing.counters_snapshot().get(
                "service_jobs_done", 0)
            dup = submit(paths[0])
            fleet_cache_hits = router.metrics.counter_total(
                "fleet_cache_hits_total")
            dup_no_work = (tracing.counters_snapshot().get(
                "service_jobs_done", 0) == done_before_dup)
            dup_masks_ok = False
            if dup.get("state") == "done" and dup.get("out_path"):
                cfg_np = CleanConfig(backend="numpy")
                want, _nbs, _nbc = finalize_weights(
                    clean_cube(*preprocess(NpzIO().load(paths[0])),
                               cfg_np).weights, cfg_np)
                dup_masks_ok = bool(np.array_equal(
                    NpzIO().load(dup["out_path"]).weights, want))
            cache_ok = (dup.get("served_by") == "fleet-cache"
                        and fleet_cache_hits >= 1 and dup_no_work
                        and dup_masks_ok)
            # --- the campaign lane, end to end ---
            # A small survey manifest through POST /campaigns: the
            # orchestrator places every archive through the SAME ranked
            # placement path under campaign-scoped idempotency keys.  A
            # third parked replica joins the fleet at runtime and is
            # killed mid-campaign (the failover story again, now under
            # campaign keys); one manifest entry duplicates an archive
            # the fleet already cleaned, so it must be served
            # born-terminal by the result cache.  Asserted: the campaign
            # reaches "done" with every archive done, the jobs-done
            # ledger moves by the FRESH archive count only (exactly
            # once — duplicates and failovers add nothing), >= 1
            # fleet-cache hit, masks bit-identical to the solo numpy
            # oracle, and the view carries a QA roll-up plus a cost row
            # with real device-seconds and the dedupe dividend.
            svc_c = CleaningService(serve_cfg("c", tmp, deadline_s=3600.0,
                                              bucket_cap=8))
            svc_c.start()
            router.registry.add(f"http://127.0.0.1:{svc_c.port}")
            camp_paths = []
            for i in range(4):
                p3 = os.path.join(tmp, f"survey{i}.npz")
                NpzIO().save(make_archive(nsub=4, nchan=16, nbin=64,
                                          seed=620 + i), p3)
                camp_paths.append(p3)
            camp_done_before = tracing.counters_snapshot().get(
                "service_jobs_done", 0)
            camp_cache_before = router.metrics.counter_total(
                "fleet_cache_hits_total")
            camp_req = urllib.request.Request(
                f"{base}/campaigns",
                data=json.dumps({
                    "name": "smoke-survey", "tenant": "smokesurvey",
                    "archives": camp_paths + [paths[0]],
                    "config": {"lane": "serve-fleet --smoke"},
                }).encode(),
                headers={"Content-Type": "application/json"})
            camp_row = json.load(urllib.request.urlopen(camp_req,
                                                        timeout=30))
            camp_id = camp_row["id"]
            # Kill replica c once campaign work is PARKED on it (decoded,
            # bucketed, undispatched — the worst failover case), or once
            # the campaign outran the placement race and finished
            # entirely on b; either way the crash lands while the run is
            # live whenever there is anything on c to fail over.
            camp_view: dict = {}
            deadline = time.time() + 300
            while time.time() < deadline:
                health_c = json.load(urllib.request.urlopen(
                    f"http://127.0.0.1:{svc_c.port}/healthz", timeout=10))
                camp_view = json.load(urllib.request.urlopen(
                    f"{base}/campaigns/{camp_id}", timeout=10))
                if (health_c.get("bucketed_cubes", 0) >= 1
                        or camp_view.get("state") != "open"):
                    break
                time.sleep(0.05)
            svc_c.stop()    # the mid-campaign crash
            deadline = time.time() + 300
            while time.time() < deadline:
                camp_view = json.load(urllib.request.urlopen(
                    f"{base}/campaigns/{camp_id}", timeout=10))
                if camp_view.get("state") != "open":
                    break
                time.sleep(0.1)
            camp_done_delta = tracing.counters_snapshot().get(
                "service_jobs_done", 0) - camp_done_before
            camp_cache_hits = router.metrics.counter_total(
                "fleet_cache_hits_total") - camp_cache_before
            camp_masks_ok = camp_view.get("state") == "done"
            if camp_masks_ok:
                cfg_np = CleanConfig(backend="numpy")
                for rec in camp_view["archive_records"]:
                    want, _nbs, _nbc = finalize_weights(
                        clean_cube(*preprocess(NpzIO().load(rec["path"])),
                                   cfg_np).weights, cfg_np)
                    got = NpzIO().load(rec["out_path"])
                    if not np.array_equal(got.weights, want):
                        camp_masks_ok = False
            camp_rollup = camp_view.get("rollup") or {}
            camp_cost = camp_view.get("cost") or {}
            camp_metrics_text = urllib.request.urlopen(
                f"{base}/metrics", timeout=10).read().decode()
            campaign_ok = (
                camp_view.get("state") == "done"
                and camp_view.get("archives", {}).get("done", 0)
                == len(camp_paths) + 1
                and camp_done_delta == len(camp_paths)
                and camp_cache_hits >= 1
                and camp_masks_ok
                and camp_rollup.get("jobs") == len(camp_paths) + 1
                and camp_rollup.get("with_quality") == len(camp_paths) + 1
                and camp_cost.get("jobs_costed") == len(camp_paths) + 1
                and camp_cost.get("device_s", 0.0) > 0
                and camp_cost.get("cache_hits", 0) >= 1
                and camp_cost.get("avoided_device_s", 0.0) > 0
                and (f'ict_campaign_device_seconds{{campaign="{camp_id}"}}'
                     in camp_metrics_text))
            # --- the canary/SLO plane, end to end ---
            # One synchronous probe round through the router's OWN HTTP
            # surface (the background poll loop keeps driving campaign
            # progress): every journey must come back green with a
            # bit-identical mask verdict, the probes must provably
            # never touch the capacity-demand, admission, or showback
            # planes, and the --slo objectives injected above must have
            # registered their multiwindow burn-rate rules.
            demand_before = router.capacity.demand_total()
            admit_before = router.metrics.counter_value(
                "fleet_tenant_admissions_total",
                {"tenant": SYNTHETIC_TENANT})
            verdicts = {v["journey"]: v
                        for v in router.canary.run_round()}
            router.poll_tick()   # fold verdicts into the SLI gauges
            canary_green = (
                set(verdicts) == set(fleet_slo.CANARY_JOURNEYS)
                and all(v.get("ok") and v.get("correct") is True
                        for v in verdicts.values()))
            canary_costs = json.load(urllib.request.urlopen(
                f"{base}/fleet/costs", timeout=10))
            synthetic_excluded = (
                router.capacity.demand_total() == demand_before
                and router.metrics.counter_value(
                    "fleet_tenant_admissions_total",
                    {"tenant": SYNTHETIC_TENANT}) == admit_before
                and SYNTHETIC_TENANT
                not in (canary_costs.get("tenants") or {}))
            rule_names = {r["name"] for r in router.alerts.rules_table()}
            burn_rules_ok = all(
                f"slo_burn_fast:{j}" in rule_names
                and f"slo_burn_slow:{j}" in rule_names
                for j in fleet_slo.JOURNEYS)
            slo_view = json.load(urllib.request.urlopen(
                f"{base}/fleet/slo", timeout=10))
            slo_report_ok = all(
                (slo_view.get("journeys", {}).get(j, {})
                 .get("availability") == 1.0)
                for j in fleet_slo.CANARY_JOURNEYS)
            canary_ok = (canary_green and synthetic_excluded
                         and burn_rules_ok and slo_report_ok)
            # --- the recorder/explain plane, end to end ---
            # Every REAL submission the smoke has made so far (fresh
            # placements and fleet-cache resolutions alike) sits on the
            # flight recorder's open tape, and the synchronous canary
            # round above injected synthetic traffic that must be absent
            # BY CONSTRUCTION.  Seal the production window, check the
            # /fleet/traces inventory, then replay the sealed segment
            # through the SAME ``prove --replay`` entry point operators
            # use: every entry must dedupe one-for-one under its
            # original idempotency key with ZERO new replica work
            # (service_jobs_done unmoved).  Then the explain plane: all
            # seven planes for a completed job on a live replica.
            import contextlib
            import io as io_mod
            from iterative_cleaner_tpu_torch.proving import soak as proving_soak
            from iterative_cleaner_tpu_torch.proving import (
                traces as proving_traces)
            rec_stats = router.recorder.stats()
            seg_path = router.recorder.seal()
            rec_inventory = json.load(urllib.request.urlopen(
                f"{base}/fleet/traces", timeout=10))
            seg_entries = (proving_traces.load_trace(seg_path)
                           if seg_path else [])
            rec_clean = (len(seg_entries) >= 1
                         and rec_stats["excluded_total"] >= 1
                         and not any(e.tenant == SYNTHETIC_TENANT
                                     for e in seg_entries))
            rec_done_before = tracing.counters_snapshot().get(
                "service_jobs_done", 0)
            replay_report: dict = {}
            replay_rc = 1
            if seg_path:
                replay_buf = io_mod.StringIO()
                with contextlib.redirect_stdout(replay_buf):
                    replay_rc = proving_soak.run_replay(
                        seg_path, base, compression=1000.0)
                replay_report = json.loads(
                    replay_buf.getvalue().strip().splitlines()[-1])
            rec_jobs_done_unmoved = (tracing.counters_snapshot().get(
                "service_jobs_done", 0) == rec_done_before)
            recorder_ok = (
                rec_clean and replay_rc == 0
                and replay_report.get("entries") == len(seg_entries)
                and replay_report.get("dedup_delta") == len(seg_entries)
                and rec_jobs_done_unmoved
                and len(rec_inventory.get("segments") or []) >= 1
                and bool(rec_inventory.get("recorder", {})
                         .get("enabled")))
            # Explain: the coalesce jobs finished on live replica b, so
            # the causal report must carry ALL seven planes with the
            # replica-backed ones sourced live.
            exp_job_id = co_jobs[co_paths[0]]["id"]
            exp_view = json.load(urllib.request.urlopen(
                f"{base}/fleet/explain/{exp_job_id}", timeout=10))
            explain_ok = (
                set(exp_view.get("planes") or {})
                == set(fleet_explain.PLANES)
                and exp_view["planes"]["cost"]["source"] == "live"
                and exp_view["planes"]["trace"]["source"]
                in ("live", "spool")
                and exp_view["planes"]["slo"]["source"] == "live"
                and exp_view.get("state") == "done")
            # --- the cost-accounting plane, end to end ---
            # A tenant-tagged job burns through the injected tiny
            # budget; the costs lane then asserts (a) attribution
            # CONSERVES — summed per-job device-seconds equal the
            # dispatch-seconds counter within 1%, (b) /fleet/costs
            # carries per-tenant rows, and (c) the tenant_budget_burn
            # rule completes a firing -> resolved cycle (resolution via
            # the replica leaving the fleet — the advisory-budget
            # semantics fleet/costs.py documents).
            cost_path = os.path.join(tmp, "smokecost.npz")
            NpzIO().save(make_archive(nsub=4, nchan=16, nbin=64,
                                      seed=700), cost_path)
            cost_job = submit(cost_path, {"shape": [4, 16, 64]},
                              headers={"X-ICT-Tenant": "smokecost"})
            deadline = time.time() + 300
            while time.time() < deadline:
                state = json.load(urllib.request.urlopen(
                    f"{base}/jobs/{cost_job['id']}", timeout=10))
                if state.get("state") in TERMINAL:
                    break
                time.sleep(0.05)
            # Conservation off the replica exposition (both in-process
            # replicas share one registry; the sums on both sides cover
            # both, so the identity still holds exactly).  Bounded
            # retry: a job turns terminal (HTTP-visible) a beat before
            # the worker finalizes its cost record, so one read could
            # catch the window; a PERSISTENT violation still fails.
            cost_sum = dispatch_sum = 0.0
            conservation_ok = False
            deadline = time.time() + 60
            while time.time() < deadline and not conservation_ok:
                cost_text = urllib.request.urlopen(
                    f"http://127.0.0.1:{svc_b.port}/metrics",
                    timeout=10).read().decode()
                cost_sum = dispatch_sum = 0.0
                try:
                    for fam in obs_metrics.parse_exposition(cost_text):
                        for name, _labels, raw in fam.samples:
                            if name == "ict_cost_device_seconds_total":
                                cost_sum += obs_metrics.sample_value(raw)
                            elif name == "ict_service_dispatch_s":
                                dispatch_sum += obs_metrics.sample_value(raw)
                except ValueError:
                    break
                conservation_ok = (dispatch_sum > 0 and abs(
                    cost_sum / dispatch_sum - 1.0)
                    <= fleet_costs.CONSERVATION_TOLERANCE)
                if not conservation_ok:
                    time.sleep(0.1)
            router.poll_tick()   # fold the scrape into /fleet/costs
            costs_view = json.load(urllib.request.urlopen(
                f"{base}/fleet/costs", timeout=10))
            tenant_rows = costs_view.get("tenants", {})
            tenant_rows_ok = (
                "smokecost" in tenant_rows
                and tenant_rows["smokecost"].get("device_s", 0) > 0
                and (tenant_rows["smokecost"].get("budget_used_pct") or 0)
                > 100
                and "default" in tenant_rows)
            burn_rule = "tenant_budget_burn:smokecost"
            deadline = time.time() + 60
            while time.time() < deadline:
                if any(a["rule"] == burn_rule
                       for a in router.alerts.firing()):
                    break
                router.poll_tick()
                time.sleep(0.05)
            budget_fired = any(a["rule"] == burn_rule
                               for a in router.alerts.firing())
            # Resolution: stop replica b — once the registry marks it
            # dead, its per-life usage leaves the budget gauge (rebuilt
            # whole from ALIVE replicas) and the rule must resolve.
            svc_b.stop()
            deadline = time.time() + 60
            while time.time() < deadline:
                router.poll_tick()
                if not any(a["rule"] == burn_rule
                           for a in router.alerts.firing()):
                    break
                time.sleep(0.05)
            burn_cycle = [t["state"] for t in router.alerts.recent()
                          if t["rule"] == burn_rule]
            budget_cycle_ok = (budget_fired
                               and burn_cycle[:1] == ["firing"]
                               and "resolved" in burn_cycle)
            costs_ok = (state.get("state") == "done" and conservation_ok
                        and tenant_rows_ok and budget_cycle_ok)
            # Dead-replica provenance: replica b is gone now, so the
            # cost job's replica-backed planes must degrade to
            # "unavailable" (never stale data) while the report itself
            # still answers with the router-side planes.
            _dead_code, dead_exp = router.fleet_explain_job(
                cost_job["id"])
            explain_dead_ok = (
                _dead_code == 200
                and set(dead_exp.get("planes") or {})
                == set(fleet_explain.PLANES)
                and dead_exp["planes"]["zaps"]["source"] == "unavailable"
                and dead_exp["planes"]["cost"]["source"] == "unavailable")
            # --- the trend lane, end to end ---
            # The injected smoke_speed fingerprint watches a synthetic
            # router-registry gauge.  Healthy ticks arm it; a synthetic
            # slowdown must drive sentinel firing -> the
            # perf_regression alert (via the history ring, so one extra
            # tick) -> a trend incident bundle on disk and a live
            # ``GET /fleet/trends`` view of the violation; publishing
            # the healthy figure again must resolve both.
            def _pub_speed(v: float) -> None:
                router.metrics.replace_gauge_family(
                    "fleet_smoke_trend_speed",
                    {(("replica", "smoke-a"),): v})

            def _speed_firing() -> bool:
                return (router.trends is not None
                        and any(f["signal"] == "smoke_speed"
                                for f in router.trends.firing()))

            trend_armed = trend_fired = trend_alert = False
            trend_resolved = trend_view_ok = trend_bundle_ok = False
            if router.trends is not None:
                _pub_speed(10.0)
                deadline = time.time() + 60
                while time.time() < deadline and not trend_armed:
                    router.poll_tick()
                    trend_armed = any(
                        r["signal"] == "smoke_speed" and r["armed"]
                        for r in router.trends.fingerprints_json()
                        ["fingerprints"])
                    time.sleep(0.02)
                _pub_speed(1.0)     # the synthetic slowdown
                deadline = time.time() + 60
                while time.time() < deadline and not (trend_fired
                                                      and trend_alert):
                    router.poll_tick()
                    trend_fired = trend_fired or _speed_firing()
                    trend_alert = any(
                        a["rule"] == "perf_regression"
                        for a in router.alerts.firing())
                    time.sleep(0.02)
                trend_bundle_ok = any(
                    b.get("signal") == "smoke_speed"
                    for b in fleet_trends.list_trend_bundles(
                        router.trends.bundle_dir))
                trends_view = json.load(urllib.request.urlopen(
                    f"{base}/fleet/trends?family=ict_fleet_smoke_trend"
                    f"_speed&resolution=raw", timeout=10))
                trend_view_ok = (
                    trends_view.get("enabled") is not False
                    and any(f["signal"] == "smoke_speed"
                            for f in trends_view.get("firing", []))
                    and len(trends_view.get("series", [])) >= 1)
                _pub_speed(10.0)    # recovery
                deadline = time.time() + 60
                trend_resolved = True
                while time.time() < deadline:
                    router.poll_tick()
                    if not _speed_firing() and not any(
                            a["rule"] == "perf_regression"
                            for a in router.alerts.firing()):
                        break
                    time.sleep(0.02)
                else:
                    trend_resolved = False
            trends_ok = (trend_armed and trend_fired and trend_alert
                         and trend_bundle_ok and trend_view_ok
                         and trend_resolved)
            # A replica that served through the numpy oracle instead of
            # its device fails the smoke, whatever its masks.
            on_device = (health_b.get("backend") == DEVICE_BACKEND
                         and tracing.counters_snapshot().get(
                             "service_oracle_fallbacks", 0)
                         == before_fallbacks)
            ok = (all_done and masks_ok and failovers >= 1
                  and done_delta == len(paths) and on_device
                  and fleet_ok and trace_ok and len(incidents) >= 1
                  and alerts_ok and coalesce_ok and cache_ok
                  and campaign_ok and canary_ok and costs_ok
                  and recorder_ok and explain_ok and explain_dead_ok
                  and trends_ok
                  and health_b.get("audits_run", 0) >= 1
                  and health_b.get("audit_divergences", 0) == 0)
            result = {
                "smoke": "ok" if ok else "FAIL",
                "jobs": len(paths),
                "jobs_done": sum(1 for s in states.values()
                                 if s.get("state") == "done"),
                "completions": int(done_delta),
                "failovers": int(failovers),
                "mask_identical_to_oracle": bool(masks_ok),
                "fleet_metrics_merged_ok": bool(fleet_ok),
                "stitched_trace_ok": bool(trace_ok),
                "incident_bundles": len(incidents),
                "alerts_lane_ok": bool(alerts_ok),
                "alerts_fired": int(alert_fired),
                "alert_bundles": len(bundles),
                "history_ticks": len(history_view["ticks"]),
                "coalesced_dispatches": int(coalesced_dispatches),
                "coalesce_masks_ok": bool(co_masks_ok),
                "fleet_cache_hits": int(fleet_cache_hits),
                "fleet_cache_hit_ok": bool(cache_ok),
                "campaign_lane_ok": bool(campaign_ok),
                "campaign_state": camp_view.get("state"),
                "campaign_archives_done": int(
                    camp_view.get("archives", {}).get("done", 0)),
                "campaign_jobs_delta": int(camp_done_delta),
                "campaign_cache_hits": int(camp_cache_hits),
                "campaign_masks_ok": bool(camp_masks_ok),
                "campaign_device_s": camp_cost.get("device_s"),
                "canary_lane_ok": bool(canary_ok),
                "canary_verdicts": {
                    j: bool(v.get("ok")) for j, v in verdicts.items()},
                "canary_synthetic_excluded": bool(synthetic_excluded),
                "slo_burn_rules_ok": bool(burn_rules_ok),
                "slo_tick": slo_view.get("tick"),
                "recorder_lane_ok": bool(recorder_ok),
                "recorder_segment_entries": len(seg_entries),
                "recorder_excluded": int(rec_stats["excluded_total"]),
                "recorder_replay_rc": int(replay_rc),
                "recorder_replay_dedup_delta": (
                    replay_report.get("dedup_delta")),
                "recorder_jobs_done_unmoved": bool(rec_jobs_done_unmoved),
                "explain_planes_ok": bool(explain_ok),
                "explain_dead_replica_ok": bool(explain_dead_ok),
                "trends_lane_ok": bool(trends_ok),
                "trend_sentinel_fired": bool(trend_fired),
                "trend_alert_fired": bool(trend_alert),
                "trend_bundle_ok": bool(trend_bundle_ok),
                "trend_view_ok": bool(trend_view_ok),
                "trend_resolved": bool(trend_resolved),
                "costs_lane_ok": bool(costs_ok),
                "cost_conservation_ratio": (
                    round(cost_sum / dispatch_sum, 4)
                    if dispatch_sum > 0 else None),
                "cost_tenant_rows_ok": bool(tenant_rows_ok),
                "budget_burn_cycle_ok": bool(budget_cycle_ok),
                "audits_run": health_b.get("audits_run", 0),
                "audit_divergences": health_b.get("audit_divergences", 0),
                "placements": {
                    rid: int(router.metrics.counter_value(
                        "fleet_placements_total", {"replica": rid}))
                    for rid in ("smoke-a", "smoke-b", "smoke-c")},
            }
            return 0 if ok else 1
        finally:
            print(json.dumps(result))
            router.stop()
            svc_b.stop()
            if svc_c is not None:
                svc_c.stop()    # idempotent if the lane already killed it


def run_autoscale_smoke(cfg: FleetConfig) -> int:
    """Offline autoscale self-check (the ``--smoke --autoscale act`` CI
    lane): ONE in-process torch replica behind a router running the
    capacity model + autoscaler in act mode.  An injected same-bucket
    backlog must drive a scale-up to a second (supervisor-spawned,
    in-process) replica; the post-drain idle must drive a
    drain-then-stop scale-down back to one; every job completes (zero
    lost) with masks bit-identical to the numpy oracle; >= 1 scale
    decision bundle lands on disk; and the merged ``GET /fleet/metrics``
    still passes the exact per-replica-sum equality check.  One JSON
    line, rc 0/1."""
    import tempfile
    import urllib.request

    import numpy as np

    from iterative_cleaner_tpu_torch.config import CleanConfig
    from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
    from iterative_cleaner_tpu_torch.io.npz import NpzIO
    from iterative_cleaner_tpu_torch.io.synthetic import make_archive
    from iterative_cleaner_tpu_torch.models.surgical import finalize_weights
    from iterative_cleaner_tpu_torch.obs import tracing
    from iterative_cleaner_tpu_torch.ops.preprocess import preprocess
    from iterative_cleaner_tpu_torch.service.daemon import CleaningService
    from iterative_cleaner_tpu_torch.service.daemon import ServeConfig
    from iterative_cleaner_tpu_torch.service.jobs import TERMINAL

    result = {"smoke": "FAIL"}
    with tempfile.TemporaryDirectory(prefix="ict_autoscale_smoke_") as tmp:
        paths = []
        for i in range(4):
            p = os.path.join(tmp, f"smoke{i}.npz")
            NpzIO().save(make_archive(nsub=4, nchan=16, nbin=64,
                                      seed=300 + i), p)
            paths.append(p)

        def serve_cfg(tag: str, deadline_s: float = 0.2,
                      bucket_cap: int = 0) -> ServeConfig:
            return ServeConfig(
                spool_dir=os.path.join(tmp, f"spool_{tag}"), port=0,
                replica_id=f"smoke-{tag}", deadline_s=deadline_s,
                bucket_cap=bucket_cap, quiet=True, device=cfg.device,
                clean=CleanConfig(backend="torch", quiet=True))

        # The seed replica parks its cubes for a one-second deadline in a
        # bucket wider than the backlog: one card's default bucket holds
        # a single cube and would dispatch each on arrival, draining the
        # backlog before the autoscaler's hysteresis could see it.
        svc = CleaningService(serve_cfg("seed", deadline_s=1.0,
                                        bucket_cap=8))
        svc.start()
        factory = fleet_autoscale.InProcessReplicaFactory(
            lambda rid: serve_cfg(rid))
        # Hermetic overrides (the run_smoke idiom): the replica set, the
        # port, the spool, and the poll loop are the smoke's own (ticks
        # are driven BY HAND for determinism); scaling thresholds drop
        # to a snappy cadence when the operator left them at the
        # defaults, and stay honored otherwise.
        router = FleetRouter(FleetConfig(**{
            **cfg.__dict__,
            "replicas": (f"http://127.0.0.1:{svc.port}",),
            "port": 0,
            "poll_interval_s": 999.0,   # manual, deterministic ticks
            "spool_dir": os.path.join(tmp, "router_spool"),
            "min_replicas": 1,
            "max_replicas": 2,
            "scale_up_polls": (
                2 if cfg.scale_up_polls == FleetConfig.scale_up_polls
                else cfg.scale_up_polls),
            "scale_up_eta_s": (
                0.5 if cfg.scale_up_eta_s == FleetConfig.scale_up_eta_s
                else cfg.scale_up_eta_s),
            "scale_down_polls": (
                3 if cfg.scale_down_polls == FleetConfig.scale_down_polls
                else cfg.scale_down_polls),
            "scale_cooldown_s": (
                1.0 if cfg.scale_cooldown_s == FleetConfig.scale_cooldown_s
                else cfg.scale_cooldown_s),
        }), replica_factory=factory)
        router.start()
        jobs = {}
        try:
            base = f"http://{router.cfg.host}:{router.port}"
            before_done = tracing.counters_snapshot().get(
                "service_jobs_done", 0)
            before_fallbacks = tracing.counters_snapshot().get(
                "service_oracle_fallbacks", 0)

            def submit(p):
                req = urllib.request.Request(
                    f"{base}/jobs",
                    data=json.dumps({"path": p,
                                     "shape": [4, 16, 64]}).encode(),
                    headers={"Content-Type": "application/json"})
                return json.load(urllib.request.urlopen(req, timeout=30))

            # Phase 1 — inject a same-bucket backlog (the seed's deadline
            # holds the bucket, so the queue genuinely sits; with no
            # service rate measured yet its drain ETA reads infinite)
            # and tick
            # until the autoscaler acts: a second replica must join.
            for p in paths:
                jobs[p] = submit(p)
            scaled_up = False
            deadline = time.time() + 300
            while time.time() < deadline:
                router.poll_tick()
                if len(router.registry.snapshot()) >= 2:
                    scaled_up = True
                    break
                time.sleep(0.05)
            # Phase 2 — more traffic lands on the grown fleet; every job
            # must turn terminal through the router.
            extra = []
            for i in range(2):
                p = os.path.join(tmp, f"extra{i}.npz")
                NpzIO().save(make_archive(nsub=4, nchan=16, nbin=64,
                                          seed=400 + i), p)
                extra.append(p)
                jobs[p] = submit(p)
            states = {}
            deadline = time.time() + 300
            while time.time() < deadline:
                router.poll_tick()
                states = {p: json.load(urllib.request.urlopen(
                    f"{base}/jobs/{j['id']}", timeout=10))
                    for p, j in jobs.items()}
                if all(s.get("state") in TERMINAL for s in states.values()):
                    break
                time.sleep(0.05)
            all_done = all(s.get("state") == "done"
                           for s in states.values())
            masks_ok = all_done
            if all_done:
                cfg_np = CleanConfig(backend="numpy")
                for p in jobs:
                    want, _nbs, _nbc = finalize_weights(
                        clean_cube(*preprocess(NpzIO().load(p)),
                                   cfg_np).weights, cfg_np)
                    got = NpzIO().load(states[p]["out_path"])
                    if not np.array_equal(got.weights, want):
                        masks_ok = False
            done_delta = tracing.counters_snapshot().get(
                "service_jobs_done", 0) - before_done
            # Phase 3 — sustained idle: the scaler must drain-then-stop
            # the managed replica (back to the one seed replica).
            scaled_down = False
            deadline = time.time() + 300
            while time.time() < deadline:
                router.poll_tick()
                managed = (router.supervisor.managed()
                           if router.supervisor else {})
                if (managed
                        and all(s == "stopped" for s in managed.values())
                        and len(router.registry.snapshot()) == 1):
                    scaled_down = True
                    break
                time.sleep(0.05)
            up_events = router.metrics.counter_value(
                "fleet_scale_events_total",
                {"direction": "up", "reason": "backlog"})
            down_events = router.metrics.counter_value(
                "fleet_scale_events_total",
                {"direction": "down", "reason": "idle"})
            bundles = [b for b in fleet_obs.list_incidents(
                router.incident_dir)
                if str(b.get("reason", "")).startswith("scale_")]
            # The merged federation view must still hold exactly, and
            # the capacity gauges the decisions are explained by must be
            # on it.
            fleet_text = urllib.request.urlopen(
                f"{base}/fleet/metrics", timeout=10).read().decode()
            fleet_ok = False
            capacity_ok = False
            try:
                fams = obs_metrics.parse_exposition(fleet_text)
            except ValueError:
                fams = []
            if fams:
                fleet_ok = _merged_counters_equal(fams)
                names = {fam.name for fam in fams}
                capacity_ok = (
                    any(n.startswith("ict_fleet_capacity_")
                        for n in names)
                    and "ict_fleet_backlog_eta_seconds" in names
                    and "ict_fleet_scale_events_total" in names)
            seed_health = json.load(urllib.request.urlopen(
                f"http://127.0.0.1:{svc.port}/healthz", timeout=10))
            on_device = (seed_health.get("backend") == DEVICE_BACKEND
                         and tracing.counters_snapshot().get(
                             "service_oracle_fallbacks", 0)
                         == before_fallbacks)
            ok = (scaled_up and scaled_down and all_done and masks_ok
                  and done_delta == len(jobs) and on_device
                  and up_events >= 1 and down_events >= 1
                  and len(bundles) >= 1 and fleet_ok and capacity_ok)
            result = {
                "smoke": "ok" if ok else "FAIL",
                "jobs": len(jobs),
                "jobs_done": sum(1 for s in states.values()
                                 if s.get("state") == "done"),
                "completions": int(done_delta),
                "scaled_up": bool(scaled_up),
                "scaled_down": bool(scaled_down),
                "scale_up_events": int(up_events),
                "scale_down_events": int(down_events),
                "scale_decision_bundles": len(bundles),
                "mask_identical_to_oracle": bool(masks_ok),
                "fleet_metrics_merged_ok": bool(fleet_ok),
                "capacity_gauges_ok": bool(capacity_ok),
            }
            return 0 if ok else 1
        finally:
            print(json.dumps(result))
            router.stop()
            svc.stop()


def fleet_main(argv: list[str] | None = None) -> int:
    args = build_fleet_parser().parse_args(argv)
    try:
        cfg = fleet_config_from_args(args)
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    if args.smoke:
        # --smoke --autoscale act runs the elastic-scaling self-check
        # (backlog-driven scale-up, drain-then-stop scale-down); the
        # plain smoke keeps covering placement/failover/federation.
        if cfg.autoscale == "act":
            return run_autoscale_smoke(cfg)
        return run_fleet_smoke(cfg)
    try:
        router = FleetRouter(cfg)
    except (RuntimeError, OSError, ValueError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    # SIGTERM/SIGINT dump the router's flight ring before the graceful
    # stop — the same handler shape as serve_main: "what was the router
    # doing when the orchestrator killed it" becomes a file under
    # <spool>/flight instead of a guess (docs/OBSERVABILITY.md "Fleet
    # observability").  Installed BEFORE start(): an orchestrator that
    # signals the moment the startup line appears must hit the handler,
    # not the default disposition (the window used to lose rare races).
    import signal

    def _on_stop_signal(signum, frame):
        name = signal.Signals(signum).name
        path = flight.dump(name, router.flight_dir)
        print(f"ict-fleet: {name} — shutting down (replicas keep their "
              "accepted work; placements resume on restart via replica "
              f"spools{'; flight ring at ' + path if path else ''})",
              file=sys.stderr)
        raise SystemExit(0)

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _on_stop_signal)
        except (ValueError, OSError):  # noqa: PERF203 — non-main-thread embed
            pass
    try:
        router.start()
    except (RuntimeError, OSError, ValueError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        # Reached only when the SIGINT handler could not be installed (a
        # non-main-thread embed): same graceful stop, same flight dump.
        path = flight.dump("KeyboardInterrupt", router.flight_dir)
        print("ict-fleet: shutting down"
              f"{' (flight ring at ' + path + ')' if path else ''}",
              file=sys.stderr)
    finally:
        router.stop()
    return 0


def console_main() -> int:
    return fleet_main(sys.argv[1:])


if __name__ == "__main__":
    raise SystemExit(fleet_main())
