"""ReplicaContext: one serving replica's identity + shared mutable state.

A copy of ``iterative_cleaner_tpu/service/context.py``; the device backend
mode is ``"torch"`` where the JAX package's is ``"jax"``.

Before the fleet tier, :class:`~.daemon.CleaningService` owned every
piece of per-daemon state directly and the scheduler/worker/pool
reached back through the service object — workable for one daemon per
process, but the fleet tests (and the ``serve-fleet --smoke`` lane)
stand up 3+ replicas in ONE process, so anything per-replica must live
on an explicit context object passed in, never reached through a
process-global (or implicitly-singular service) reference.  The
context carries:

- **identity** — ``replica_id`` (``--replica_id`` or minted), echoed on
  ``/healthz`` and every ``POST /jobs`` 202 so trace logs attribute
  jobs to replicas;
- **the job index** — the in-memory open-job table plus the
  idempotency-key map the fleet router's failover path relies on (a
  re-routed job re-submitted with the same ``idempotency_key`` dedupes
  against the accepted original instead of running twice);
- **the demotion state machine** — backend mode, consecutive dispatch
  failures, confirmed audit divergences (moved verbatim from the
  daemon; the count-then-demote transition stays atomic under one
  lock).  A replica on the card (``on_card``) counts them but never
  demotes: its failures fail jobs instead of moving them to numpy;
- **the drain flag** — set via ``POST /drain``; a draining replica
  refuses new admissions (503) and reports ``draining: true`` on
  ``/healthz`` so the router stops placing on it while it finishes
  accepted work.

The dispatch worker and warm pool are constructed from a context alone
(``DispatchWorker(ctx)`` / ``WarmPool(ctx, cap)``); the daemon keeps
only lifecycle (threads, HTTP server, scheduler wiring).
"""

from __future__ import annotations

import os
import sys
import threading
import time
import uuid

from iterative_cleaner_tpu_torch.obs import flight, tracing
from iterative_cleaner_tpu_torch.service.jobs import TERMINAL, Job, JobSpool
from iterative_cleaner_tpu_torch.utils import backoff


class ServiceBusy(RuntimeError):
    """Admission refused: the open-job cap is reached, or the replica is
    draining (the API maps this to 503 + Retry-After).  The cap is the
    daemon's backpressure — every open job can hold one decoded f32
    cube on host, so unbounded admission would let a submission burst
    outrun the single dispatch thread and OOM."""


def new_replica_id() -> str:
    """Short stable-enough identity for one replica process; operators
    pin ``--replica_id`` in real fleets, tests and smoke runs mint."""
    return f"r-{uuid.uuid4().hex[:8]}"


class ReplicaContext:
    """Everything per-replica that more than one service component
    touches.  Constructed once per replica, before any thread starts;
    the daemon, worker, pool, and HTTP handlers all hold the same
    instance."""

    def __init__(self, serve_cfg, mesh=None) -> None:
        self.serve_cfg = serve_cfg
        self.clean_cfg = serve_cfg.clean
        self.replica_id = serve_cfg.replica_id or new_replica_id()
        self.spool = JobSpool(serve_cfg.spool_dir)
        self.mesh = mesh
        # The torch backend's device: the mesh's, the sessions' passes and
        # the profiler captures'.
        self.device = serve_cfg.device
        # A replica whose cubes live on the card never hands them to the
        # plain numpy route: a failed bucket fails its jobs, and the
        # demotions below keep the backend (they stay for --device cpu
        # and --backend numpy, as in the JAX daemon).
        self.on_card = self.device.split(":")[0] == "cuda"
        # Demotion state ("torch" | "numpy") is written by two paths (the
        # dispatch worker's note_dispatch_failure, the shadow auditor's
        # note_audit_divergence) and read everywhere:
        # one lock makes the count-then-demote transition atomic, so two
        # racing failure reports can neither lose an increment nor
        # double-fire the demotion side effects (flight dump, stderr).
        self._mode_lock = threading.Lock()
        self.backend_mode = self.clean_cfg.backend  # ict: guarded-by(self._mode_lock)
        self._consecutive_failures = 0  # ict: guarded-by(self._mode_lock)
        self._audit_divergences = 0  # ict: guarded-by(self._mode_lock)
        self.draining = False  # ict: guarded-by(self._mode_lock)
        # RLock, deliberately: the idempotency-map trim takes it lexically
        # (the ICT007 discipline) while its callers already hold it.
        self._jobs_lock = threading.RLock()
        self._jobs: dict[str, Job] = {}  # ict: guarded-by(self._jobs_lock)
        # idempotency key -> job id; survives retire() (the key must keep
        # deduping after the job turns terminal and leaves _jobs — the
        # spool manifest is the durable record the daemon resolves).
        self._idem: dict[str, str] = {}  # ict: guarded-by(self._jobs_lock)
        # Full-jitter retry schedule for this replica's dispatch ladder
        # (utils/backoff.py; ICT_BACKOFF_SEED makes it deterministic).
        self.backoff_rng = backoff.make_rng()
        # Device-level observability artifacts live under the spool (the
        # single-daemon flock already covers it).
        self.profile_root = os.path.join(serve_cfg.spool_dir, "profiles")
        self.flight_dir = os.path.join(serve_cfg.spool_dir, "flight")
        self.repro_dir = os.path.join(serve_cfg.spool_dir, "repro")
        # Content-addressed result cache (service/results_cache.py; keys
        # from ingest/cas.py): per-replica by construction — fleet tests
        # run several replicas per process, and one replica's cache must
        # not answer for another's config.  Persisted next to the job
        # index so a restart keeps answering yesterday's campaign.
        from iterative_cleaner_tpu_torch.ingest import cas
        from iterative_cleaner_tpu_torch.service.results_cache import ResultCache

        self.result_cache = ResultCache(
            getattr(serve_cfg, "result_cache", 0),
            root=os.path.join(serve_cfg.spool_dir, "results-cache"))
        # The replica's config/version salt, advertised on /healthz and
        # stamped on every manifest: the fleet router's cache only
        # answers a submission when every candidate replica agrees on it.
        self.cache_salt = cas.cache_salt(self.clean_cfg)
        # The cost-accounting ledger (obs/costs.py): per-replica by
        # construction (fleet tests run several replicas per process),
        # spool-persisted next to the job index so a restart resumes the
        # lifetime showback record.
        from iterative_cleaner_tpu_torch.obs.costs import CostLedger

        self.cost_ledger = CostLedger(
            os.path.join(serve_cfg.spool_dir, "costs.json"),
            replica_id=self.replica_id)
        # The shadow auditor; assigned once by the daemon during start(),
        # before any worker thread runs.
        self.auditor = None

    # --- job index ---

    def admit(self, job: Job, idempotency_key: str = "") -> str | None:
        """Cap-check and insert under ONE lock hold (concurrent POST
        handler threads must not all pass the check before any inserts —
        the cap is the OOM backpressure).  Returns None when ``job`` was
        admitted, or the id of the already-admitted job holding the same
        idempotency key (the caller resolves it, possibly via the
        spool)."""
        with self._jobs_lock:
            if idempotency_key:
                known = self._idem.get(idempotency_key)
                if known is not None:
                    return known
            if self.serve_cfg.max_open_jobs:
                # retire() evicts terminal jobs, so this scan is O(open).
                open_n = sum(1 for j in self._jobs.values()
                             if j.state not in TERMINAL)
                if open_n >= self.serve_cfg.max_open_jobs:
                    tracing.count("service_jobs_refused")
                    raise ServiceBusy(
                        f"{open_n} open jobs at the --max_open_jobs cap "
                        f"({self.serve_cfg.max_open_jobs}); retry later")
            self._jobs[job.id] = job
            if idempotency_key:
                self._idem[idempotency_key] = job.id
                self._trim_idem_locked()
        return None

    def rollback(self, job: Job, idempotency_key: str = "") -> None:
        """Undo a failed admission (the spool save threw): a job that was
        never made durable is also never enqueued, so leaving it indexed
        would leak one max_open_jobs slot per failed save."""
        with self._jobs_lock:
            self._jobs.pop(job.id, None)
            if idempotency_key and self._idem.get(idempotency_key) == job.id:
                del self._idem[idempotency_key]

    def index(self, job: Job) -> None:
        """Insert without the cap check — the startup replay path (spool
        recovery runs before the API opens, so the cap can't be raced)."""
        with self._jobs_lock:
            self._jobs[job.id] = job
            if job.idem_key:
                self._idem[job.idem_key] = job.id
                self._trim_idem_locked()

    def remember_idem(self, job: Job) -> None:
        """Replay-time idempotency rebuild: terminal manifests keep their
        keys deduping across a replica restart (a router failover retry
        of a job that in fact finished must get the finished manifest,
        not a second run)."""
        if not job.idem_key:
            return
        with self._jobs_lock:
            self._idem.setdefault(job.idem_key, job.id)
            self._trim_idem_locked()

    def _trim_idem_locked(self) -> None:
        """Bound the idempotency map.  Keys must outlive retire() — but
        NOT the spool manifests they resolve to: beyond ``spool_keep``
        retained manifests a key can only dedupe onto a pruned job (an
        error anyway), so evicting the oldest non-open entries at that
        point keeps a continuous-traffic replica's memory bounded (the
        fleet router mints a key for EVERY submission) without ever
        dropping a key that still dedupes.  Takes the (reentrant) jobs
        lock itself so the eviction stays lexically guarded; every
        caller already holds it."""
        with self._jobs_lock:
            cap = max(int(self.serve_cfg.spool_keep), 0)
            excess = len(self._idem) - cap
            if excess <= 0:
                return
            evictable = sorted(
                (jid, key) for key, jid in self._idem.items()
                if jid not in self._jobs)   # open jobs keep their keys
            for _jid, key in evictable[:excess]:
                del self._idem[key]

    def idem_job_id(self, key: str) -> str | None:
        with self._jobs_lock:
            return self._idem.get(key)

    def lookup(self, job_id: str) -> Job | None:
        with self._jobs_lock:
            return self._jobs.get(job_id)

    def retire(self, job: Job) -> None:
        """Drop a terminal job from the in-memory index — the spool
        manifest is the durable record, so a continuous-traffic replica's
        memory stays bounded by OPEN work.  The idempotency mapping
        deliberately survives (see _idem)."""
        with self._jobs_lock:
            self._jobs.pop(job.id, None)

    def open_count(self) -> int:
        with self._jobs_lock:
            return sum(1 for j in self._jobs.values()
                       if j.state not in TERMINAL)

    def all_terminal(self) -> bool:
        with self._jobs_lock:
            return all(j.state in TERMINAL for j in self._jobs.values())

    # --- drain flag ---

    def set_draining(self, flag: bool) -> None:
        with self._mode_lock:
            self.draining = bool(flag)

    def is_draining(self) -> bool:
        with self._mode_lock:
            return self.draining

    # --- demotion state machine (moved verbatim from the daemon) ---

    def note_dispatch_ok(self) -> None:
        with self._mode_lock:
            self._consecutive_failures = 0

    def note_dispatch_failure(self, exc) -> None:
        # Count-then-demote under the mode lock (the worker and auditor
        # threads both reach the demotion transition); side effects fire
        # outside it, exactly once, on the thread that flipped the mode.
        with self._mode_lock:
            self._consecutive_failures += 1
            n_failures = self._consecutive_failures
            demote = (self.backend_mode == "torch" and not self.on_card
                      and n_failures >= self.serve_cfg.demote_after)
            if demote:
                self.backend_mode = "numpy"
        if demote:
            tracing.count("service_backend_demotions")
            # The top rung of the fault ladder: dump the flight ring — the
            # post-mortem of what led to a service-wide demotion is worth
            # a file even when nobody configured telemetry.
            flight.note("service_demoted", error=str(exc),
                        replica_id=self.replica_id)
            flight.dump(f"service_demotion: {exc}", self.flight_dir)
            print(f"ict-serve[{self.replica_id}]: {n_failures} consecutive "
                  f"bucket dispatches failed (last: {exc}); demoting the "
                  "service to the numpy oracle backend", file=sys.stderr)

    def note_audit_divergence(self, record: dict) -> None:
        """The shadow auditor confirmed a served mask differed from the
        oracle.  Repeated confirmed divergences demote the service the
        same way repeated dispatch failures do: a route that keeps
        producing wrong masks is worse than a route that keeps
        crashing."""
        with self._mode_lock:
            self._audit_divergences += 1
            n_div = self._audit_divergences
            demote = (self.backend_mode == "torch" and not self.on_card
                      and n_div >= self.serve_cfg.demote_after)
            if demote:
                self.backend_mode = "numpy"
        if demote:
            tracing.count("service_backend_demotions")
            flight.note("service_demoted_audit",
                        n_divergences=n_div,
                        job_id=record.get("job_id", ""),
                        replica_id=self.replica_id)
            flight.dump(f"audit_divergence_demotion: "
                        f"{n_div} confirmed divergences "
                        f"(last: job {record.get('job_id', '?')})",
                        self.flight_dir)
            print(f"ict-serve[{self.replica_id}]: {n_div} confirmed audit "
                  "divergences vs the numpy oracle; demoting the service "
                  "to the oracle backend (repro bundles under "
                  f"{self.repro_dir})", file=sys.stderr)

    # --- policy reads ---

    def audit_rate(self) -> float:
        """The effective shadow-audit sampling fraction: an explicit
        --audit_rate wins; < 0 honors ICT_AUDIT_RATE (default 0)."""
        from iterative_cleaner_tpu_torch.obs import audit as obs_audit

        if self.serve_cfg.audit_rate >= 0:
            return min(self.serve_cfg.audit_rate, 1.0)
        return obs_audit.audit_rate()

    def new_job(self, path: str, profile: bool = False, audit: bool = False,
                idempotency_key: str = "", trace_id: str = "",
                tenant: str = "", synthetic: bool = False) -> Job:
        """Mint one job record.  The trace context is minted HERE unless
        the submitter carried one across the router hop (X-ICT-Trace) —
        either way it rides the job through every layer and is echoed in
        the 202 response."""
        from iterative_cleaner_tpu_torch.obs import events
        from iterative_cleaner_tpu_torch.service.jobs import new_job_id

        return Job(id=new_job_id(), path=path, submitted_s=time.time(),
                   trace_id=trace_id or events.new_trace_id(),
                   profile=bool(profile), audit=bool(audit),
                   idem_key=idempotency_key, tenant=tenant,
                   synthetic=bool(synthetic))
