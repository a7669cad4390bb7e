"""Daemon lifecycle + the ``ict-serve-torch`` CLI.

A port of ``iterative_cleaner_tpu/service/daemon.py``: ``CleaningService``,
``ServeConfig``, ``serve_main``, ``run_smoke`` and ``console_main``.  The
JAX daemon's device backend ``"jax"`` is the port's ``"torch"`` on
``--device`` (default ``cuda``; ``cpu`` runs the plain versions of the
kernels), its mesh is ``parallel/multihost.local_mesh`` of that device
(every card of the process for ``cuda``, one for ``cuda:N``),
and its wedge guard the port's ``utils/device_probe``.  Loader threads
preprocess on the host with ``ops/preprocess.preprocess``, which prefers
the native runtime.

Thread layout (all daemonic; ``stop()`` is graceful):

- N loader threads: decode + preprocess submitted archives (host-side,
  independent per file — the parallel/batch thread-pool idiom) and offer
  the cubes to the shape-bucketed scheduler;
- 1 tick thread: fires the scheduler's deadline flushes;
- 1 dispatch worker: runs flushed buckets on the mesh (service/worker.py);
- the ThreadingHTTPServer's per-request threads (service/api.py).

Jobs the daemon accepted but had not finished when it died stay in the
on-disk spool as ``pending``/``running`` manifests; the next start replays
them (service/jobs.py), so a restart loses no accepted work.

``python -m iterative_cleaner_tpu_torch serve --smoke`` runs the whole stack
against one synthetic archive over real HTTP and verifies the returned
mask bit-identical to the numpy oracle — the offline health check CI and
operators share.
"""

from __future__ import annotations

import argparse
import os
import queue
import sys
import threading
import time
from dataclasses import dataclass, field

from iterative_cleaner_tpu_torch.config import CleanConfig
from iterative_cleaner_tpu_torch.obs import (
    events,
    flight,
    memory as obs_memory,
    tracing,
)
from iterative_cleaner_tpu_torch.service.context import (  # noqa: F401 — ServiceBusy
    ReplicaContext,                  # re-exported for compatibility: the
    ServiceBusy,                     # API layer and embedders import it here
)
from iterative_cleaner_tpu_torch.service.jobs import TERMINAL, Job
from iterative_cleaner_tpu_torch.service.scheduler import (
    ShapeBucketScheduler,
    bucket_label,
)
from iterative_cleaner_tpu_torch.service.worker import DispatchWorker

_STOP = object()

#: Serializes the loader pool's one-time lazy imports (torch, the native
#: runtime) — see the comment in :meth:`CleaningService._load_loop`.
_LOADER_IMPORT_LOCK = threading.Lock()


@dataclass
class ServeConfig:
    spool_dir: str = "./ict_serve_spool"
    host: str = "127.0.0.1"
    port: int = 8750                 # 0 = ephemeral (tests)
    replica_id: str = ""             # fleet identity on /healthz and every
                                     # 202; "" = mint one per process life
    bucket_cap: int = 0              # 0 = the mesh's dp extent
    coalesce: int = 1                # coalescing rung:
                                     # pow2 factor on the flush threshold —
                                     # one dispatch packs dp_cap x coalesce
                                     # same-shape cubes, each device
                                     # vmapping `coalesce` archives
    result_cache: int = 256          # content-addressed result cache
                                     # entries kept per replica (0 = off;
                                     # ingest/cas.py keys, persisted under
                                     # <spool>/results-cache)
    deadline_s: float = 2.0          # max wait before a partial bucket flushes
    loaders: int = 2
    warm_shapes: tuple = ()          # (nsub, nchan, nbin) classes to precompile
    dispatch_retries: int = 2
    retry_backoff_s: float = 0.25
    demote_after: int = 2            # consecutive bucket failures -> oracle mode
    spool_keep: int = 10000          # terminal manifests kept as job history
    max_open_jobs: int = 64          # admission cap (0 = unbounded): bounds
                                     # decoded-cube host residency; size it
                                     # to host RAM / cube size
    alert_iters: int = 2             # streaming sessions: bounded provisional
                                     # clean-pass iterations per block
    root: str = ""                   # when set, submitted paths must resolve
                                     # under this directory (the non-loopback
                                     # trust boundary)
    telemetry: str = ""              # JSON-lines event-log path (obs/events);
                                     # "" = honor ICT_TELEMETRY / disabled
    audit_rate: float = -1.0         # shadow-oracle audit sampling fraction
                                     # (obs/audit): < 0 = honor the
                                     # ICT_AUDIT_RATE env (default 0); a
                                     # per-job {"audit": true} always audits
    quiet: bool = False
    device: str = "cuda"             # the torch backend's device ("cpu"
                                     # runs the kernels' plain versions)
    clean: CleanConfig = field(
        default_factory=lambda: CleanConfig(backend="torch"))


class CleaningService:
    """The persistent cleaning daemon; see the module docstring for the
    thread layout (the operator contract is the JAX daemon's)."""

    def __init__(self, serve_cfg: ServeConfig, mesh=None) -> None:
        self.serve_cfg = serve_cfg
        self.clean_cfg = serve_cfg.clean
        # ALL per-replica mutable state (job index, idempotency map,
        # demotion machine, drain flag) lives on the explicit context —
        # the scheduler/worker/pool are constructed from it alone, so N
        # replicas coexist in one process (service/context.py).  This
        # object keeps only lifecycle: threads, the HTTP server, wiring.
        self.ctx = ReplicaContext(serve_cfg, mesh=mesh)
        self.started_s = time.time()   # re-stamped at start(); /healthz uptime
        self.bucket_cap = 1
        self.port = serve_cfg.port
        self.pool = None
        self._load_q: queue.Queue = queue.Queue()
        self._threads: list[threading.Thread] = []
        self._stop_evt = threading.Event()
        self._server = None
        self.scheduler = None
        self.worker = None
        self.sessions = None

    # Compatibility views onto the context (tests and embedders predate
    # the ReplicaContext split; the context is the single owner).
    @property
    def spool(self):
        return self.ctx.spool

    @property
    def mesh(self):
        return self.ctx.mesh

    @property
    def replica_id(self) -> str:
        return self.ctx.replica_id

    @property
    def backend_mode(self) -> str:
        return self.ctx.backend_mode

    @property
    def auditor(self):
        return self.ctx.auditor

    @property
    def profile_root(self) -> str:
        return self.ctx.profile_root

    @property
    def flight_dir(self) -> str:
        return self.ctx.flight_dir

    @property
    def repro_dir(self) -> str:
        return self.ctx.repro_dir

    @property
    def _jobs(self):
        return self.ctx._jobs

    @property
    def _jobs_lock(self):
        return self.ctx._jobs_lock

    # --- lifecycle ---

    def start(self) -> None:
        # Single-daemon guard FIRST: a second daemon on the same spool
        # would sweep this one's atomic-write temps and re-dispatch its
        # running jobs before even failing to bind the port.
        self.spool.acquire_exclusive()
        try:
            self._start_locked()
        except BaseException:
            # A mid-start failure (e.g. EADDRINUSE at the HTTP bind, after
            # warmup and spool replay) must not leak the flock or the
            # already-started threads — a corrected retry on the same
            # spool would otherwise see "already served" from a dead
            # service object.
            try:
                self.stop()
            except Exception:  # noqa: BLE001 — surface the original error
                pass
            raise

    def _start_locked(self) -> None:
        self.started_s = time.time()
        # Unconditional: telemetry="" must MEAN "honor ICT_TELEMETRY /
        # disabled" (the ServeConfig contract) even when an earlier
        # service in this process configured an explicit sink — a
        # restarted daemon must not silently inherit its predecessor's
        # log file.
        events.configure(self.serve_cfg.telemetry or None)
        flight.note("daemon_starting", spool=self.spool.root,
                    backend=self.backend_mode,
                    replica_id=self.replica_id)
        if self.backend_mode == "torch" and self.ctx.on_card:
            # The wedge guard (utils/device_probe.py): a CUDA
            # initialisation that hangs through the probe means the next
            # CUDA call may hang the daemon.  The JAX daemon demotes to the
            # numpy oracle here; a replica on the card refuses to start
            # instead, so it never serves its cubes off the card.  (Kernel
            # builds are accounted on /metrics by ops/cuda_build.)
            from iterative_cleaner_tpu_torch.utils.device_probe import (
                ensure_responsive_backend,
            )

            if ensure_responsive_backend() == "hang":
                raise RuntimeError(
                    "ict-serve: CUDA liveness indeterminable after a hung "
                    f"probe of {self.serve_cfg.device}; not starting")
        # An explicit --bucket_cap is honored on EVERY backend (a numpy
        # replica in a fleet test can park cubes in a wide bucket); the
        # default stays backend-dependent: the mesh's dp extent for torch
        # (the local cards' for cuda, 1 for one card), 1 for the oracle.
        cap = self.serve_cfg.bucket_cap or 1
        if self.backend_mode == "torch":
            if self.ctx.mesh is None:
                from iterative_cleaner_tpu_torch.parallel.multihost import local_mesh
                from iterative_cleaner_tpu_torch.utils.device_probe import (
                    init_watchdog,
                )

                # make_mesh is this daemon's first in-process device read;
                # the watchdog turns a wedged CUDA initialisation into a
                # structured warning (ICT_INIT_TIMEOUT_S) instead of a
                # silent never-came-up.
                with init_watchdog("serve cuda init"):
                    self.ctx.mesh = local_mesh(self.serve_cfg.device)
            cap = self.serve_cfg.bucket_cap or max(
                int(self.ctx.mesh.shape["dp"]), 1)
        self.scheduler = ShapeBucketScheduler(
            cap, self.serve_cfg.deadline_s, self._on_flush,
            coalesce=self.serve_cfg.coalesce)
        # The pow2 clamp lives in the scheduler (the mechanism that owns
        # the invariant); the warm pool reads the clamped value so the
        # precompiled batch-size set matches the sizes actually emitted.
        self.bucket_cap = self.scheduler.bucket_cap
        if self.backend_mode == "torch":
            from iterative_cleaner_tpu_torch.service.pool import WarmPool

            self.pool = WarmPool(self.ctx, self.bucket_cap)
            self.pool.warm_startup(self.serve_cfg.warm_shapes)
        from iterative_cleaner_tpu_torch.service.sessions import SessionManager

        # Streaming sessions: spool-backed under the job spool, so the single-daemon flock covers them
        # and a restart finds the replay log in place.  The cfg_provider
        # re-reads backend_mode on every session touch, so a RUNTIME
        # service-wide demotion (note_dispatch_failure; never on the card)
        # reaches streaming passes too.
        self.sessions = SessionManager(
            os.path.join(self.serve_cfg.spool_dir, "sessions"),
            self.clean_cfg.replace(backend=self.backend_mode),
            alert_iters=self.serve_cfg.alert_iters,
            quiet=self.serve_cfg.quiet,
            cfg_provider=lambda: self.clean_cfg.replace(
                backend=self.backend_mode),
            device=self.serve_cfg.device)
        self.worker = DispatchWorker(self.ctx)
        # Spool trim + replay run BEFORE any thread starts: the trim's
        # .json.part sweep is only safe while no writer thread exists (the
        # invariant jobs.trim documents), and the worker object's _fail
        # needs no running thread.  One directory scan feeds both halves —
        # with a 10k-manifest history, scanning twice would double the
        # pre-API startup I/O.  Replayed jobs just queue; the loaders
        # drain them once started below.
        spooled = self.spool.all_jobs()
        self.spool.trim(self.serve_cfg.spool_keep, jobs=spooled)
        # The idempotency map is rebuilt over EVERY manifest, terminal
        # included: a router failover retry of a job that in fact
        # finished before the restart must dedupe to the finished
        # manifest, never trigger a second run.
        for job in spooled:
            self.ctx.remember_idem(job)
        # Recovered jobs keep their original (older, time-sortable) ids,
        # so they drain ahead of new traffic of the same shape.
        for job in self.spool.recover(jobs=spooled):
            self.ctx.index(job)
            try:
                # Replayed manifests are re-validated against the CURRENT
                # --root (the boundary may have changed across restarts,
                # and old manifests predate it).
                job.path = self._check_root(job.path)
            except ValueError as exc:
                self.worker._fail(job, str(exc))
                continue
            self._load_q.put(job)
            tracing.count("service_jobs_recovered")
        # The shadow auditor always exists (a per-job {"audit": true} must
        # work even at rate 0); idle it is one blocked queue.get.  Started
        # HERE, after the trim/replay block above, because _audit_one
        # writes spool manifests — the trim's .part sweep is only safe
        # while no writer thread exists (the invariant jobs.trim
        # documents).
        from iterative_cleaner_tpu_torch.obs.audit import ShadowAuditor

        # Pre-register the correctness-health counters at 0 so they are
        # PRESENT on the exposition from the first scrape.  The fleet's
        # critical alert rules (audit_divergence, backend_demoted) are
        # gt-0 thresholds over these series; a lazily-registered counter
        # would vanish across a clean restart and freeze-on-missing
        # would pin an already-fired alert forever instead of resolving
        # it against the restarted replica's explicit 0.
        tracing.count("audit_divergences", 0)
        tracing.count("service_backend_demotions", 0)
        # Same lesson for the cost-accounting plane: every
        # ict_cost_* family is registered at 0 before the first scrape,
        # so the fleet's tenant-budget gt-thresholds can resolve against
        # a restarted replica's explicit 0 instead of freezing on a
        # missing series.  The ledger itself resumes its spool-persisted
        # lifetime aggregates separately (GET /costs).
        self.ctx.cost_ledger.register_counters()
        self.ctx.auditor = ShadowAuditor(
            self.spool, self.repro_dir,
            on_divergence=self.ctx.note_audit_divergence,
            quiet=self.serve_cfg.quiet)
        self.ctx.auditor.start()
        self._threads.append(self.ctx.auditor)
        self.worker.start()
        self._threads.append(self.worker)
        for i in range(max(self.serve_cfg.loaders, 1)):
            th = threading.Thread(target=self._load_loop, daemon=True,
                                  name=f"ict-serve-load-{i}")
            th.start()
            self._threads.append(th)
        th = threading.Thread(target=self._tick_loop, daemon=True,
                              name="ict-serve-tick")
        th.start()
        self._threads.append(th)
        from iterative_cleaner_tpu_torch.service.api import make_http_server

        self._server = make_http_server(
            self, self.serve_cfg.host, self.serve_cfg.port)
        self.port = self._server.server_address[1]
        th = threading.Thread(target=self._server.serve_forever, daemon=True,
                              name="ict-serve-http")
        th.start()
        self._threads.append(th)
        if not self.serve_cfg.quiet:
            print(f"ict-serve: replica {self.replica_id} listening on "
                  f"http://{self.serve_cfg.host}:{self.port} "
                  f"(backend={self.backend_mode}, bucket_cap="
                  f"{self.bucket_cap}, spool={self.spool.root})",
                  file=sys.stderr)

    def stop(self) -> None:
        """Graceful stop: the API closes, threads drain their queues' poison
        pills, and any still-unfinished job stays in the spool for the next
        life (restart-resume is the durability story, not a shutdown barrier)."""
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
        self._stop_evt.set()
        for _ in range(max(self.serve_cfg.loaders, 1)):
            self._load_q.put(_STOP)
        if self.worker is not None:
            self.worker.stop()
        if self.auditor is not None:
            self.auditor.stop()
        stuck = []
        for th in self._threads:
            th.join(timeout=10)
            if th.is_alive():
                stuck.append(th.name)
        # The showback record survives the shutdown (restart-resume is
        # the ledger's contract too): flushed AFTER the worker joins, so
        # the last served jobs' records make it to disk; a no-op when
        # nothing is dirty.
        self.ctx.cost_ledger.flush()
        if stuck:
            # A live thread may still be WRITING spool manifests; releasing
            # the flock would let a successor daemon's .part sweep and
            # running-job replay race it (the exclusivity trim() depends
            # on).  Keep the lock — the kernel frees it at process exit.
            print(f"ict-serve: threads still running after stop "
                  f"({', '.join(stuck)}); keeping the spool lock until "
                  "process exit", file=sys.stderr)
        else:
            self.spool.release_exclusive()

    # --- submission / inspection (the API's surface) ---

    def submit(self, path: str, profile: bool = False,
               audit: bool = False, idempotency_key: str = "",
               trace_id: str = "", tenant: str = "",
               shape: list | tuple | None = None,
               synthetic: bool = False) -> Job:
        # A draining replica accepts no NEW work (503; the router reads the
        # same flag off /healthz and stops placing here) — already-accepted
        # jobs keep running to completion.
        if self.ctx.is_draining():
            tracing.count("service_jobs_refused")
            raise ServiceBusy(
                f"replica {self.replica_id} is draining; no new admissions")
        path = self._check_root(path)
        # Idempotent re-submission (the router's failover path): the same
        # key returns the already-admitted job — open OR terminal (the
        # spool manifest outlives retire()) — instead of running it twice.
        if idempotency_key:
            prior = self.ctx.idem_job_id(idempotency_key)
            if prior is not None:
                known = self.job(prior)
                if known is not None:
                    tracing.count("service_jobs_deduped")
                    return known
        # The trace context is minted at the entry point unless the
        # submitter carried one across the router hop (X-ICT-Trace); it
        # rides on the job through every layer (admission, dispatch,
        # iteration events) — echoed in the 202 response and header.
        # ``profile`` asks for a torch.profiler capture around this job's
        # dispatch (obs/profiling); the artifact dir lands on the manifest.
        # ``audit`` asks for a shadow-oracle parity replay after it serves
        # (obs/audit; ICT_AUDIT_RATE / --audit_rate samples the rest).
        job = self.ctx.new_job(path, profile=profile, audit=audit,
                               idempotency_key=idempotency_key,
                               trace_id=trace_id, tenant=tenant,
                               synthetic=synthetic)
        dup_id = self.ctx.admit(job, idempotency_key)
        if dup_id is not None:
            # Lost an admission race on the same key: serve the winner.
            known = self.job(dup_id)
            if known is not None:
                tracing.count("service_jobs_deduped")
                return known
            raise ValueError(
                f"idempotency key {idempotency_key!r} maps to a pruned "
                "job manifest; resubmit with a fresh key")
        try:
            self.spool.save(job)
        except Exception:
            # Roll the admission back: a job that was never made durable is
            # also never enqueued, so leaving it indexed would leak one
            # max_open_jobs slot per failed save until restart.
            self.ctx.rollback(job, idempotency_key)
            raise
        tracing.count("service_jobs_submitted")
        if events.active():
            # The replay contract (proving/traces.py): this event must
            # carry everything a re-issue needs — arrival ts (the line's
            # own "ts"), tenant, the idempotency key, the replica's
            # config salt, and the declared shape/bucket hint — at every
            # entry point (POST /jobs directly, via the router, campaign
            # orchestrator submissions all funnel through here).
            shape_hint = ([int(v) for v in shape]
                          if shape is not None and len(shape) == 3 else [])
            events.emit("job_submitted", trace_id=job.trace_id,
                        job_id=job.id, path=path,
                        replica_id=self.replica_id,
                        entry="service", tenant=job.tenant,
                        idem_key=job.idem_key,
                        cache_salt=self.ctx.cache_salt,
                        shape=shape_hint,
                        bucket=(bucket_label(shape_hint)
                                if shape_hint else ""))
        self._load_q.put(job)
        return job

    def job(self, job_id: str) -> Job | None:
        job = self.ctx.lookup(job_id)
        return job if job is not None else self.spool.get(job_id)

    def _check_root(self, path: str) -> str:
        """Validate ``path`` against --root and return its RESOLVED real
        path.  The resolved path is what gets stored and later opened, so
        a symlink retargeted between admission and load (or before a
        restart replay) cannot redirect the read outside the boundary —
        the check and the use see the same target."""
        root = self.serve_cfg.root
        if not root:
            return path
        real = os.path.realpath(path)
        real_root = os.path.realpath(root)
        try:
            # commonpath, not startswith: '--root /' must mean "any
            # absolute path", and '/data' must not admit '/database'.
            inside = os.path.commonpath([real, real_root]) == real_root
        except ValueError:   # e.g. a relative submission path
            inside = False
        if not inside:
            raise ValueError(f"path {path!r} is outside --root {root!r}")
        return real

    def retire(self, job: Job) -> None:
        """Drop a terminal job from the in-memory index — the spool manifest
        is the durable record (job() falls back to it), so a continuous-
        traffic daemon's memory stays bounded by OPEN work, not by every
        job it ever served."""
        self.ctx.retire(job)

    def audit_rate(self) -> float:
        """The effective shadow-audit sampling fraction: an explicit
        --audit_rate wins; < 0 honors ICT_AUDIT_RATE (default 0)."""
        return self.ctx.audit_rate()

    def set_draining(self, flag: bool = True) -> None:
        """Enter (or leave) drain mode: /healthz flips ``draining``, new
        submissions get 503, and parked partial buckets flush immediately
        so accepted work finishes as fast as it can — the fleet router
        reads the flag and stops placing here."""
        self.ctx.set_draining(flag)
        if flag and self.scheduler is not None:
            self.scheduler.flush_all()
        if events.active():
            events.emit("replica_draining" if flag else "replica_undraining",
                        replica_id=self.replica_id)

    def health(self) -> dict:
        """Liveness + the drain signals a load balancer needs: uptime,
        version, and every queue/spool depth (a degraded daemon shows up
        as depths that only grow).  The audit fields let a load balancer
        gate on CORRECTNESS health, not just liveness: a daemon whose
        audit_divergences moves is serving wrong masks."""
        from iterative_cleaner_tpu_torch import __version__
        from iterative_cleaner_tpu_torch.obs import audit as obs_audit

        open_jobs = self.ctx.open_count()
        audit_rep = obs_audit.audit_report()
        return {
            "status": "ok",
            "replica_id": self.replica_id,
            "draining": self.ctx.is_draining(),
            "backend": self.backend_mode,
            "version": __version__,
            "uptime_s": round(time.time() - self.started_s, 3),
            "open_jobs": open_jobs,
            "load_queue_depth": self._load_q.qsize(),
            "dispatch_queue_depth": (self.worker.queue_depth()
                                     if self.worker else 0),
            "bucketed_cubes": (self.scheduler.pending_count()
                               if self.scheduler else 0),
            # Bucket-RESOLVED queue depths (NSUBxNCHANxNBIN -> cubes):
            # the fleet router's affinity-placement signal — aggregate
            # depths cannot tell it which replica is working a shape.
            "bucket_queue_depths": (self.scheduler.pending_by_bucket()
                                    if self.scheduler else {}),
            "bucket_cap": self.bucket_cap,
            "coalesce": (self.scheduler.coalesce if self.scheduler
                         else self.serve_cfg.coalesce),
            # The content-cache identity + size: the fleet router only
            # serves a cached result when every candidate replica
            # advertises the SAME salt (fleet/cache.py; advertised even
            # with the replica-local tier off — the router tier is its
            # own knob), and fleet_top's cache columns read the entry
            # counts next to the hit/miss counters on /metrics.
            "cache_salt": self.ctx.cache_salt,
            "result_cache_entries": len(self.ctx.result_cache),
            "deadline_s": self.serve_cfg.deadline_s,
            "warm_shapes": (self.pool.warm_shapes_now() if self.pool else []),
            "open_sessions": (self.sessions.open_count()
                              if self.sessions else 0),
            "audits_run": audit_rep["audits_run"],
            "audit_divergences": audit_rep["divergences"],
            "last_divergence_ts": audit_rep["last_divergence_ts"],
            "spool": self.spool.root,
        }

    def drain(self, timeout_s: float = 120.0) -> bool:
        """Block until every accepted job is terminal (tests + shutdown
        hooks); True on success, False on timeout."""
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            with self._jobs_lock:
                if all(j.state in TERMINAL for j in self._jobs.values()):
                    return True
            time.sleep(0.02)
        return False

    # --- internals ---

    def _load_loop(self) -> None:
        # Serialized deliberately: with loaders >= 2, the pool's threads
        # race the FIRST lazy import chain here (the batch module pulls in
        # torch and the kernels' wrappers), and CPython's circular-import
        # deadlock avoidance can hand a loser a partially-initialized
        # module — both loader threads then die at startup and every
        # future job wedges in the load queue.  The native runtime's
        # first build and load ride the same lock.  After the winner
        # finishes, the import is a sys.modules hit.
        with _LOADER_IMPORT_LOCK:
            from iterative_cleaner_tpu_torch import native
            from iterative_cleaner_tpu_torch.parallel.batch import (
                _load_and_preprocess,
            )

            native.available()

        while True:
            job = self._load_q.get()
            if job is _STOP:
                return
            try:
                with tracing.phase("service_load"):
                    archive, D, w0 = _load_and_preprocess(job.path)
            except Exception as exc:  # noqa: BLE001 — a poisoned archive
                # fails ALONE, before it can join (and take down) a bucket.
                self.worker._fail(job, f"load failed: {exc}")
                continue
            # Content addressing at ingest (ingest/cas.py): the cube key
            # the worker's result cache checks, and the file digest +
            # salt the fleet router's placement-time cache learns off the
            # terminal manifest.  Hashing is one pass over bytes already
            # resident — noise next to the clean it can save.  The
            # digest is recomputed HERE even when a router already
            # hashed the file at placement time, deliberately: the
            # manifest digest seeds the FLEET-WIDE reuse index, and
            # accepting a submitter-supplied value would let one buggy
            # or hostile client map digest(X) -> result(Y) for every
            # other tenant's byte-identical submission — the replica's
            # own read is the trust boundary (the cost is bounded by
            # the router's ICT_FLEET_CACHE_MAX_BYTES skip).
            from iterative_cleaner_tpu_torch.ingest import cas

            job.cache_salt = self.ctx.cache_salt
            job.file_digest = cas.file_digest(job.path)
            if self.ctx.result_cache.enabled:
                job.content_key = cas.cube_key(D, w0, self.clean_cfg)
            self.scheduler.offer(job, archive, D, w0)

    def _tick_loop(self) -> None:
        interval = min(max(self.serve_cfg.deadline_s / 4, 0.01), 0.25)
        last_gauges = 0.0
        while not self._stop_evt.wait(interval):
            self.scheduler.tick()
            # Keep the memory gauges (/metrics: host RSS, per-device
            # current/peak HBM) no staler than a couple of seconds; the
            # read is a stats-dict fetch, not device work.
            now = time.monotonic()
            if now - last_gauges >= 2.0:
                last_gauges = now
                obs_memory.update_process_gauges()
                # Spool disk headroom rides the same cadence — the fleet
                # alert pack's spool_disk_low rule reads it off the
                # federated scrape.
                obs_memory.update_spool_gauge(self.serve_cfg.spool_dir)
                # The cost ledger's dirty aggregates ride it too — a
                # bounded-staleness persist instead of one atomic write
                # per served job (obs/costs.py; flush never raises).
                self.ctx.cost_ledger.flush()
                # Ingest overlap efficiency as a scrapeable gauge (the
                # trend plane's ingest_overlap fingerprint reads it off
                # the federated exposition; the "last" hint keeps the
                # fleet merge a max, never a sum of fractions).  Only
                # once real pipelined blocks exist — a 0 published
                # before any ingest would read as a regression.
                try:
                    from iterative_cleaner_tpu_torch.ingest import pipeline
                    pstats = pipeline.stats_snapshot()
                    if pstats.get("blocks", 0) > 0:
                        tracing.set_gauge("ingest_last_overlap_efficiency",
                                          pstats["overlap_efficiency"])
                except Exception:
                    pass    # a gauge miss must never wedge the tick loop

    def _on_flush(self, entries) -> None:
        tracing.count("service_buckets_dispatched")
        self.worker.submit(entries)


# --- CLI ---

def build_serve_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ict-serve-torch",
        description="Long-running cleaning daemon on one CUDA card: "
                    "shape-bucketed admission, warm pool, fault-isolated "
                    "job execution")
    p.add_argument("--spool", default="./ict_serve_spool",
                   help="job-manifest directory; a restarted daemon resumes "
                        "the pending jobs found here (default: "
                        "./ict_serve_spool)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8750,
                   help="HTTP port (0 = ephemeral; default 8750)")
    p.add_argument("--replica_id", default="", metavar="ID",
                   help="stable fleet identity, echoed on /healthz and "
                        "every POST /jobs 202 so trace logs attribute jobs "
                        "to replicas (default: mint one per process life)")
    p.add_argument("--bucket_cap", type=int, default=0, metavar="N",
                   help="archives per batched dispatch (0 = the mesh's "
                        "data-parallel extent, 1 on one card; clamped to a "
                        "power of two)")
    p.add_argument("--coalesce", type=int, default=1, metavar="K",
                   help="request-coalescing factor (clamped to a power of "
                        "two): a shape bucket flushes at bucket_cap x K "
                        "cubes, so one batched dispatch amortizes "
                        "over K cubes per data-parallel slice — the "
                        "small-cube campaign throughput knob; raises "
                        "per-device residency by the same factor "
                        "(default 1)")
    p.add_argument("--result_cache", type=int, default=256, metavar="N",
                   help="content-addressed result-cache entries kept "
                        "(0 = off): a resubmitted cube whose bytes + "
                        "config hash to a known key is served from the "
                        "cached mask without touching the device, "
                        "byte-identical by construction; entries persist "
                        "under <spool>/results-cache and are invalidated "
                        "by the code-version/config salt "
                        "(default 256)")
    p.add_argument("--deadline_s", type=float, default=2.0, metavar="S",
                   help="max seconds a partial bucket waits before it is "
                        "dispatched anyway (default 2.0)")
    p.add_argument("--loaders", type=int, default=2,
                   help="archive-decode threads (default 2)")
    p.add_argument("--spool_keep", type=int, default=10000, metavar="N",
                   help="finished-job manifests kept as history; older ones "
                        "are pruned at startup (default 10000)")
    p.add_argument("--max_open_jobs", type=int, default=64, metavar="N",
                   help="admission cap: submissions beyond N open jobs get "
                        "503 (backpressure — every open job can hold one "
                        "decoded cube on host; 0 = unbounded; default 64)")
    p.add_argument("--root", default="", metavar="DIR",
                   help="only accept archive paths under DIR (REQUIRED "
                        "hardening for non-loopback --host: without it any "
                        "reachable client can make the daemon read any file "
                        "and write a _cleaned output next to it)")
    p.add_argument("--alert_iters", type=int, default=2, metavar="N",
                   help="streaming sessions: bounded provisional clean-pass "
                        "iterations per ingested block (default 2; the "
                        "authoritative mask always comes from the canonical "
                        "finalize)")
    p.add_argument("--warm", action="append", default=[],
                   metavar="NSUBxNCHANxNBIN",
                   help="shape class to warm at startup (repeatable): one "
                        "dispatch of zeros per batch size, e.g. --warm "
                        "256x1024x1024")
    p.add_argument("--audit_rate", type=float, default=-1.0, metavar="F",
                   help="shadow-oracle audit sampling fraction in [0, 1]: "
                        "this share of completed jobs is replayed through "
                        "the numpy oracle on a background thread and the "
                        "masks compared bit-for-bit (divergences write "
                        "repro bundles under <spool>/repro and show on "
                        "/healthz).  Default: honor "
                        "ICT_AUDIT_RATE (0 = off); a per-job "
                        '{"audit": true} always audits')
    p.add_argument("--telemetry", default="", metavar="PATH",
                   help="append structured telemetry events (trace spans, "
                        "per-iteration forensics) to PATH as JSON lines "
                        "(ICT_TELEMETRY env equivalent; default off)")
    p.add_argument("--backend", choices=("numpy", "torch"), default="torch")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda; fails when there is no "
                        "CUDA device — pass 'cpu' to run on the CPU)")
    p.add_argument("-c", "--chanthresh", type=float, default=5)
    p.add_argument("-s", "--subintthresh", type=float, default=5)
    p.add_argument("-m", "--max_iter", type=int, default=5)
    p.add_argument("--bad_chan", type=float, default=1)
    p.add_argument("--bad_subint", type=float, default=1)
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("--smoke", action="store_true",
                   help="offline self-check: start the daemon, clean one "
                        "synthetic archive through the HTTP API, verify the "
                        "mask against the numpy oracle, print one JSON line, "
                        "exit")
    return p


def parse_warm_shapes(specs: list[str]) -> tuple:
    shapes = []
    for spec in specs:
        try:
            nsub, nchan, nbin = (int(v) for v in spec.lower().split("x"))
            shapes.append((nsub, nchan, nbin))
        except ValueError:
            raise ValueError(
                f"bad --warm shape {spec!r}; expected NSUBxNCHANxNBIN "
                "like 256x1024x1024") from None
    return tuple(shapes)


def serve_config_from_args(args: argparse.Namespace) -> ServeConfig:
    # Reject ambiguous negatives up front (serve_main turns the ValueError
    # into the one-line error + rc 2 contract): -1 is NOT "unbounded" —
    # it would make the cap check refuse every submission forever.
    if args.max_open_jobs < 0:
        raise ValueError(f"--max_open_jobs must be >= 0 (0 = unbounded), "
                         f"got {args.max_open_jobs}")
    if args.bucket_cap < 0:
        raise ValueError(f"--bucket_cap must be >= 0 (0 = the mesh's dp "
                         f"extent), got {args.bucket_cap}")
    if args.coalesce < 1:
        raise ValueError(f"--coalesce must be >= 1, got {args.coalesce}")
    if args.result_cache < 0:
        raise ValueError(f"--result_cache must be >= 0 (0 = off), "
                         f"got {args.result_cache}")
    if args.alert_iters < 1:
        raise ValueError(f"--alert_iters must be >= 1, got {args.alert_iters}")
    if args.audit_rate > 1:
        raise ValueError(f"--audit_rate must be a fraction in [0, 1] "
                         f"(negative = honor ICT_AUDIT_RATE), got "
                         f"{args.audit_rate}")
    return ServeConfig(
        spool_dir=args.spool,
        host=args.host,
        port=args.port,
        replica_id=args.replica_id,
        bucket_cap=args.bucket_cap,
        coalesce=args.coalesce,
        result_cache=args.result_cache,
        deadline_s=args.deadline_s,
        loaders=args.loaders,
        spool_keep=args.spool_keep,
        max_open_jobs=args.max_open_jobs,
        alert_iters=args.alert_iters,
        root=args.root,
        telemetry=args.telemetry,
        audit_rate=args.audit_rate,
        warm_shapes=parse_warm_shapes(args.warm),
        quiet=args.quiet,
        device=args.device,
        clean=CleanConfig(
            backend=args.backend,
            chanthresh=args.chanthresh,
            subintthresh=args.subintthresh,
            max_iter=args.max_iter,
            bad_chan=args.bad_chan,
            bad_subint=args.bad_subint,
            quiet=args.quiet,
        ),
    )


def run_smoke(serve_cfg: ServeConfig) -> int:
    import json
    import tempfile
    import urllib.request

    import numpy as np

    from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
    from iterative_cleaner_tpu_torch.io.npz import NpzIO
    from iterative_cleaner_tpu_torch.io.synthetic import make_archive
    from iterative_cleaner_tpu_torch.models.surgical import finalize_weights
    from iterative_cleaner_tpu_torch.obs.audit import oracle_config
    from iterative_cleaner_tpu_torch.ops.preprocess import preprocess

    with tempfile.TemporaryDirectory(prefix="ict_serve_smoke_") as tmp:
        path = os.path.join(tmp, "smoke.npz")
        archive = make_archive(nsub=4, nchan=16, nbin=64, seed=99)
        NpzIO().save(archive, path)
        # Hermetic overrides: the smoke archive lives in this tempdir, so
        # an operator --root (or a tiny cap) must not refuse the probe.
        cfg = ServeConfig(**{**serve_cfg.__dict__,
                             "spool_dir": os.path.join(tmp, "spool"),
                             "port": 0, "deadline_s": 0.2,
                             "root": "", "max_open_jobs": 0})
        service = CleaningService(cfg)
        service.start()
        try:
            base = f"http://{cfg.host}:{service.port}"
            # Every smoke run exercises the shadow-oracle audit end-to-end
            # on top of the external mask check below — through the
            # SAMPLING path when it is deterministic (rate exactly 1.0,
            # the CI audit lane: genuinely covers the trigger the plain
            # lane cannot), through the per-job opt-in otherwise (a
            # FRACTIONAL rate would make the audits_run >= 1 requirement
            # a coin flip on a healthy daemon).
            want_flag = service.audit_rate() < 1.0
            req = urllib.request.Request(
                f"{base}/jobs",
                data=json.dumps({"path": path, "audit": want_flag}).encode(),
                headers={"Content-Type": "application/json"})
            job = json.load(urllib.request.urlopen(req, timeout=30))
            deadline = time.time() + 300
            while job["state"] not in TERMINAL and time.time() < deadline:
                time.sleep(0.1)
                job = json.load(urllib.request.urlopen(
                    f"{base}/jobs/{job['id']}", timeout=30))
            # The audit runs on a background thread; /healthz must read
            # its verdict, not its backlog.
            service.auditor.drain(60)
            health = json.load(urllib.request.urlopen(
                f"{base}/healthz", timeout=30))
            ok = job["state"] == "done" and health.get("status") == "ok"
            audits_ok = (health.get("audits_run", 0) >= 1
                         and health.get("audit_divergences", 0) == 0)
            masks_ok = False
            if ok:
                cfg_np = oracle_config(cfg.clean)
                # Same finalization as every served route (shared helper):
                # the oracle comparison includes the bad-parts sweep.
                want, _nbs, _nbc = finalize_weights(
                    clean_cube(*preprocess(archive), cfg_np).weights, cfg_np)
                got = NpzIO().load(job["out_path"])
                masks_ok = bool(np.array_equal(got.weights, want))
            print(json.dumps({
                "smoke": "ok" if ok and masks_ok and audits_ok else "FAIL",
                "job_state": job["state"],
                "served_by": job.get("served_by", ""),
                "mask_identical_to_oracle": masks_ok,
                "audits_run": health.get("audits_run", 0),
                "audit_divergences": health.get("audit_divergences", 0),
                "backend": health.get("backend"),
            }))
            return 0 if ok and masks_ok and audits_ok else 1
        finally:
            service.stop()


def serve_main(argv: list[str] | None = None) -> int:
    args = build_serve_parser().parse_args(argv)
    try:
        serve_cfg = serve_config_from_args(args)
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    if args.smoke:
        return run_smoke(serve_cfg)
    service = CleaningService(serve_cfg)
    try:
        service.start()
    except (RuntimeError, OSError) as exc:
        # e.g. the spool's single-daemon flock, or EADDRINUSE on the bind —
        # the operator contract is a one-line error + rc 1, not a traceback.
        print(f"error: {exc}", file=sys.stderr)
        return 1
    # SIGTERM (the orchestrator's stop signal) and SIGINT (a Ctrl-C'd dev
    # daemon) both dump the flight ring before the graceful shutdown:
    # "what was the daemon doing when it was killed" becomes a file in the
    # spool instead of a guess — dev forensics matter as much as
    # production ones.  Registered only for the real daemon run (not
    # --smoke, not library embedders), and only from the main thread
    # (signal.signal refuses elsewhere).
    import signal

    def _on_stop_signal(signum, frame):
        name = signal.Signals(signum).name
        path = flight.dump(name, service.flight_dir)
        print(f"ict-serve: {name} — shutting down (unfinished jobs stay in "
              f"the spool{'; flight ring at ' + path if path else ''})",
              file=sys.stderr)
        raise SystemExit(0)

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _on_stop_signal)
        except (ValueError, OSError):  # noqa: PERF203 — non-main-thread embed
            pass
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        # Reached only when the SIGINT handler could not be installed (a
        # non-main-thread embed): same graceful stop, same flight dump.
        path = flight.dump("KeyboardInterrupt", service.flight_dir)
        print("ict-serve: shutting down (unfinished jobs stay in the spool"
              f"{'; flight ring at ' + path if path else ''})",
              file=sys.stderr)
    finally:
        service.stop()
    return 0


def console_main() -> int:
    return serve_main(sys.argv[1:])


if __name__ == "__main__":
    raise SystemExit(serve_main())
