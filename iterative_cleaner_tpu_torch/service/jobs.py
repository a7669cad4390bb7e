"""Job records + the on-disk spool that makes the daemon restart-safe.

A copy of ``iterative_cleaner_tpu/service/jobs.py``: the same ``Job`` fields
and the same JSON manifests, so a spool written by either package's daemon
replays in the other's.

One JSON manifest per job under the spool directory, written atomically
(write-then-rename, the driver.atomic_save idiom) so a daemon killed
mid-update never leaves a truncated manifest.  A restarted daemon replays
the spool: ``pending`` jobs resume as-is, and ``running`` jobs — whose
dispatch died with the process — are demoted back to ``pending`` and
re-dispatched (masks are deterministic, so a re-run is idempotent up to
overwriting its own output).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
import uuid
from dataclasses import dataclass, field

#: Job lifecycle: pending -> running -> done | error.
STATES = ("pending", "running", "done", "error")
TERMINAL = ("done", "error")


def new_job_id() -> str:
    """Time-sortable unique id: submission order survives a spool replay
    (lexicographic sort of ids == arrival order) without a separate
    sequence file to keep crash-consistent."""
    return f"{int(time.time() * 1000):013d}-{uuid.uuid4().hex[:8]}"


@dataclass
class Job:
    id: str
    path: str                       # archive to clean
    state: str = "pending"
    submitted_s: float = 0.0        # unix time
    finished_s: float = 0.0
    out_path: str | None = None
    loops: int = 0
    rfi_frac: float = 0.0
    converged: bool = False
    error: str | None = None
    attempts: int = 0               # dispatch attempts (retry accounting)
    served_by: str = ""             # "sharded" | "oracle-fallback"
    shape: list[int] = field(default_factory=list)  # cube shape once decoded
    trace_id: str = ""              # telemetry trace context (obs/events.py):
                                    # minted at admission, echoed in every
                                    # HTTP response and event-log line
    termination: str = ""           # forensics: fixed_point | cycle | max_iter
    profile: bool = False           # submitter asked for a torch.profiler
                                    # capture around this job's dispatch
                                    # (obs/profiling.py)
    profile_dir: str = ""           # capture artifact directory, once taken
    audit: bool = False             # submitter asked for a shadow-oracle
                                    # parity audit of this job (obs/audit.py;
                                    # ICT_AUDIT_RATE samples the rest)
    content_key: str = ""           # content address of the cleaning
                                    # problem (ingest/cas.cube_key:
                                    # preprocessed cube bytes + config/
                                    # version salt), stamped at ingest —
                                    # the replica-side result cache's key
    file_digest: str = ""           # plain SHA-256 of the archive file's
                                    # raw bytes (ingest/cas.file_digest) —
                                    # the fleet router's placement-time
                                    # cache key, paired with cache_salt
    cache_salt: str = ""            # the serving replica's config/version
                                    # salt (ingest/cas.cache_salt): a
                                    # cached result only answers
                                    # submissions under the same salt
    idem_key: str = ""              # submitter-supplied idempotency key
                                    # (the fleet router's failover path):
                                    # a re-submission carrying the same key
                                    # dedupes against this job instead of
                                    # running it twice (service/context.py)
    tenant: str = ""                # showback identity (X-ICT-Tenant /
                                    # the router's forwarded "tenant"
                                    # field; "" reads as "default") — the
                                    # cost ledger's aggregation key
                                    # (obs/costs.py)
    synthetic: bool = False         # router-injected canary probe
                                    # (fleet/canary.py): stamped end-to-
                                    # end so every observer can exclude
                                    # it from demand/quota/cost planes
    # Cost accounting (obs/costs.py): device-seconds split by phase,
    # compile seconds, apportioned static bytes/FLOPs, coalesced batch
    # size, cache-hit avoided cost, attainment — stamped by the dispatch
    # worker, persisted on the manifest (the showback record).
    cost: dict = field(default_factory=dict)
    # Shadow-audit outcome, re-persisted once the background replay
    # finishes: mask_identical, n_mask_diffs, score drift vs the
    # documented bound, and the repro-bundle path on a divergence.
    audit_result: dict = field(default_factory=dict)
    # RFI data-quality summary of the served mask (obs/quality.py): zap
    # fraction, occupancy histograms, fully-zapped channel/subint counts.
    quality: dict = field(default_factory=dict)
    # The cost model of the dispatch that served this job's shape bucket
    # (obs/memory.analyze_batch_route: bytes accessed, FLOPs, peak bytes) —
    # attached when exec analysis is enabled, persisted on the manifest.
    exec_analysis: dict = field(default_factory=dict)
    # Per-iteration forensics records (obs.forensics.iteration_record dicts)
    # — served by GET /jobs/<id>/trace, EXCLUDED from to_dict so the job
    # manifest responses stay lean.
    timeline: list = field(default_factory=list)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("timeline", None)
        return d

    def trace_dict(self) -> dict:
        """The GET /jobs/<id>/trace payload: identity + convergence
        forensics (per-iteration timeline, termination reason)."""
        return {
            "id": self.id,
            "trace_id": self.trace_id,
            "state": self.state,
            "served_by": self.served_by,
            "loops": self.loops,
            "converged": self.converged,
            "termination": self.termination,
            "timeline": self.timeline,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Job":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class JobSpool:
    """Directory of per-job JSON manifests; the daemon's durable state.

    All mutation goes through :meth:`save` under one lock — manifests are
    tiny, and serialized writes keep the rename-atomic invariant simple
    across the loader/worker/HTTP threads.
    """

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()
        # Written only by start()/stop() on the daemon's lifecycle thread;
        # worker/HTTP threads never touch the flock fd.
        self._flock_fd: int | None = None  # ict: guarded-by(none: lifecycle-thread only)

    def acquire_exclusive(self) -> None:
        """Take the spool's single-daemon flock.  Two daemons on one spool
        would sweep each other's atomic-write temps and re-dispatch each
        other's running jobs, so the daemon takes this before touching any
        manifest.  flock, not a pid file: the kernel releases it when the
        process dies, so there is no stale-lock handling."""
        import fcntl

        fd = os.open(os.path.join(self.root, ".lock"),
                     os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError as exc:
            os.close(fd)
            raise RuntimeError(
                f"spool {self.root!r} is already served by another daemon "
                "(its .lock is held); use a separate --spool per daemon"
            ) from exc
        self._flock_fd = fd

    def release_exclusive(self) -> None:
        if self._flock_fd is not None:
            os.close(self._flock_fd)   # closing drops the flock
            self._flock_fd = None

    def _manifest(self, job_id: str) -> str | None:
        """Manifest path for an id, or None for anything that is not a
        plain filename — ids come straight off the HTTP path
        (GET /jobs/<id>), so '../'-shaped ids must never resolve outside
        the spool directory."""
        name = f"{job_id}.json"
        if os.path.basename(name) != name or job_id.startswith("."):
            return None
        return os.path.join(self.root, name)

    def create(self, path: str) -> Job:
        job = Job(id=new_job_id(), path=path, submitted_s=time.time())
        self.save(job)
        return job

    def save(self, job: Job) -> None:
        p = self._manifest(job.id)
        if p is None:
            raise ValueError(f"unsaveable job id {job.id!r}")
        tmp = f"{p}.part"
        with self._lock:
            with open(tmp, "w") as fh:
                # The FULL record, timeline included (to_dict trims it for
                # HTTP responses only): the spool is the durable store the
                # trace endpoint reads back after a restart.
                json.dump(dataclasses.asdict(job), fh, indent=1)
                fh.write("\n")
            os.replace(tmp, p)

    def get(self, job_id: str) -> Job | None:
        p = self._manifest(job_id)
        if p is None:
            return None
        try:
            with open(p) as fh:
                d = json.load(fh)
            if not isinstance(d, dict):
                return None
            job = Job.from_dict(d)
            if job.id != job_id:
                # The content id must round-trip to the filename: a foreign
                # manifest with a traversal-shaped or mismatched inner id
                # would otherwise crash recover()'s re-persist (save
                # rejects it) or duplicate the job under a second name.
                return None
            return job
        # TypeError covers foreign/schema-drifted JSON (an operator note
        # dropped into the spool, a manifest missing required fields): one
        # unreadable file must degrade to "not a job", never crash-loop
        # the startup replay that reads every manifest.
        except (OSError, ValueError, TypeError):
            return None

    def all_jobs(self) -> list[Job]:
        jobs = []
        for name in sorted(os.listdir(self.root)):
            if not name.endswith(".json"):
                continue
            job = self.get(name[: -len(".json")])
            if job is not None:
                jobs.append(job)
        return jobs

    def recover(self, jobs: list[Job] | None = None) -> list[Job]:
        """Jobs a previous daemon left unfinished, in submission order.
        ``running`` manifests are demoted to ``pending`` (their dispatch
        died with the process) and re-persisted before being handed back,
        so a crash during the replay itself loses nothing.  ``jobs`` lets
        the startup path share one all_jobs() directory scan with trim()."""
        pending = []
        for job in (self.all_jobs() if jobs is None else jobs):
            if job.state == "running":
                job.state = "pending"
                job.attempts = 0
                self.save(job)
            if job.state == "pending":
                pending.append(job)
        return pending

    def trim(self, keep_terminal: int, jobs: list[Job] | None = None) -> int:
        """Delete the oldest TERMINAL manifests beyond ``keep_terminal``
        (daemon startup, the compile-cache-trim rationale: a long-lived
        daemon is exactly the unbounded-growth workload).  Pending/running
        manifests — accepted, unserved work — are never touched.  Returns
        how many were removed.  ``jobs`` shares the startup directory scan
        with recover()."""
        if keep_terminal < 0:
            return 0
        # Sweep orphaned atomic-write temps first: a daemon killed between
        # the .part write and the rename leaves one behind, and nothing
        # else ever looks at them.  trim() runs under the startup flock,
        # before any writer thread exists, so no live .part can be swept.
        for name in os.listdir(self.root):
            if name.endswith(".json.part"):
                try:
                    os.remove(os.path.join(self.root, name))
                except OSError:
                    pass
        if jobs is None:
            jobs = self.all_jobs()
        terminal = [j for j in jobs if j.state in TERMINAL]
        removed = 0
        for job in terminal[: max(len(terminal) - keep_terminal, 0)]:
            p = self._manifest(job.id)
            try:
                os.remove(p)
                removed += 1
            except OSError:
                continue
        return removed
