"""Signal-driven elastic scaling: replica lifecycle + the control loop.

Port of ``iterative_cleaner_tpu/fleet/autoscale.py``.

The fleet needed autoscaling hooks that use the SLO/straggler signals
to drive replica spawn/drain instead of only placement penalties; the
capacity model (fleet/capacity.py) supplies
the missing demand/backlog half.  Two classes, both owned by the router
and driven from its poll tick:

- :class:`ReplicaSupervisor` owns the lifecycle of *managed* replicas —
  the ones the autoscaler created (statically configured ``--replica``
  URLs are never scaled away).  Spawning goes through a pluggable
  factory: :class:`InProcessReplicaFactory` runs
  ``service.daemon.CleaningService`` replicas inside the router process
  (tests and the ``--smoke`` lane), :class:`SubprocessReplicaFactory`
  execs real ``ict-serve-torch`` daemons (deployments).  A failed spawn is
  retried on the utils/backoff.py full-jitter ladder and every failed
  attempt is surfaced to the router's
  ``fleet_scale_events_total{direction="up",reason="spawn_failed"}``
  counter.  Scale-down is **drain-then-stop**: the replica is put in
  drain mode (the existing ``/drain`` + drain-eviction machinery — the
  router stops placing on it, accepted work finishes), and only once its
  ``/healthz`` reports zero open work is the process stopped and the
  replica removed from the registry — zero jobs are ever lost.

- :class:`Autoscaler` turns capacity + SLO/straggler signals into scale
  decisions: scale **up** when the cost-weighted backlog-drain ETA stays
  above ``scale_up_eta_s`` for ``up_polls`` consecutive polls (reason
  ``backlog``), or when SLO burn moved / a straggler is flagged while
  backlog is nonzero (reasons ``slo_burn`` / ``straggler``); scale
  **down** when the fleet sits idle (zero backlog, utilization under
  ``idle_utilization``, zero demand) for ``down_polls`` consecutive
  polls (reason ``idle``).  Hysteresis is those consecutive-poll
  streaks; ``cooldown_s`` after any decision suppresses flapping.  The
  default mode is **advise** — decisions are emitted (events, counters,
  decision bundles) but not executed; ``--autoscale act`` executes them.

Every signal the loop reads is an exported gauge (the capacity families,
``ict_fleet_slo_burn_total``, ``ict_fleet_stragglers``), so each
decision's inputs are reconstructible from ``GET /fleet/metrics`` alone
(docs/OBSERVABILITY.md "Capacity & autoscaling").
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from dataclasses import dataclass

from iterative_cleaner_tpu_torch.utils import backoff


class SpawnFailed(RuntimeError):
    """Every spawn attempt (initial + the full-jitter retries) failed;
    carries the attempt count for the scale-event record."""

    def __init__(self, message: str, attempts: int) -> None:
        super().__init__(message)
        self.attempts = int(attempts)


@dataclass
class ReplicaHandle:
    """One managed replica the supervisor can stop.  ``stop`` must be
    idempotent and never raise (the drain path may race a crash)."""

    replica_id: str
    base_url: str
    stop: callable


class InProcessReplicaFactory:
    """Spawn ``CleaningService`` replicas inside this process — the
    tests/smoke factory (the ReplicaContext refactor is what makes N
    replicas per process possible).  ``make_serve_cfg(replica_id)``
    returns the ``ServeConfig`` for one new replica (port 0, its own
    spool dir)."""

    def __init__(self, make_serve_cfg) -> None:
        self._make_serve_cfg = make_serve_cfg

    def spawn(self, replica_id: str) -> ReplicaHandle:
        from iterative_cleaner_tpu_torch.obs import events
        from iterative_cleaner_tpu_torch.service.daemon import CleaningService

        cfg = self._make_serve_cfg(replica_id)
        if not cfg.telemetry:
            # The daemon's start() (re)configures the process-global
            # event sink from its own ServeConfig; a replica spawned
            # MID-RUN inside the router's process must inherit the
            # router's sink, not silently reset it.
            sink = events.configured_sink()
            if sink:
                cfg = type(cfg)(**{**cfg.__dict__, "telemetry": sink})
        svc = CleaningService(cfg)
        svc.start()
        return ReplicaHandle(
            replica_id=replica_id,
            base_url=f"http://127.0.0.1:{svc.port}",
            stop=svc.stop)


class SubprocessReplicaFactory:
    """Spawn real ``ict-serve-torch`` daemon processes — the deployment
    factory.  Each replica gets its own spool under ``spool_root`` and
    an OS-assigned free port; the spawn blocks until ``/healthz``
    answers (or ``startup_timeout_s`` expires, which kills the child and
    raises).  ``extra_args`` (e.g. ``--backend numpy``) are appended to
    every spawn — the ``--spawn_arg`` CLI knob."""

    def __init__(self, spool_root: str, host: str = "127.0.0.1",
                 extra_args: tuple = (),
                 startup_timeout_s: float = 60.0) -> None:
        self.spool_root = spool_root
        self.host = host
        self.extra_args = tuple(extra_args)
        self.startup_timeout_s = float(startup_timeout_s)

    @staticmethod
    def _free_port(host: str) -> int:
        import socket

        with socket.socket() as sock:
            sock.bind((host, 0))
            return sock.getsockname()[1]

    def spawn(self, replica_id: str) -> ReplicaHandle:
        import urllib.request

        port = self._free_port(self.host)
        spool = os.path.join(self.spool_root, replica_id)
        os.makedirs(spool, exist_ok=True)
        argv = [sys.executable, "-m", "iterative_cleaner_tpu_torch", "serve",
                "--host", self.host, "--port", str(port),
                "--replica_id", replica_id, "--spool", spool, "-q",
                *self.extra_args]
        proc = subprocess.Popen(argv)

        def stop() -> None:
            try:
                proc.terminate()
                proc.wait(timeout=30)
            except Exception:  # noqa: BLE001 — stop never raises
                try:
                    proc.kill()
                except Exception:  # noqa: BLE001
                    pass

        base_url = f"http://{self.host}:{port}"
        deadline = time.monotonic() + self.startup_timeout_s
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                raise SpawnFailed(
                    f"replica {replica_id} exited rc {proc.returncode} "
                    "before serving /healthz", attempts=1)
            try:
                with urllib.request.urlopen(f"{base_url}/healthz",
                                            timeout=2):
                    return ReplicaHandle(replica_id=replica_id,
                                         base_url=base_url, stop=stop)
            except OSError:
                time.sleep(0.2)
        stop()
        raise SpawnFailed(
            f"replica {replica_id} did not serve /healthz within "
            f"{self.startup_timeout_s:g}s", attempts=1)


class ReplicaSupervisor:
    """Lifecycle owner for autoscaler-managed replicas.  Runs entirely on
    the router's poll thread (spawn, drain checks, reaping) plus handler
    threads reading state — one lock, acquired strictly after the
    router's and NEVER held across an HTTP call or a spawn."""

    #: Managed-replica states: spawned and placeable -> draining (the
    #: scale-down decision) -> stopped (reaped once idle).
    UP, DRAINING, STOPPED = "up", "draining", "stopped"

    def __init__(self, factory, registry, client, *,
                 spawn_retries: int = 3, retry_backoff_s: float = 0.25,
                 note_spawn_failure=None, rng=None,
                 quiet: bool = True) -> None:
        self.factory = factory
        self.registry = registry  # ict: guarded-by(none: bound once here; add/remove go through ReplicaRegistry's own lock)
        self.client = client
        self.spawn_retries = max(int(spawn_retries), 0)
        self.retry_backoff_s = float(retry_backoff_s)
        self._note_spawn_failure = note_spawn_failure or (lambda: None)
        self.quiet = quiet
        self._rng_lock = threading.Lock()
        self._rng = rng or backoff.make_rng()  # ict: guarded-by(self._rng_lock)
        self._lock = threading.Lock()
        self._seq = 0  # ict: guarded-by(self._lock)
        # replica_id -> {"handle": ReplicaHandle, "state": str}
        self._managed: dict[str, dict] = {}  # ict: guarded-by(self._lock)

    def _next_id(self) -> str:
        with self._lock:
            self._seq += 1
            return f"as-{self._seq}"

    # --- scale up ---

    def spawn_replica(self) -> ReplicaHandle:
        """Spawn one managed replica, full-jitter retrying failed
        attempts; registers the new base URL with the registry so the
        next poll picks it up.  Raises :class:`SpawnFailed` (with the
        attempt count) after the ladder is exhausted — every failed
        attempt, terminal or not, has already been surfaced through
        ``note_spawn_failure`` (the
        ``fleet_scale_events_total{direction="up",reason="spawn_failed"}``
        counter)."""
        replica_id = self._next_id()
        last: Exception | None = None
        attempts = 0
        for attempt in range(1 + self.spawn_retries):
            if attempt:
                with self._rng_lock:
                    delay = backoff.full_jitter(self.retry_backoff_s,
                                                attempt - 1, rng=self._rng)
                time.sleep(delay)
            attempts += 1
            try:
                handle = self.factory.spawn(replica_id)
            except Exception as exc:  # noqa: BLE001 — every factory
                # failure mode (bind race, exec error, startup timeout)
                # walks the same retry ladder
                last = exc
                self._note_spawn_failure()
                if not self.quiet:
                    print(f"ict-fleet: replica spawn attempt {attempts} "
                          f"failed ({exc}); retrying", file=sys.stderr)
                continue
            with self._lock:
                self._managed[handle.replica_id] = {
                    "handle": handle, "state": self.UP}
            self.registry.add(handle.base_url)
            return handle
        raise SpawnFailed(
            f"replica spawn failed after {attempts} attempts: {last}",
            attempts=attempts)

    # --- scale down: drain, then stop once idle ---

    def begin_drain(self, replica_id: str) -> bool:
        """Put one managed replica in drain mode (the existing ``/drain``
        machinery: the router stops placing, accepted work finishes).
        Returns False when the replica is not managed/up or the drain
        call failed (the decision then retries on a later tick)."""
        with self._lock:
            rec = self._managed.get(replica_id)
            if rec is None or rec["state"] != self.UP:
                return False
            base_url = rec["handle"].base_url
        try:
            self.client.drain(base_url, True)
        except Exception:  # noqa: BLE001 — unreachable or refused: the
            # replica is not cleanly drainable right now; retry later
            return False
        with self._lock:
            rec = self._managed.get(replica_id)
            if rec is not None and rec["state"] == self.UP:
                rec["state"] = self.DRAINING
        return True

    def reap_drained(self) -> list[dict]:
        """Stop every draining managed replica whose ``/healthz`` reports
        zero open work (jobs, queues, buckets, sessions) — the
        drain-then-stop completion.  Returns one record per replica
        stopped this tick: ``{"managed_id", "replica_id", "base_url"}``
        — ``replica_id`` is the id the replica ADVERTISED (the key the
        router's scrape/straggler caches use; it need not equal the
        supervisor's managed id)."""
        with self._lock:
            draining = [(rid, rec["handle"])
                        for rid, rec in self._managed.items()
                        if rec["state"] == self.DRAINING]
        stopped: list[dict] = []
        for rid, handle in draining:
            try:
                health = self.client.health(handle.base_url)
            except Exception:  # noqa: BLE001 — a draining replica that
                # stopped answering is dead; reap it (its accepted work,
                # if any, re-routes through the normal failover path)
                health = None
            if health is not None and (
                    health.get("open_jobs", 0)
                    or health.get("load_queue_depth", 0)
                    or health.get("dispatch_queue_depth", 0)
                    or health.get("bucketed_cubes", 0)
                    or health.get("open_sessions", 0)):
                continue   # still finishing accepted work
            # Resolve the ADVERTISED id before the registry record goes
            # away: the caller's post-mortem caches are keyed by it.
            rep = self.registry.get(handle.base_url)
            reported = ((rep.replica_id if rep is not None else "")
                        or (health or {}).get("replica_id", "")
                        or handle.base_url)
            handle.stop()
            self.registry.remove(handle.base_url)
            with self._lock:
                rec = self._managed.get(rid)
                if rec is not None:
                    rec["state"] = self.STOPPED
            stopped.append({"managed_id": rid, "replica_id": reported,
                            "base_url": handle.base_url})
        return stopped

    # --- reads / shutdown ---

    def managed(self) -> dict[str, str]:
        """``{managed id -> state}`` for every replica ever spawned."""
        with self._lock:
            return {rid: rec["state"] for rid, rec in self._managed.items()}

    def managed_info(self) -> dict[str, dict]:
        """``{managed id -> {"state", "base_url"}}`` — the base URL is
        the stable join key against the registry (a spawned daemon's
        advertised --replica_id is its own business)."""
        with self._lock:
            return {rid: {"state": rec["state"],
                          "base_url": rec["handle"].base_url}
                    for rid, rec in self._managed.items()}

    def up_ids(self) -> list[str]:
        with self._lock:
            return [rid for rid, rec in self._managed.items()
                    if rec["state"] == self.UP]

    def up_urls(self) -> dict[str, str]:
        """``{base_url -> managed id}`` for drainable replicas.  Victim
        selection matches on the URL, never the replica's self-reported
        id — a spawned daemon may advertise any ``--replica_id`` on its
        /healthz, and the supervisor's identity must not depend on it."""
        with self._lock:
            return {rec["handle"].base_url: rid
                    for rid, rec in self._managed.items()
                    if rec["state"] == self.UP}

    def stop_all(self) -> None:
        """Router shutdown: stop every managed replica (their spools keep
        any accepted-but-unfinished work for a restart)."""
        with self._lock:
            handles = [rec["handle"] for rec in self._managed.values()
                       if rec["state"] != self.STOPPED]
            for rec in self._managed.values():
                rec["state"] = self.STOPPED
        for handle in handles:
            handle.stop()


@dataclass
class AutoscaleConfig:
    mode: str = "advise"            # "advise" (default) | "act"
    min_replicas: int = 1           # alive floor (static + managed)
    max_replicas: int = 4           # alive ceiling
    scale_up_eta_s: float = 10.0    # backlog-drain ETA that means "behind"
    up_polls: int = 3               # hysteresis: consecutive slow polls
    down_polls: int = 6             # hysteresis: consecutive idle polls
    idle_utilization: float = 0.05  # fleet utilization under this = idle
    cooldown_s: float = 30.0        # quiet period after any decision


class Autoscaler:
    """The decision half: pure function of the capacity snapshot + the
    SLO/straggler signals, with streak hysteresis and a cooldown.  The
    router executes the decisions (spawn/drain); this class never
    touches lifecycle, so its verdicts are unit-testable from synthetic
    snapshots alone."""

    def __init__(self, cfg: AutoscaleConfig) -> None:
        if cfg.mode not in ("advise", "act"):
            raise ValueError(f"autoscale mode must be advise|act, "
                             f"got {cfg.mode!r}")
        if cfg.min_replicas < 1:
            raise ValueError(f"min_replicas must be >= 1, "
                             f"got {cfg.min_replicas}")
        if cfg.max_replicas < cfg.min_replicas:
            raise ValueError(f"max_replicas ({cfg.max_replicas}) must be "
                             f">= min_replicas ({cfg.min_replicas})")
        self.cfg = cfg
        self._lock = threading.Lock()
        self._up_streak = 0  # ict: guarded-by(self._lock)
        self._down_streak = 0  # ict: guarded-by(self._lock)
        self._last_decision_mono: float | None = None  # ict: guarded-by(self._lock)
        self._last_decision: dict | None = None  # ict: guarded-by(self._lock)
        self._slo_burn_prev = 0.0  # ict: guarded-by(self._lock)

    def tick(self, snapshot: dict, *, alive: int, managed_up: int,
             slo_burn_total: float, stragglers: int,
             slo_budget_remaining: float | None = None,
             now_mono: float | None = None) -> dict | None:
        """One poll's verdict: None, or a decision dict
        ``{"direction", "reason", "mode", "signals"}``.  ``alive`` is
        live non-draining replicas (the scale bounds); ``managed_up``
        is how many the supervisor could still drain (a fleet of only
        static replicas never scales down).  ``slo_budget_remaining``
        (the minimum error-budget percentage across declared SLO
        objectives, fleet/slo.py) rides the decision's signals so every
        bundle records the budget state it was taken under — the
        router's canary veto is the acting half of that signal."""
        fleet = (snapshot or {}).get("fleet")
        if not fleet:
            return None
        now = time.monotonic() if now_mono is None else now_mono
        with self._lock:
            burn_moved = slo_burn_total > self._slo_burn_prev
            self._slo_burn_prev = slo_burn_total
            backlog = float(fleet.get("backlog", 0.0))
            eta = float(fleet.get("backlog_eta_s", 0.0))
            util = float(fleet.get("utilization", 0.0))
            demand = float(fleet.get("demand_rate", 0.0))
            behind = backlog > 0 and eta > self.cfg.scale_up_eta_s
            pressure = backlog > 0 and (burn_moved or stragglers > 0)
            idle = (backlog <= 0 and demand <= 0
                    and util < self.cfg.idle_utilization)
            self._up_streak = self._up_streak + 1 \
                if (behind or pressure) else 0
            self._down_streak = self._down_streak + 1 if idle else 0
            in_cooldown = (
                self._last_decision_mono is not None
                and now - self._last_decision_mono < self.cfg.cooldown_s)
            decision: dict | None = None
            if (self._up_streak >= self.cfg.up_polls and not in_cooldown
                    and alive < self.cfg.max_replicas):
                reason = ("backlog" if behind
                          else "slo_burn" if burn_moved else "straggler")
                decision = {"direction": "up", "reason": reason}
            elif (self._down_streak >= self.cfg.down_polls
                    and not in_cooldown
                    and alive > self.cfg.min_replicas and managed_up > 0):
                decision = {"direction": "down", "reason": "idle"}
            if decision is not None:
                decision["mode"] = self.cfg.mode
                decision["signals"] = {
                    "backlog": backlog, "backlog_eta_s": eta,
                    "utilization": util, "demand_rate": demand,
                    "slo_burn_total": slo_burn_total,
                    "stragglers": stragglers, "alive": alive,
                    "up_streak": self._up_streak,
                    "down_streak": self._down_streak,
                }
                if slo_budget_remaining is not None:
                    decision["signals"]["slo_budget_remaining_pct"] = (
                        slo_budget_remaining)
                self._last_decision_mono = now
                self._last_decision = dict(decision)
                self._up_streak = 0
                self._down_streak = 0
            return decision

    def state(self, now_mono: float | None = None) -> dict:
        """The /healthz + /fleet/capacity view of the loop."""
        now = time.monotonic() if now_mono is None else now_mono
        with self._lock:
            cooldown_left = 0.0
            if self._last_decision_mono is not None:
                cooldown_left = max(
                    0.0, self.cfg.cooldown_s
                    - (now - self._last_decision_mono))
            return {
                "mode": self.cfg.mode,
                "min_replicas": self.cfg.min_replicas,
                "max_replicas": self.cfg.max_replicas,
                "scale_up_eta_s": self.cfg.scale_up_eta_s,
                "up_polls": self.cfg.up_polls,
                "down_polls": self.cfg.down_polls,
                "cooldown_s": self.cfg.cooldown_s,
                "up_streak": self._up_streak,
                "down_streak": self._down_streak,
                "cooldown_remaining_s": round(cooldown_left, 3),
                "last_decision": (dict(self._last_decision)
                                  if self._last_decision else None),
            }
