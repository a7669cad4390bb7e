"""Replica registry: the router's live model of the fleet.

Port of ``iterative_cleaner_tpu/fleet/registry.py``.

One record per configured replica base URL.  The router's poll loop calls
:meth:`ReplicaRegistry.poll_once` every ``poll_interval_s``; each poll
refreshes the replica's ``/healthz`` snapshot (identity, drain flag,
aggregate and per-shape-bucket queue depths, warm shapes) or — on a
transport failure — advances its death countdown: ``dead_after``
consecutive unreachable polls flip the replica to **dead**, and
``poll_once`` returns the newly-dead records so the router can re-route
their open placements (fleet/router.py failover).  Submission-path
transport failures feed the same countdown through
:meth:`note_unreachable` — a replica that eats placements is as dead as
one that misses polls.

A dead replica keeps being polled: one healthy ``/healthz`` revives it
(a restarted replica rejoins the fleet automatically).  NOTE the restart
caveat in docs/SERVING.md "Fleet": a revived replica replays its spooled
pending jobs, including any the router already failed over — masks are
deterministic so the duplicate run is byte-identical and harmless, but
operators restarting a failed-over replica should clear its spool first
if they care about the wasted work.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

from iterative_cleaner_tpu_torch.service.scheduler import bucket_label


@dataclass
class Replica:
    """One replica's last-known state.  Mutated only by ReplicaRegistry
    methods under the registry lock (the dataclass itself owns no lock —
    the registry is the single synchronization domain)."""

    base_url: str
    replica_id: str = ""            # learned from the first /healthz
    health: dict = field(default_factory=dict)   # last good snapshot
    alive: bool = False             # False until the first good poll
    draining: bool = False
    consecutive_failures: int = 0
    last_ok_s: float = 0.0          # time.monotonic() of the last good poll
    # Placements routed here since the last good poll: the health
    # snapshot lags the router's own admissions, so load scoring adds
    # this delta (reset on every refresh) to avoid dogpiling the replica
    # that just looked least loaded.
    placed_since_poll: int = 0

    def load(self) -> float:
        """Scalar load for placement scoring: everything queued anywhere
        in the replica (admitted, decoding, bucketed, flushed) plus the
        placements the snapshot hasn't seen yet."""
        h = self.health
        return (float(h.get("open_jobs", 0))
                + float(h.get("load_queue_depth", 0))
                + float(h.get("dispatch_queue_depth", 0))
                + float(h.get("bucketed_cubes", 0))
                + float(self.placed_since_poll))

    def warm_buckets(self) -> set[str]:
        """Shape-bucket labels this replica has warm executables for, in
        the one shared NSUBxNCHANxNBIN grammar (scheduler.bucket_label —
        the same helper the router's placement keys use, so the two can
        never drift apart)."""
        return {bucket_label(shape)
                for shape in self.health.get("warm_shapes", [])}

    def queued_buckets(self) -> dict[str, float]:
        """Per-shape-bucket queued-cube depths from the last snapshot —
        a replica already working a bucket has paid its compiles."""
        return {str(k): float(v) for k, v in
                self.health.get("bucket_queue_depths", {}).items()}


class ReplicaRegistry:
    """Thread-safe fleet model shared by the router's HTTP handler
    threads (placement reads, submission-failure notes) and its poll
    loop (health refresh, death/revival transitions)."""

    def __init__(self, base_urls: list[str], dead_after: int = 3) -> None:
        if dead_after < 1:
            raise ValueError(f"dead_after must be >= 1, got {dead_after}")
        self.dead_after = int(dead_after)
        self._lock = threading.Lock()
        self._replicas: dict[str, Replica] = {  # ict: guarded-by(self._lock)
            url: Replica(base_url=url)
            for url in dict.fromkeys(base_urls)}   # dedupe, keep order

    # --- polling ---

    def poll_once(self, client) -> list[Replica]:
        """Refresh every replica's health snapshot; returns replicas that
        flipped alive -> dead on THIS poll (the router re-routes their
        open placements exactly once per death).  The HTTP calls run
        outside the lock — a slow replica must not block placement reads
        — and CONCURRENTLY, so one wedged replica costs the poll one
        timeout, not one timeout per healthy replica behind it."""
        with self._lock:
            urls = list(self._replicas)

        def probe(url: str) -> dict | None:
            try:
                return client.health(url)
            except Exception:  # noqa: BLE001 — unreachable OR refused: a
                # replica whose /healthz errors is not placeable either way
                return None

        with ThreadPoolExecutor(
                max_workers=min(8, max(len(urls), 1)),
                thread_name_prefix="ict-fleet-health") as pool:
            results = dict(zip(urls, pool.map(probe, urls)))
        newly_dead: list[Replica] = []
        with self._lock:
            for url, health in results.items():
                rep = self._replicas.get(url)
                if rep is None:
                    continue
                if health is None:
                    rep.consecutive_failures += 1
                    if (rep.alive
                            and rep.consecutive_failures >= self.dead_after):
                        rep.alive = False
                        newly_dead.append(rep)
                    continue
                rep.alive = True
                rep.consecutive_failures = 0
                rep.replica_id = str(health.get("replica_id", "")
                                     or rep.replica_id or url)
                rep.draining = bool(health.get("draining", False))
                rep.health = health
                rep.placed_since_poll = 0
                rep.last_ok_s = time.monotonic()
        return newly_dead

    def note_unreachable(self, base_url: str) -> Replica | None:
        """A submission-path transport failure: advances the same death
        countdown polling uses; returns the replica if THIS note killed
        it (the caller then triggers the re-route)."""
        with self._lock:
            rep = self._replicas.get(base_url)
            if rep is None:
                return None
            rep.consecutive_failures += 1
            if rep.alive and rep.consecutive_failures >= self.dead_after:
                rep.alive = False
                return rep
        return None

    # --- elastic membership (fleet/autoscale.py) ---

    def add(self, base_url: str) -> Replica:
        """Join one replica to the fleet at runtime — the autoscaler's
        scale-up path.  Idempotent: re-adding a known URL returns the
        existing record (its health history intact).  The new record is
        not alive until its first good poll, exactly like a configured
        replica at startup."""
        url = base_url.rstrip("/")
        with self._lock:
            rep = self._replicas.get(url)
            if rep is None:
                rep = self._replicas[url] = Replica(base_url=url)
            return rep

    def remove(self, base_url: str) -> None:
        """Leave the fleet — the autoscaler's post-drain scale-down path
        (a removed replica is no longer polled, scored, or scraped)."""
        with self._lock:
            self._replicas.pop(base_url.rstrip("/"), None)

    def note_placed(self, base_url: str) -> None:
        with self._lock:
            rep = self._replicas.get(base_url)
            if rep is not None:
                rep.placed_since_poll += 1

    # --- placement reads ---

    def candidates(self) -> list[Replica]:
        """Replicas eligible for NEW placements: alive and not draining.
        Returns copies of nothing — the Replica objects themselves — so
        callers must treat them as read-only snapshots."""
        with self._lock:
            return [r for r in self._replicas.values()
                    if r.alive and not r.draining]

    def get(self, base_url: str) -> Replica | None:
        with self._lock:
            return self._replicas.get(base_url)

    def by_id(self, replica_id: str) -> Replica | None:
        with self._lock:
            for rep in self._replicas.values():
                if rep.replica_id == replica_id:
                    return rep
        return None

    def snapshot(self) -> list[dict]:
        """The /healthz + /metrics view: one row per replica."""
        with self._lock:
            return [{
                "base_url": r.base_url,
                "replica_id": r.replica_id,
                "alive": r.alive,
                "draining": r.draining,
                "consecutive_failures": r.consecutive_failures,
                "open_jobs": r.health.get("open_jobs", 0),
                "load_queue_depth": r.health.get("load_queue_depth", 0),
                "dispatch_queue_depth": r.health.get(
                    "dispatch_queue_depth", 0),
                "bucketed_cubes": r.health.get("bucketed_cubes", 0),
                "bucket_queue_depths": dict(
                    r.health.get("bucket_queue_depths", {})),
                "warm_shapes": list(r.health.get("warm_shapes", [])),
                "backend": r.health.get("backend", ""),
                "version": r.health.get("version", ""),
                # The content-cache salt (ingest/cas.py) this replica
                # advertises: the router's fleet-wide result index only
                # answers when every candidate agrees on it
                # (fleet/cache.unanimous_salt).
                "cache_salt": r.health.get("cache_salt", ""),
                # Correctness-health passthrough: the router's incident
                # watch keys audit-divergence/demotion bundles off these
                # (fleet/obs.py), and /healthz readers gate on them the
                # same way they gate on a single replica's.
                "audits_run": r.health.get("audits_run", 0),
                "audit_divergences": r.health.get("audit_divergences", 0),
            } for r in self._replicas.values()]
