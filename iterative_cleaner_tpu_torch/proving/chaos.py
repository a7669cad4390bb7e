"""Scheduled fault injection with explicit heal assertions.

Port of ``iterative_cleaner_tpu/proving/chaos.py``.

Every drill follows the same closed-loop contract the fleet claims for
itself (docs/PROVING.md carries the fault → alert → heal → ledger table):

1. **inject** a fault into a live in-process fleet;
2. the fault must surface as a FIRING alert on the router's alert plane;
3. the fleet must heal autonomously (failover re-route, traffic flowing
   around the wedge, restart-recover, sink restore) and the alert must
   RESOLVE;
4. the books must balance afterwards: every submitted job terminal
   exactly once with oracle-identical masks, and the cost ledger still
   conserving against the dispatch clock.

Drills are functions over the duck-typed fleet handle built in
:mod:`.soak` (``ProvingFleet``): a router with a dormant poll loop the
drill drives by hand (``fleet.tick()``), 2+ in-process replicas, and
helpers for submission / terminal-wait / oracle audit / ledger reads.
Each returns a :class:`DrillReport`; ``report.ok`` is the whole contract.
"""

from __future__ import annotations

import glob
import os
import socket
import threading
import time
from dataclasses import dataclass

import numpy as np

from iterative_cleaner_tpu_torch.obs import events
from iterative_cleaner_tpu_torch.proving import scenarios

#: Alert rule names the drills assert against — injected into the
#: router's rule set by soak.PROVE_RULES (names must match there).
RULE_REPLICA_DEAD = "prove_replica_dead"
RULE_SINK_DEGRADED = "prove_event_sink_degraded"


@dataclass
class DrillReport:
    """One drill's closed-loop scorecard."""

    fault: str
    injected: bool = False        # the fault observably took hold
    alert_fired: bool = False     # surfaced on the router's alert plane
    healed: bool = False          # service restored (jobs flow/complete)
    alert_resolved: bool = False  # the alert plane saw the heal too
    masks_ok: bool = False        # mid-drill jobs match the numpy oracle
    ledger_ok: bool = False       # exactly-once completion count held
    cost_ok: bool = False         # cost ledger still conserves post-drill
    detail: str = ""

    @property
    def ok(self) -> bool:
        return (self.injected and self.alert_fired and self.healed
                and self.alert_resolved and self.masks_ok
                and self.ledger_ok and self.cost_ok)

    def to_json(self) -> dict:
        return {"fault": self.fault, "ok": self.ok,
                "injected": self.injected, "alert_fired": self.alert_fired,
                "healed": self.healed,
                "alert_resolved": self.alert_resolved,
                "masks_ok": self.masks_ok, "ledger_ok": self.ledger_ok,
                "cost_ok": self.cost_ok, "detail": self.detail}


def _drill_subs(fleet, tag: str, count: int,
                offset: int) -> list[scenarios.Submission]:
    """Drill-private submissions: cube seeds live in a 900k+ band so no
    drill cube is ever byte-identical to a scenario cube (byte identity
    would let the fleet CAS serve it born-terminal and the drill's job
    would never reach a replica)."""
    out = []
    for i in range(count):
        seed = 900_000 + offset * 1_000 + fleet.seed * 13 + i
        path = scenarios._cube(
            fleet.workdir, f"drill_{tag}_{fleet.seed}_{i}.npz",
            scenarios.SMALL_SHAPE, seed)
        out.append(scenarios.Submission(
            path=path, tenant="chaos",
            idem_key=f"drill:{tag}:{fleet.seed}:{i}",
            shape=scenarios.SMALL_SHAPE, scenario=f"drill_{tag}"))
    return out


def _await_alert(fleet, rule: str, state: str, baseline: int,
                 max_ticks: int = 12, sleep_s: float = 0.05) -> bool:
    """Drive poll ticks until the alert plane records a ``rule`` → state
    transition NEWER than ``baseline`` (a recent()-length snapshot taken
    before injection, so stale transitions from earlier drills never
    satisfy a later one)."""
    for _ in range(max_ticks):
        fleet.tick()
        for rec in fleet.router.alerts.recent()[baseline:]:
            if rec.get("rule") == rule and rec.get("state") == state:
                return True
        time.sleep(sleep_s)
    return False


def _park_on(fleet, victim, victim_tag: str, subs) -> tuple[list, list]:
    """Submit until least-loaded placement has used the victim, then wait
    for the victim to decode and PARK its share (accepted, undispatched —
    the mid-queue death window)."""
    replies = [fleet.submit(s) for s in subs]
    on_victim = [r for r in replies if r.get("replica_id") == victim_tag]
    deadline = time.time() + 60
    while (victim.scheduler.pending_count() < len(on_victim)
           and time.time() < deadline):
        time.sleep(0.02)
    return replies, on_victim


def _settle(fleet, subs, replies, done_before: int) -> tuple[bool, bool]:
    """The post-heal bookkeeping every drill ends with: all jobs terminal
    ``done`` with oracle-identical masks, and the fleet-wide completion
    counter moved by exactly len(subs)."""
    states = fleet.await_terminal([r["id"] for r in replies])
    masks_ok = all(s.get("state") == "done" for s in states.values())
    if masks_ok:
        for sub, r in zip(subs, replies):
            got = states[r["id"]]
            masks_ok = masks_ok and np.array_equal(
                fleet.load_weights(got["out_path"]),
                fleet.oracle_weights(sub.path))
    ledger_ok = (fleet.jobs_done() - done_before == len(subs)
                 and all(s.get("state") == "done"
                         for s in states.values()))
    return masks_ok, ledger_ok


def drill_replica_kill(fleet) -> DrillReport:
    """Kill a replica with jobs parked mid-queue; assert the dead-replica
    alert fires, failover re-routes the parked placements under their
    original idempotency keys, a replacement replica joins, the alert
    resolves, and every job completes exactly once, oracle-identical."""
    rep = DrillReport(fault="replica_kill")
    baseline = len(fleet.router.alerts.recent())
    done0 = fleet.jobs_done()
    tag = fleet.next_tag("victim")
    victim = fleet.new_replica(tag, deadline_s=3600.0, bucket_cap=8)
    fleet.tick()   # first good poll marks the victim alive
    subs = _drill_subs(fleet, "kill", 4, offset=1)
    replies, on_victim = _park_on(fleet, victim, tag, subs)
    victim_url = f"http://127.0.0.1:{victim.port}"
    fleet.tick()   # pre-death scrape: router sees the parked placements
    fleet.kill(victim)
    rep.injected = bool(on_victim)
    rep.alert_fired = _await_alert(
        fleet, RULE_REPLICA_DEAD, "firing", baseline)
    # Heal: a replacement joins on a fresh spool; the dead row leaves the
    # registry (the autoscaler's scale-down path), so the dead gauge
    # returns to 0 and the alert resolves.  NOT the old spool: its parked
    # jobs were already re-routed, and replaying them would double-run.
    fleet.new_replica(fleet.next_tag("heal"))
    fleet.router.registry.remove(victim_url)
    rep.alert_resolved = _await_alert(
        fleet, RULE_REPLICA_DEAD, "resolved", baseline)
    rep.masks_ok, rep.ledger_ok = _settle(fleet, subs, replies, done0)
    rep.healed = rep.ledger_ok and rep.alert_resolved
    rep.cost_ok = fleet.cost_conservation_ok()
    rep.detail = (f"{len(on_victim)}/{len(subs)} jobs parked on the "
                  f"victim at kill time; failovers="
                  f"{fleet.router.metrics.counter_total('fleet_failovers_total')}")
    return rep


class _WedgedBackend:
    """A replica-shaped black hole: the socket ACCEPTS (so the failure
    mode is 'process up, HTTP dead' — a wedged backend, not a down host)
    but every connection is closed before a byte of response, so the
    router's health poll fails instantly instead of burning its
    per-call timeout on every tick."""

    def __init__(self) -> None:
        self._sock = socket.socket()  # ict: guarded-by(none: bound once here; accept loop is the only user after start)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(16)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()  # ict: guarded-by(none: threading.Event is internally locked)
        self._thread = threading.Thread(  # ict: guarded-by(none: set once during construction)
            target=self._run, name="ict-prove-wedge", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
                conn.close()
            except OSError:
                return

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass


def drill_wedged_backend(fleet) -> DrillReport:
    """Join a wedged backend (TCP up, HTTP never answers) to the fleet;
    assert the dead-replica alert fires, traffic keeps flowing around it
    (a never-alive row is never a placement candidate), and scaling the
    wedge out resolves the alert."""
    rep = DrillReport(fault="wedged_backend")
    baseline = len(fleet.router.alerts.recent())
    done0 = fleet.jobs_done()
    wedge = _WedgedBackend()
    url = f"http://127.0.0.1:{wedge.port}"
    try:
        fleet.router.registry.add(url)
        rep.injected = True
        # registry.add = not alive until a good poll it will never give,
        # so the dead gauge goes positive on the next tick.
        rep.alert_fired = _await_alert(
            fleet, RULE_REPLICA_DEAD, "firing", baseline)
        # Service continues mid-fault: one job end to end.
        subs = _drill_subs(fleet, "wedge", 1, offset=2)
        replies = [fleet.submit(s) for s in subs]
        rep.masks_ok, rep.ledger_ok = _settle(fleet, subs, replies, done0)
        # Heal = scale the wedge out (the operator/autoscaler move for a
        # backend that accepts but never serves).
        fleet.router.registry.remove(url)
        rep.alert_resolved = _await_alert(
            fleet, RULE_REPLICA_DEAD, "resolved", baseline)
        rep.healed = rep.ledger_ok and rep.alert_resolved
        rep.cost_ok = fleet.cost_conservation_ok()
        rep.detail = f"wedge at {url} joined, alerted, drained out"
    finally:
        wedge.close()
    return rep


def drill_corrupt_spool(fleet) -> DrillReport:
    """Crash a replica with parked jobs, corrupt EVERY manifest in its
    spool, and restart on the same spool+port; assert the dead window
    fired the alert and re-routed the parked placements, the revived
    replica's recover() skips the corrupt manifests instead of replaying
    them (no double-completion), and the alert resolves on revival."""
    rep = DrillReport(fault="corrupt_spool")
    baseline = len(fleet.router.alerts.recent())
    done0 = fleet.jobs_done()
    tag = fleet.next_tag("spool")
    victim = fleet.new_replica(tag, deadline_s=3600.0, bucket_cap=8)
    fleet.tick()
    subs = _drill_subs(fleet, "spool", 4, offset=3)
    replies, on_victim = _park_on(fleet, victim, tag, subs)
    victim_port = victim.port
    spool_dir = victim.serve_cfg.spool_dir
    fleet.tick()   # pre-death scrape
    fleet.kill(victim)
    manifests = glob.glob(os.path.join(spool_dir, "*.json"))
    for path in manifests:
        with open(path, "w") as fh:
            fh.write("{torn mid-write: not json")
    rep.injected = bool(on_victim) and bool(manifests)
    # >= dead_after ticks while down: the alert fires and the failover
    # sweep re-routes the parked placements under their pinned idem keys.
    rep.alert_fired = _await_alert(
        fleet, RULE_REPLICA_DEAD, "firing", baseline)
    # Heal: revive on the SAME spool and port.  JobSpool.get() treats a
    # garbage manifest as "not a job" (returns None), so recover() skips
    # every corrupted entry — the re-routed copies are the only live ones.
    fleet.new_replica(fleet.next_tag("revived"), port=victim_port,
                      spool_dir=spool_dir)
    rep.alert_resolved = _await_alert(
        fleet, RULE_REPLICA_DEAD, "resolved", baseline)
    rep.masks_ok, rep.ledger_ok = _settle(fleet, subs, replies, done0)
    rep.healed = rep.ledger_ok and rep.alert_resolved
    rep.cost_ok = fleet.cost_conservation_ok()
    rep.detail = (f"corrupted {len(manifests)} manifests; "
                  f"{len(on_victim)}/{len(subs)} parked at crash")
    return rep


def drill_event_sink_full_disk(fleet) -> DrillReport:
    """Break the JSON-lines event sink (the full-disk class: writes to
    the telemetry path start failing); assert the degradation is visible
    as a firing alert via the ``ict_prove_event_sink_degraded`` gauge,
    jobs keep completing losslessly mid-fault (emit never raises — the
    flight ring still mirrors), and restoring the sink resolves it."""
    rep = DrillReport(fault="event_sink_full_disk")
    baseline = len(fleet.router.alerts.recent())
    done0 = fleet.jobs_done()
    good = events.configured_sink()
    blocker = os.path.join(fleet.workdir, "sink_blocker")
    with open(blocker, "w") as fh:
        fh.write("a regular file where a directory must be\n")
    try:
        # Writes now fail with ENOTDIR — same observable as ENOSPC: the
        # sink enters its drop window and sink_degraded() goes true.
        events.configure(os.path.join(blocker, "events.jsonl"))
        events.emit("prove_sink_probe", drill="event_sink_full_disk")
        rep.injected = events.sink_degraded()
        rep.alert_fired = _await_alert(
            fleet, RULE_SINK_DEGRADED, "firing", baseline)
        # Zero loss mid-fault: one job end to end while events drop.
        subs = _drill_subs(fleet, "sink", 1, offset=4)
        replies = [fleet.submit(s) for s in subs]
        rep.masks_ok, rep.ledger_ok = _settle(fleet, subs, replies, done0)
    finally:
        events.configure(good)   # heal: restore the sink
    rep.alert_resolved = _await_alert(
        fleet, RULE_SINK_DEGRADED, "resolved", baseline)
    rep.healed = (not events.sink_degraded()) and rep.alert_resolved
    rep.cost_ok = fleet.cost_conservation_ok()
    rep.detail = "sink wedged via ENOTDIR stand-in for ENOSPC, restored"
    return rep


#: The drill catalog: name -> drill(fleet) -> DrillReport.
DRILLS = {
    "replica_kill": drill_replica_kill,
    "wedged_backend": drill_wedged_backend,
    "corrupt_spool": drill_corrupt_spool,
    "event_sink_full_disk": drill_event_sink_full_disk,
}

#: The CI smoke lane runs exactly one drill (the ~90 s budget).
SMOKE_DRILLS = ("replica_kill",)
