"""The campaign orchestrator: a state machine driven from the fleet
router's poll tick.

Port of ``iterative_cleaner_tpu/campaign/orchestrator.py``.

One instance lives on the router.  Each :meth:`tick` (poll_tick's
campaign step) advances every open campaign: observe placed archives
through :meth:`~..fleet.router.FleetRouter.job_manifest` (the same
status-refresh path ordinary placements use — failover, death handling
and the synthetic "replica unreachable" pending view all come for free),
fold terminal results into the spool, and submit pending archives
through :meth:`~..fleet.router.FleetRouter.place_job` under their pinned
campaign-scoped idempotency keys, paced by the campaign's
``max_inflight``.

Restart-resume: the constructor rehydrates every persisted campaign;
open campaigns demote their ``placed`` archives back to ``pending`` (the
service.jobs.recover idiom — the placement table died with the old
router) and the next ticks re-place them under the SAME keys, so an
archive whose job already finished on a replica dedupes against the
replica-side idempotency map instead of running again, and terminal
archives are never resubmitted at all.

Locking: one orchestrator lock guards the in-memory campaign/archive
tables, ordered strictly AFTER the router's RLock — this module never
calls back into the router (place_job, job_manifest) while holding its
own lock; ticks snapshot under the lock, call out unlocked, then
re-acquire to record.
"""

from __future__ import annotations

import sys
import threading
import time

from iterative_cleaner_tpu_torch.campaign import rollup
from iterative_cleaner_tpu_torch.campaign.manifest import compile_manifest
from iterative_cleaner_tpu_torch.campaign.store import (
    ARCHIVE_TERMINAL,
    CAMPAIGN_TERMINAL,
    CampaignStore,
)
from iterative_cleaner_tpu_torch.obs import events

#: Consecutive 404 status reads before a placed archive is re-queued
#: under its pinned key (its placement was trimmed from the router
#: table); immediate on rehydrate, where the table is known-gone.
MISSING_BEFORE_REQUEUE = 2

#: Re-queue ceiling per archive: a placement that keeps vanishing is a
#: real fault (replica spool clearing, placement-table thrash), and the
#: archive fails terminally instead of cycling forever.
MAX_REQUEUES = 5

#: A ``done`` manifest can be HTTP-visible a beat before the dispatch
#: worker finalizes its CostRecord (the run_fleet_smoke conservation
#: lane's retry rationale); hold a done archive open this many extra
#: polls waiting for cost to land before folding it without one.
COST_SETTLE_POLLS = 5

#: Terminal campaigns kept in memory (list/GET views); the spool keeps
#: everything — the placement_keep bounded-memory rationale.
KEEP_TERMINAL = 50

#: Gauge states always pre-registered (the pre-registration-at-0 lesson:
#: docs gates and gt-threshold rules need the series before first use).
_ARCHIVE_GAUGE_STATES = ("pending", "placed", "done", "error", "cancelled")


class CampaignOrchestrator:
    """Owns every campaign's lifecycle on one router; constructed by
    FleetRouter.__init__ and ticked from its poll loop."""

    def __init__(self, store: CampaignStore, router, quiet: bool = True,
                 ) -> None:
        self.store = store
        self._router = router       # back-ref; never called under _lock
        self.quiet = quiet
        self._lock = threading.Lock()
        # cid -> campaign record (the persisted manifest.json shape).
        self._campaigns: dict[str, dict] = {}  # ict: guarded-by(self._lock)
        # cid -> {index -> archive status record}.
        self._archives: dict[str, dict[int, dict]] = {}  # ict: guarded-by(self._lock)
        self._rehydrate()

    # --- rehydration (router start) ---

    def _rehydrate(self) -> None:
        """Reload every persisted campaign; open ones resume — terminal
        archives stay terminal (never resubmitted), placed ones demote
        to pending for re-placement under their pinned keys."""
        self.store.sweep_parts()
        for cid in self.store.list_ids():
            camp = self.store.load_campaign(cid)
            if camp is None:
                continue
            records: dict[int, dict] = {}
            if camp.get("state") not in CAMPAIGN_TERMINAL:
                on_disk = {int(r["index"]): r
                           for r in self.store.load_archives(cid)}
                for entry in camp.get("entries", []):
                    idx = int(entry["index"])
                    rec = on_disk.get(idx) or self._seed_archive(entry)
                    if rec.get("state") == "placed":
                        # The old router's placement table died with it;
                        # the pinned idempotency key makes the re-place
                        # dedupe instead of re-clean.
                        rec["state"] = "pending"
                        rec["requeues"] = int(rec.get("requeues", 0)) + 1
                        self.store.save_archive(cid, rec)
                    records[idx] = rec
                if not self.quiet:
                    open_n = sum(1 for r in records.values()
                                 if r["state"] not in ARCHIVE_TERMINAL)
                    print(f"ict-fleet: campaign {cid} rehydrated "
                          f"({open_n}/{len(records)} archives to resume)",
                          file=sys.stderr)
            with self._lock:
                self._campaigns[cid] = camp
                self._archives[cid] = records
        self._trim()

    @staticmethod
    def _seed_archive(entry: dict) -> dict:
        return {
            "index": int(entry["index"]),
            "path": str(entry["path"]),
            "idem_key": str(entry["idem_key"]),
            "overrides": dict(entry.get("overrides") or {}),
            "state": "pending",
            "job_id": "",
            "trace_id": "",
            "attempts": 0,
            "requeues": 0,
            "missing_polls": 0,
            "cost_polls": 0,
            "error": "",
            "out_path": "",
            "served_by": "",
            "termination": "",
            "replica_id": "",
            "quality": {},
            "cost": {},
            "finished_s": 0.0,
        }

    # --- the lifecycle API (HTTP handlers) ---

    def create(self, raw_manifest: dict) -> dict:
        """POST /campaigns: compile, persist, register.  Placement
        begins on the next poll tick (submission stays on the poll
        thread, the one-writer discipline).  Raises ValueError on a
        grammar violation (-> 400)."""
        camp = compile_manifest(raw_manifest)
        records = {int(e["index"]): self._seed_archive(e)
                   for e in camp["entries"]}
        self.store.save_campaign(camp)
        with self._lock:
            self._campaigns[camp["id"]] = camp
            self._archives[camp["id"]] = records
        if events.active():
            events.emit("campaign_created", campaign_id=camp["id"],
                        name=camp["name"], tenant=camp["tenant"],
                        archives=camp["n_archives"])
        if not self.quiet:
            print(f"ict-fleet: campaign {camp['id']} created "
                  f"({camp['n_archives']} archives, tenant "
                  f"{camp['tenant']!r})", file=sys.stderr)
        return self._summary_row(camp, records)

    def list(self) -> list[dict]:
        with self._lock:
            rows = [(dict(c), dict(self._archives.get(cid, {})))
                    for cid, c in self._campaigns.items()]
        return [self._summary_row(c, recs) for c, recs in rows]

    def get(self, campaign_id: str) -> dict | None:
        """GET /campaigns/<id>: the full view — per-archive states, the
        QA roll-up, and the cost showback."""
        with self._lock:
            camp = self._campaigns.get(campaign_id)
            records = dict(self._archives.get(campaign_id, {}))
        if camp is None:
            # Trimmed from memory but maybe still on the spool.
            camp = self.store.load_campaign(campaign_id)
            if camp is None:
                return None
            records = {int(r["index"]): r
                       for r in self.store.load_archives(campaign_id)}
        recs = [records[i] for i in sorted(records)]
        view = self._summary_row(camp, records)
        view["config"] = camp.get("config", {})
        view["max_inflight"] = camp.get("max_inflight")
        view["archive_records"] = [{
            "index": r["index"], "path": r["path"], "state": r["state"],
            "job_id": r.get("job_id", ""),
            "idem_key": r.get("idem_key", ""),
            "attempts": r.get("attempts", 0),
            "served_by": r.get("served_by", ""),
            "replica_id": r.get("replica_id", ""),
            "out_path": r.get("out_path", ""),
            "error": r.get("error", ""),
        } for r in recs]
        view["rollup"] = rollup.fold_quality(recs)
        view["cost"] = rollup.fold_cost(recs)
        return view

    def cancel(self, campaign_id: str) -> dict | None:
        """POST /campaigns/<id>/cancel: pending archives cancel
        immediately; placed ones finish on their replicas (accepted work
        is never yanked — the drain semantics) and keep being observed
        until the campaign settles terminally cancelled."""
        with self._lock:
            camp = self._campaigns.get(campaign_id)
            if camp is None:
                return None
            records = self._archives.get(campaign_id, {})
            if camp["state"] not in CAMPAIGN_TERMINAL:
                camp["state"] = "cancelled"
                for rec in records.values():
                    if rec["state"] == "pending":
                        rec["state"] = "cancelled"
                        rec["finished_s"] = round(time.time(), 3)
                        self.store.save_archive(campaign_id, rec)
                if not any(r["state"] == "placed"
                           for r in records.values()):
                    camp["finished_s"] = round(time.time(), 3)
                self.store.save_campaign(camp)
            row = self._summary_row(dict(camp), dict(records))
        if events.active():
            events.emit("campaign_cancelled", campaign_id=campaign_id)
        return row

    # --- the poll-tick step ---

    def tick(self) -> None:
        """Advance every campaign that still has work: observe placed
        archives, submit pending ones, finish settled campaigns.  Runs
        on the router's poll thread only."""
        with self._lock:
            active = [cid for cid, c in self._campaigns.items()
                      if c["state"] == "open"
                      or any(r["state"] == "placed"
                             for r in self._archives.get(cid, {}).values())]
        for cid in active:
            self._observe(cid)
            self._submit_pending(cid)
            self._maybe_finish(cid)

    def _observe(self, cid: str) -> None:
        with self._lock:
            placed = [dict(r) for r in self._archives.get(cid, {}).values()
                      if r["state"] == "placed"]
        for rec in placed:
            code, manifest = self._router.job_manifest(rec["job_id"])
            if code == 404:
                self._requeue(cid, rec["index"])
                continue
            if code != 200 or manifest.get("state") not in ("done", "error"):
                continue   # still open (or synthetic pending) — next tick
            if (manifest.get("state") == "done"
                    and not manifest.get("cost")
                    and rec.get("cost_polls", 0) < COST_SETTLE_POLLS):
                # The manifest can turn done a beat before the worker
                # persists its CostRecord; hold for a few polls so the
                # showback fold doesn't under-report.
                with self._lock:
                    live = self._archives.get(cid, {}).get(rec["index"])
                    if live is not None and live["state"] == "placed":
                        live["cost_polls"] = live.get("cost_polls", 0) + 1
                continue
            self._record_terminal(cid, rec["index"], manifest)

    def _requeue(self, cid: str, index: int) -> None:
        """A placed archive the router no longer knows (trimmed table,
        restarted router): back to pending under the SAME pinned key —
        bounded, then terminally failed."""
        with self._lock:
            rec = self._archives.get(cid, {}).get(index)
            if rec is None or rec["state"] != "placed":
                return
            rec["missing_polls"] = rec.get("missing_polls", 0) + 1
            if rec["missing_polls"] < MISSING_BEFORE_REQUEUE:
                return
            rec["missing_polls"] = 0
            rec["requeues"] = int(rec.get("requeues", 0)) + 1
            if rec["requeues"] > MAX_REQUEUES:
                rec["state"] = "error"
                rec["error"] = (f"placement lost {rec['requeues']} times "
                                "(replica spool cleared / placement table "
                                "thrash); giving up")
                rec["finished_s"] = round(time.time(), 3)
            else:
                rec["state"] = "pending"
            self.store.save_archive(cid, rec)

    def _record_terminal(self, cid: str, index: int, manifest: dict) -> None:
        updates = {
            "state": str(manifest.get("state", "error")),
            "error": str(manifest.get("error", "") or ""),
            "out_path": str(manifest.get("out_path", "") or ""),
            "served_by": str(manifest.get("served_by", "") or ""),
            "termination": str(manifest.get("termination", "") or ""),
            "replica_id": str(manifest.get("replica_id", "") or ""),
            "quality": (manifest.get("quality")
                        if isinstance(manifest.get("quality"), dict)
                        else {}),
            "cost": (manifest.get("cost")
                     if isinstance(manifest.get("cost"), dict) else {}),
            "finished_s": round(time.time(), 3),
        }
        with self._lock:
            rec = self._archives.get(cid, {}).get(index)
            if rec is None or rec["state"] in ARCHIVE_TERMINAL:
                return
            rec.update(updates)
            self.store.save_archive(cid, rec)
            tenant = self._campaigns.get(cid, {}).get("tenant", "")
        if updates["state"] == "error" and events.active():
            events.emit("campaign_archive_error", campaign_id=cid,
                        archive_index=index, tenant=tenant,
                        error=updates["error"])

    def _submit_pending(self, cid: str) -> None:
        # Imported here, not at module top: fleet/__init__ imports the
        # router, which constructs this orchestrator — a module-level
        # import back into fleet would be circular.
        from iterative_cleaner_tpu_torch.fleet.client import ReplicaRefused
        from iterative_cleaner_tpu_torch.fleet.tenants import QuotaExceeded
        with self._lock:
            camp = self._campaigns.get(cid)
            records = self._archives.get(cid, {})
            if camp is None or camp["state"] != "open":
                return
            open_n = sum(1 for r in records.values()
                         if r["state"] == "placed")
            budget = max(int(camp.get("max_inflight", 1)) - open_n, 0)
            todo = [dict(r) for r in
                    sorted(records.values(), key=lambda r: r["index"])
                    if r["state"] == "pending"][:budget]
            tenant = str(camp.get("tenant", "") or "default")
            synthetic = bool(camp.get("synthetic", False))
        for rec in todo:
            payload = {
                "path": rec["path"],
                "idempotency_key": rec["idem_key"],
                "tenant": tenant,
            }
            if synthetic:
                # Canary campaigns (fleet/canary.py): the flag rides
                # every archive job end-to-end, keeping the probe out of
                # the demand/quota/cost planes it measures.
                payload["synthetic"] = True
            payload.update(rec.get("overrides") or {})
            trace_id = rec.get("trace_id") or events.new_trace_id()
            try:
                reply = self._router.place_job(payload, tenant, trace_id)
            except QuotaExceeded:
                break        # admission says no — next tick retries
            except ReplicaRefused as exc:
                # The fleet itself rejected the archive (e.g. --root
                # refusal, bad path): terminal, not retryable.
                self._fail_archive(cid, rec["index"], str(exc))
                continue
            except Exception as exc:  # noqa: BLE001
                # FleetBusy (no slot / everyone draining) and transport
                # surprises both mean "not now": stop submitting this
                # tick, the archive stays pending.
                if not self.quiet:
                    print(f"ict-fleet: campaign {cid} pausing submissions "
                          f"this tick ({exc})", file=sys.stderr)
                break
            self._note_placed(cid, rec["index"], trace_id, reply)

    def _note_placed(self, cid: str, index: int, trace_id: str,
                     reply: dict) -> None:
        job_id = str(reply.get("id", "") or "")
        with self._lock:
            rec = self._archives.get(cid, {}).get(index)
            if rec is None or rec["state"] != "pending":
                return
            rec["job_id"] = job_id
            rec["trace_id"] = trace_id
            rec["attempts"] = int(rec.get("attempts", 0)) + 1
            rec["state"] = "placed"
            rec["missing_polls"] = 0
            self.store.save_archive(cid, rec)
        if reply.get("state") in ("done", "error"):
            # Born terminal: a fleet-cache hit, or a replica-side
            # idempotency dedupe against an already-finished job (the
            # restart-resume path) — fold it now, no status poll needed.
            self._record_terminal(cid, index, reply)

    def _maybe_finish(self, cid: str) -> None:
        with self._lock:
            camp = self._campaigns.get(cid)
            records = self._archives.get(cid, {})
            if camp is None or camp["state"] in CAMPAIGN_TERMINAL:
                # A cancelled campaign still settles its finished_s once
                # the last placed archive lands.
                if (camp is not None and camp["state"] == "cancelled"
                        and not camp.get("finished_s")
                        and not any(r["state"] == "placed"
                                    for r in records.values())):
                    camp["finished_s"] = round(time.time(), 3)
                    self.store.save_campaign(camp)
                return
            if any(r["state"] not in ARCHIVE_TERMINAL
                   for r in records.values()):
                return
            errors = sum(1 for r in records.values()
                         if r["state"] == "error")
            camp["state"] = "failed" if errors else "done"
            camp["finished_s"] = round(time.time(), 3)
            self.store.save_campaign(camp)
            state, name, total = camp["state"], camp["name"], len(records)
        self._trim()
        if events.active():
            events.emit("campaign_finished", campaign_id=cid,
                        state=state, archives=total, errors=errors)
        if not self.quiet:
            print(f"ict-fleet: campaign {cid} ({name}) finished "
                  f"{state} ({total - errors}/{total} archives clean)",
                  file=sys.stderr)

    def _fail_archive(self, cid: str, index: int, error: str) -> None:
        with self._lock:
            rec = self._archives.get(cid, {}).get(index)
            if rec is None or rec["state"] in ARCHIVE_TERMINAL:
                return
            rec["state"] = "error"
            rec["error"] = error
            rec["finished_s"] = round(time.time(), 3)
            self.store.save_archive(cid, rec)
        if events.active():
            events.emit("campaign_archive_error", campaign_id=cid,
                        archive_index=index, error=error)

    # --- views: gauges, health summary ---

    @staticmethod
    def _summary_row(camp: dict, records: dict[int, dict]) -> dict:
        counts = {s: 0 for s in _ARCHIVE_GAUGE_STATES}
        for rec in records.values():
            counts[rec["state"]] = counts.get(rec["state"], 0) + 1
        return {
            "id": camp["id"],
            "name": camp.get("name", camp["id"]),
            "state": camp.get("state", "open"),
            "tenant": camp.get("tenant", "default"),
            "created_s": camp.get("created_s", 0.0),
            "finished_s": camp.get("finished_s", 0.0),
            "archives": {"total": len(records), **counts},
        }

    def summary(self) -> dict:
        """The /healthz + fleet_top view: open-campaign count, aggregate
        archive states, and per-campaign rows (most recent first)."""
        with self._lock:
            rows = [(dict(c), dict(self._archives.get(cid, {})))
                    for cid, c in self._campaigns.items()]
        states = {s: 0 for s in _ARCHIVE_GAUGE_STATES}
        campaigns = []
        for camp, records in rows:
            row = self._summary_row(camp, records)
            row["device_s"] = rollup.fold_cost(
                list(records.values()))["device_s"]
            campaigns.append(row)
            if camp.get("state") == "open":
                for s in states:
                    states[s] += row["archives"][s]
        campaigns.sort(key=lambda r: r["id"], reverse=True)
        return {
            "open": sum(1 for c, _r in rows if c.get("state") == "open"),
            "archives": states,
            "campaigns": campaigns[:16],
        }

    def gauge_families(self) -> dict[str, dict[tuple, float]]:
        """``ict_campaign_*`` gauge families, rebuilt whole each tick
        (the replace_gauge_family discipline).  The unlabeled aggregate
        samples are ALWAYS present — zero-valued with no campaigns — so
        the documented families stay live on every exposition
        (tests/test_metric_docs.py)."""
        with self._lock:
            rows = [(dict(c), [dict(r) for r in
                               self._archives.get(cid, {}).values()])
                    for cid, c in self._campaigns.items()]
        archives = {(("state", s),): 0.0 for s in _ARCHIVE_GAUGE_STATES}
        device: dict[tuple, float] = {(): 0.0}
        avoided: dict[tuple, float] = {(): 0.0}
        open_n = 0
        for camp, records in rows:
            if camp.get("state") == "open":
                open_n += 1
                for rec in records:
                    key = (("state", rec["state"]),)
                    archives[key] = archives.get(key, 0.0) + 1.0
            cost = rollup.fold_cost(records)
            if cost["jobs_costed"]:
                cid = camp["id"]
                device[(("campaign", cid),)] = cost["device_s"]
                avoided[(("campaign", cid),)] = cost["avoided_device_s"]
                device[()] += cost["device_s"]
                avoided[()] += cost["avoided_device_s"]
        return {
            "campaign_open": {(): float(open_n)},
            "campaign_archives": archives,
            "campaign_device_seconds": device,
            "campaign_cache_avoided_seconds": avoided,
        }

    def _trim(self) -> None:
        """Drop the oldest terminal campaigns from MEMORY beyond
        KEEP_TERMINAL (ids are time-sortable); the spool keeps them all,
        and GET /campaigns/<id> falls back to it for trimmed ids."""
        with self._lock:
            terminal = sorted(cid for cid, c in self._campaigns.items()
                              if c.get("state") in CAMPAIGN_TERMINAL)
            for cid in terminal[:max(len(terminal) - KEEP_TERMINAL, 0)]:
                del self._campaigns[cid]
                self._archives.pop(cid, None)
