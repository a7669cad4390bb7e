"""Spool-persisted campaign state: ``<spool>/campaigns/<id>/``.

Port of ``iterative_cleaner_tpu/campaign/store.py``.

One directory per campaign holding ``manifest.json`` (the compiled
campaign record — identity, tenant, entry list with pinned idempotency
keys) and one ``a<index>.json`` status record per archive.  Every write
is .part-rename atomic under one lock (the service.jobs.JobSpool
discipline), so a router killed mid-update never leaves a truncated
record, and a restarted router rehydrates open campaigns and resumes
only their non-terminal archives.
"""

from __future__ import annotations

import json
import os
import threading

#: Archive lifecycle: pending -> placed -> done | error | cancelled.
ARCHIVE_STATES = ("pending", "placed", "done", "error", "cancelled")
ARCHIVE_TERMINAL = ("done", "error", "cancelled")

#: Campaign lifecycle: open -> done | failed | cancelled.
CAMPAIGN_TERMINAL = ("done", "failed", "cancelled")


class CampaignStore:
    """Directory of per-campaign subdirectories; the orchestrator's
    durable state.  All mutation goes through the save methods under one
    lock — records are tiny, and serialized writes keep the
    rename-atomic invariant simple across the poll and HTTP threads."""

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()

    def _dir(self, campaign_id: str) -> str | None:
        """Campaign directory for an id, or None for anything that is
        not a plain directory name — ids come straight off the HTTP path
        (GET /campaigns/<id>), so '../'-shaped ids must never resolve
        outside the spool (the JobSpool._manifest guard)."""
        cid = str(campaign_id)
        if os.path.basename(cid) != cid or not cid or cid.startswith("."):
            return None
        return os.path.join(self.root, cid)

    def _write(self, path: str, record: dict) -> None:
        tmp = f"{path}.part"
        with self._lock:
            with open(tmp, "w") as fh:
                json.dump(record, fh, indent=1)
                fh.write("\n")
            os.replace(tmp, path)

    @staticmethod
    def _read(path: str) -> dict | None:
        try:
            with open(path) as fh:
                d = json.load(fh)
            return d if isinstance(d, dict) else None
        # TypeError/ValueError cover foreign or truncated JSON: one
        # unreadable file degrades to "no record", never crash-loops the
        # startup rehydrate (the JobSpool.get convention).
        except (OSError, ValueError, TypeError):
            return None

    def save_campaign(self, record: dict) -> None:
        d = self._dir(record["id"])
        if d is None:
            raise ValueError(f"unsaveable campaign id {record['id']!r}")
        os.makedirs(d, exist_ok=True)
        self._write(os.path.join(d, "manifest.json"), record)

    def save_archive(self, campaign_id: str, record: dict) -> None:
        d = self._dir(campaign_id)
        if d is None:
            raise ValueError(f"unsaveable campaign id {campaign_id!r}")
        self._write(os.path.join(d, f"a{int(record['index']):05d}.json"),
                    record)

    def load_campaign(self, campaign_id: str) -> dict | None:
        d = self._dir(campaign_id)
        if d is None:
            return None
        rec = self._read(os.path.join(d, "manifest.json"))
        if rec is None or rec.get("id") != campaign_id:
            # The inner id must round-trip to the directory name — a
            # mismatched record would duplicate the campaign under a
            # second identity on the next save.
            return None
        return rec

    def load_archives(self, campaign_id: str) -> list[dict]:
        """Per-archive status records in index order; entries whose
        status file is missing or unreadable are simply absent (the
        rehydrate path re-seeds them as pending from the manifest)."""
        d = self._dir(campaign_id)
        if d is None or not os.path.isdir(d):
            return []
        out = []
        for name in sorted(os.listdir(d)):
            if not (name.startswith("a") and name.endswith(".json")):
                continue
            rec = self._read(os.path.join(d, name))
            if rec is not None and "index" in rec:
                out.append(rec)
        return out

    def list_ids(self) -> list[str]:
        """Every persisted campaign id, in id (== creation) order."""
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            return []
        return [n for n in names
                if self._dir(n) is not None
                and os.path.isfile(os.path.join(self.root, n,
                                                "manifest.json"))]

    def sweep_parts(self) -> None:
        """Remove orphaned atomic-write temps (a router killed between
        the .part write and the rename).  Runs once at rehydrate, before
        any writer thread exists — the JobSpool.trim discipline."""
        for cid in self.list_ids():
            d = self._dir(cid)
            try:
                names = os.listdir(d)
            except OSError:
                continue
            for name in names:
                if name.endswith(".part"):
                    try:
                        os.remove(os.path.join(d, name))
                    except OSError:
                        pass
