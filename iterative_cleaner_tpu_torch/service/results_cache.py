"""Replica-side content-addressed result cache (keys from ingest/cas.py).

A copy of ``iterative_cleaner_tpu/service/results_cache.py``.

One record per :func:`~iterative_cleaner_tpu_torch.ingest.cas.cube_key`: the
FINAL weights mask (post bad-parts sweep -- exactly what the emit path
hands the output policy) plus the scalar result fields a job manifest
reports.  The dispatch worker checks it before any device dispatch; a
hit re-emits the cached mask against the freshly decoded archive, so the
written output is byte-identical to a fresh clean while the device is
never touched (the key already covers cube bytes + config + version, so
"identical" is by construction, and the shadow auditor can still be
asked to prove it per job).

Two tiers, both bounded:

- an in-memory LRU of ``capacity`` records (masks are (nsub, nchan)
  f32 maps -- KBs to a few MBs each, nothing like cube residency);
- optional spool persistence under ``<spool>/results-cache/`` -- one
  ``<key>.npz`` next to the job index, same ``.part``-rename atomicity
  as job manifests, oldest files swept beyond ``2 x capacity`` -- so a
  restarted replica keeps answering yesterday's campaign from disk.

Invalidation is upstream: the key's salt (ingest/cas.py) folds in the
package version and every mask-affecting config field, so stale entries
go unreachable rather than wrong; the LRU/file sweeps reclaim them.
"""

from __future__ import annotations

import collections
import json
import os
import threading

import numpy as np

#: Persisted files kept per cache directory, as a multiple of the
#: in-memory capacity (disk is the warm-restart tier, not an archive).
DISK_KEEP_FACTOR = 2

#: The scalar fields a cache record carries next to the mask.
_META_FIELDS = ("loops", "converged", "rfi_frac", "termination",
                "origin_job_id")


class ResultCache:
    """Bounded LRU of cleaned-mask records, keyed by content address.
    Thread-safe: the loader/worker/HTTP threads share one instance per
    replica (it lives on the ReplicaContext, never process-global)."""

    def __init__(self, capacity: int, root: str = "") -> None:
        self.capacity = max(int(capacity), 0)
        self.root = root if self.capacity else ""
        # RLock, deliberately: the LRU trim takes it lexically (the
        # ICT007 discipline, the context._trim_idem_locked pattern)
        # while its callers already hold it.
        self._lock = threading.RLock()
        self._mem: collections.OrderedDict = collections.OrderedDict()  # ict: guarded-by(self._lock)
        # Approximate persisted-file count so the disk sweep (a full
        # listdir + stat pass) only runs when the budget may actually be
        # exceeded, not on every job completion.  None = not counted
        # yet; key overwrites over-count, which only sweeps early.
        self._disk_files: int | None = None  # ict: guarded-by(self._lock)
        if self.root:
            os.makedirs(self.root, exist_ok=True)

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._mem)

    def _path(self, key: str) -> str | None:
        # Keys are hex digests we minted, but the path join stays
        # defensive anyway (the spool's job-id rule).
        name = f"{key}.npz"
        if not self.root or os.path.basename(name) != name \
                or key.startswith("."):
            return None
        return os.path.join(self.root, name)

    def get(self, key: str) -> dict | None:
        """The cached record for ``key`` (memory first, then disk --
        a disk hit is promoted), or None.  Returned dicts are copies;
        the weights array is shared read-only by convention."""
        if not self.enabled or not key:
            return None
        with self._lock:
            rec = self._mem.get(key)
            if rec is not None:
                self._mem.move_to_end(key)
                return dict(rec)
        rec = self._load(key)
        if rec is None:
            return None
        with self._lock:
            self._mem[key] = rec
            self._mem.move_to_end(key)
            self._trim_mem_locked()
        return dict(rec)

    def put(self, key: str, weights: np.ndarray, *, loops: int,
            converged: bool, rfi_frac: float, termination: str,
            origin_job_id: str = "") -> None:
        """Store one finished clean's record (write-through to disk when
        persistence is on).  Persistence failures are swallowed: the
        cache is an optimization, the spool manifest stays the durable
        record of the job itself."""
        if not self.enabled or not key:
            return
        rec = {
            "weights": np.ascontiguousarray(np.asarray(weights)),
            "loops": int(loops),
            "converged": bool(converged),
            "rfi_frac": float(rfi_frac),
            "termination": str(termination),
            "origin_job_id": str(origin_job_id),
        }
        with self._lock:
            self._mem[key] = rec
            self._mem.move_to_end(key)
            self._trim_mem_locked()
        self._persist(key, rec)

    def _trim_mem_locked(self) -> None:
        # Takes the (reentrant) lock itself so the eviction stays
        # lexically guarded; every caller already holds it.
        with self._lock:
            while len(self._mem) > self.capacity:
                self._mem.popitem(last=False)

    # --- the disk tier ---

    def _persist(self, key: str, rec: dict) -> None:
        path = self._path(key)
        if path is None:
            return
        tmp = f"{path}.part"
        try:
            meta = {f: rec[f] for f in _META_FIELDS}
            # A file handle, not the path: np.savez would append ".npz"
            # to a string name and break the .part-rename atomicity.
            with open(tmp, "wb") as fh:
                np.savez(fh, weights=rec["weights"],
                         meta=np.frombuffer(
                             json.dumps(meta).encode(), dtype=np.uint8))
            os.replace(tmp, path)
            keep = self.capacity * DISK_KEEP_FACTOR
            with self._lock:
                if self._disk_files is None:
                    self._disk_files = len(
                        [n for n in os.listdir(self.root)
                         if n.endswith(".npz")])
                else:
                    self._disk_files += 1
                due = self._disk_files > keep
            if due:
                self._sweep_disk()
        except Exception:  # noqa: BLE001 -- persistence is best-effort
            try:
                os.remove(tmp)
            except OSError:
                pass

    def _load(self, key: str) -> dict | None:
        path = self._path(key)
        if path is None or not os.path.exists(path):
            return None
        try:
            with np.load(path) as z:
                weights = np.asarray(z["weights"])
                meta = json.loads(bytes(np.asarray(z["meta"])).decode())
            return {"weights": weights,
                    **{f: meta.get(f) for f in _META_FIELDS}}
        except Exception:  # noqa: BLE001 -- a corrupt entry is a miss
            try:
                os.remove(path)
            except OSError:
                pass
            return None

    def _sweep_disk(self) -> None:
        """Drop the oldest persisted entries beyond the disk budget
        (mtime order; the spool-trim rationale).  Called only when the
        in-memory file counter says the budget may be exceeded; the
        counter is re-anchored to the true count afterwards."""
        keep = self.capacity * DISK_KEEP_FACTOR
        try:
            names = [n for n in os.listdir(self.root)
                     if n.endswith(".npz")]
            if len(names) > keep:
                stamped = sorted(
                    (os.path.getmtime(os.path.join(self.root, n)), n)
                    for n in names)
                for _mtime, name in stamped[: len(names) - keep]:
                    try:
                        os.remove(os.path.join(self.root, name))
                        names.remove(name)
                    except OSError:
                        continue
            with self._lock:
                self._disk_files = len(names)
        except OSError:
            pass
