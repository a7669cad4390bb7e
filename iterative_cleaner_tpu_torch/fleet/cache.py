"""Fleet-wide content-addressed result index (the router half of
the reuse tier; replica-side twin in
service/results_cache.py, keys in ingest/cas.py).

Port of ``iterative_cleaner_tpu/fleet/cache.py``.

The router cannot decode archives, so its key is the pair
``(file_digest, cache_salt)``: the plain SHA-256 of the submitted file's
raw bytes (computable at placement time with one streamed read) and the
config/version salt the replicas advertise on ``/healthz``.  Replicas
stamp both fields on every job manifest at ingest; the router learns
``digest -> finished manifest`` from the terminal manifests its status
polls already observe, and a later submission of the same bytes -- on
ANY replica, via any path -- resolves at placement time to the recorded
result: a fleet job that is born terminal, no placement, no quota, no
device dispatch, and (deliberately) no demand counted toward the
capacity model.

Correctness hinges on the salt: the index only answers when every alive
candidate replica advertises the SAME salt as the recorded entry (a
mixed-salt fleet -- mid-rollout -- skips the cache rather than guess
which config would have served the job).  Masks are deterministic
functions of (bytes, salt) by the repo's parity invariant, so a hit is
byte-identical to a fresh clean by construction.
"""

from __future__ import annotations

import collections
import threading

#: Bounded index size -- entries are small manifest summaries, and the
#: placement table's own keep (FleetConfig.placement_keep) is the same
#: order of magnitude.
DEFAULT_CAPACITY = 4096

#: Manifest fields worth replaying to a duplicate submitter.  The
#: timeline is deliberately absent (manifest responses stay lean), and
#: state/served_by/replica_id are rewritten at serve time.
_KEEP_FIELDS = ("out_path", "loops", "converged", "rfi_frac",
                "termination", "shape", "quality", "content_key",
                "file_digest", "cost")


class FleetResultIndex:
    """Bounded LRU: ``(file_digest, cache_salt) -> manifest summary``.
    Written by the router's poll thread (terminal-manifest observation)
    and read by its HTTP handler threads (placement-time lookup); own
    lock, acquired strictly after the router's, never while calling
    out."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        self.capacity = max(int(capacity), 1)
        self._lock = threading.Lock()
        self._index: collections.OrderedDict = collections.OrderedDict()  # ict: guarded-by(self._lock)

    def __len__(self) -> int:
        with self._lock:
            return len(self._index)

    def record(self, manifest: dict, origin_replica: str = "") -> bool:
        """Learn one DONE manifest (idempotent; newest wins).  Returns
        whether the manifest was indexable (carried both keys)."""
        digest = str(manifest.get("file_digest", "") or "")
        salt = str(manifest.get("cache_salt", "") or "")
        if not digest or not salt or manifest.get("state") != "done":
            return False
        entry = {k: manifest[k] for k in _KEEP_FIELDS if k in manifest}
        entry["origin"] = {
            "job_id": str(manifest.get("id", "")),
            "replica_id": origin_replica
            or str(manifest.get("replica_id", "")),
            "served_by": str(manifest.get("served_by", "")),
        }
        with self._lock:
            self._index[(digest, salt)] = entry
            self._index.move_to_end((digest, salt))
            while len(self._index) > self.capacity:
                self._index.popitem(last=False)
        return True

    def lookup(self, digest: str, salt: str) -> dict | None:
        """The recorded summary for (digest, salt), LRU-promoted; a copy
        the caller may annotate freely."""
        if not digest or not salt:
            return None
        with self._lock:
            entry = self._index.get((digest, salt))
            if entry is None:
                return None
            self._index.move_to_end((digest, salt))
            return {**entry, "origin": dict(entry["origin"])}


def unanimous_salt(replica_rows: list[dict]) -> str:
    """The one cache salt every alive candidate advertises, or '' when
    the fleet is mixed (mid-rollout) or nobody advertises one -- the
    gate that keeps a cached mask from answering a submission a
    differently-configured replica would have cleaned differently."""
    salts = {str(r.get("cache_salt", "") or "")
             for r in replica_rows
             if r.get("alive") and not r.get("draining")}
    salts.discard("")
    return salts.pop() if len(salts) == 1 else ""
