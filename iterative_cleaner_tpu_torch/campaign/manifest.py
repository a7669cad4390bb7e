"""Campaign manifest grammar: validation, glob expansion, and the
deterministic per-archive idempotency keys.

Port of ``iterative_cleaner_tpu/campaign/manifest.py``.

A manifest is one JSON object::

    {
      "name": "survey-2026A",              // optional display label
      "tenant": "survey",                  // showback identity ("default")
      "archives": ["/data/a.npz", ...],    // explicit archive paths
      "globs": ["/data/night1/*.npz"],     // expanded (sorted) at POST time
      "config": {"max_iter": 12},          // PROVENANCE ONLY — recorded on
                                           // the campaign, never shipped to
                                           // replicas (replicas own their
                                           // CleanConfig; the cache-salt
                                           // discipline, docs/SERVING.md)
      "overrides": {                       // optional per-archive knobs,
        "/data/a.npz": {"shape": [8, 32, 128], "audit": true}
      },                                   // limited to the POST /jobs
                                           // fields: shape/audit/profile
      "max_inflight": 8,                   // per-campaign placement pacing
      "synthetic": false                   // canary micro-campaigns only:
                                           // stamps every archive job
                                           // synthetic=true (fleet/canary.py)
    }

``archives`` keeps submission order and MAY repeat a path — duplicates
get distinct idempotency keys (the key includes the entry index) so they
become separate placements that resolve born-terminal out of the fleet
result cache instead of idempotency-deduping into one job.  The
per-archive key is a pure function of (campaign id, index, path):
restart-resume and failover re-submissions regenerate the exact same
key, which is what makes them exactly-once by construction.
"""

from __future__ import annotations

import glob as _glob
import hashlib
import time
import uuid

#: Default per-campaign ceiling on simultaneously open placements —
#: pacing, not admission: the router's WFQ/quota machinery stays the
#: real arbiter, this just keeps one campaign from parking thousands of
#: placements (and their slots) at once.
DEFAULT_MAX_INFLIGHT = 8

#: Per-archive override fields honored (the POST /jobs payload surface).
OVERRIDE_FIELDS = ("shape", "audit", "profile")


def new_campaign_id() -> str:
    """Time-sortable unique id (the service.jobs.new_job_id idiom):
    lexicographic order of ids == creation order across a spool replay."""
    return f"c{int(time.time() * 1000):013d}-{uuid.uuid4().hex[:6]}"


def archive_idem_key(campaign_id: str, index: int, path: str) -> str:
    """The deterministic campaign-scoped idempotency key for one archive
    entry.  Includes the ENTRY INDEX so a path listed twice yields two
    distinct keys (duplicates must reach the fleet result cache, not the
    idempotency dedupe), and a path digest so keys stay opaque-safe for
    HTTP/file use whatever the path contains."""
    digest = hashlib.sha256(path.encode()).hexdigest()[:12]
    return f"campaign-{campaign_id}-{int(index):05d}-{digest}"


def _clean_overrides(raw: dict) -> dict:
    """One archive's override dict, restricted to the POST /jobs fields
    the replicas honor; anything else is a manifest error (silently
    dropping a knob the operator typed would misclean quietly)."""
    if not isinstance(raw, dict):
        raise ValueError("overrides entries must be JSON objects")
    unknown = sorted(set(raw) - set(OVERRIDE_FIELDS))
    if unknown:
        raise ValueError(
            f"unsupported override field(s) {unknown}; per-archive "
            f"overrides are limited to {list(OVERRIDE_FIELDS)} — cleaning "
            "config belongs to the replicas (docs/SERVING.md 'Campaigns')")
    out: dict = {}
    if "shape" in raw:
        shape = raw["shape"]
        if (not isinstance(shape, (list, tuple)) or len(shape) != 3):
            raise ValueError(f"override shape must be [nsub, nchan, nbin], "
                             f"got {shape!r}")
        out["shape"] = [int(v) for v in shape]
    for flag in ("audit", "profile"):
        if flag in raw:
            out[flag] = bool(raw[flag])
    return out


def compile_manifest(raw: dict, campaign_id: str | None = None) -> dict:
    """Validate one manifest object and compile it into the campaign
    record the store persists: ``{"id", "name", "tenant", "state",
    "created_s", "max_inflight", "config", "entries": [{"index", "path",
    "idem_key", "overrides"}, ...]}``.  Raises ValueError with an
    operator-actionable message on any grammar violation (the
    parse_tenant_specs convention)."""
    if not isinstance(raw, dict):
        raise ValueError("a campaign manifest must be a JSON object")
    unknown = sorted(set(raw) - {"name", "tenant", "archives", "globs",
                                 "config", "overrides", "max_inflight",
                                 "synthetic"})
    if unknown:
        raise ValueError(f"unknown manifest field(s) {unknown}; see "
                         "docs/SERVING.md 'Campaigns' for the grammar")
    cid = campaign_id or new_campaign_id()
    name = str(raw.get("name", "") or cid)
    tenant = str(raw.get("tenant", "") or "default")
    # Canary micro-campaigns (fleet/canary.py): every archive job is
    # stamped synthetic=true so the probe stays out of capacity demand,
    # tenant quotas, and cost showback.
    synthetic = bool(raw.get("synthetic", False))
    config = raw.get("config") or {}
    if not isinstance(config, dict):
        raise ValueError("manifest config must be a JSON object "
                         "(recorded as provenance only)")

    paths: list[str] = []
    archives = raw.get("archives", [])
    if not isinstance(archives, list) or not all(
            isinstance(p, str) and p for p in archives):
        raise ValueError("manifest archives must be a list of path strings")
    paths.extend(archives)
    globs = raw.get("globs", [])
    if not isinstance(globs, list) or not all(
            isinstance(g, str) and g for g in globs):
        raise ValueError("manifest globs must be a list of glob strings")
    for pattern in globs:
        # Sorted expansion: the entry order (and therefore every
        # idempotency key) is deterministic across restarts and hosts.
        paths.extend(sorted(_glob.glob(pattern)))
    if not paths:
        raise ValueError("manifest names no archives (empty archives list "
                         "and no glob matched anything)")

    overrides = raw.get("overrides") or {}
    if not isinstance(overrides, dict):
        raise ValueError("manifest overrides must map archive path -> "
                         "override object")
    stray = sorted(set(overrides) - set(paths))
    if stray:
        raise ValueError(f"overrides name path(s) not in the campaign: "
                         f"{stray}")

    try:
        max_inflight = int(raw.get("max_inflight", DEFAULT_MAX_INFLIGHT))
    except (TypeError, ValueError) as exc:
        raise ValueError(f"bad max_inflight {raw.get('max_inflight')!r}; "
                         "want an int >= 1") from exc
    if max_inflight < 1:
        raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")

    entries = [{
        "index": i,
        "path": p,
        "idem_key": archive_idem_key(cid, i, p),
        "overrides": _clean_overrides(overrides.get(p, {})),
    } for i, p in enumerate(paths)]
    return {
        "id": cid,
        "name": name,
        "tenant": tenant,
        "synthetic": synthetic,
        "state": "open",
        "created_s": round(time.time(), 3),
        "finished_s": 0.0,
        "max_inflight": max_inflight,
        "config": config,
        "n_archives": len(entries),
        "entries": entries,
    }
