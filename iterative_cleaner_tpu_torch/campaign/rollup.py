"""Cross-archive QA roll-up and cost showback folds.

Port of ``iterative_cleaner_tpu/campaign/rollup.py``.

Pure functions over the per-archive status records the store holds —
computed on demand for ``GET /campaigns/<id>`` (records are in hand, the
folds are O(archives) dict arithmetic), never cached, so the view can
not drift from the spool.

The QA fold aggregates the per-job :func:`..obs.quality.quality_summary`
dicts: zap-fraction distribution (histogrammed over the shared
FRACTION_BOUNDS layout, so cross-archive aggregation is addition —
the obs/quality rationale), element-wise summed channel/subint occupancy
histograms, the termination-reason mix, and flagged outlier archives.
The cost fold sums the per-job CostRecords (obs/costs.py) the replicas
stamped on the manifests: attributed device-seconds, compile seconds,
cache-avoided seconds, best roofline attainment — the same records the
fleet cost plane federates, so the campaign's summed device-seconds
reconcile with ``GET /fleet/costs`` by construction.
"""

from __future__ import annotations

import statistics

from iterative_cleaner_tpu_torch.obs.quality import FRACTION_BOUNDS

#: An archive is flagged as a zap-fraction outlier when it deviates from
#: the campaign median by more than max(this floor, 3 sigma) — the floor
#: keeps a tightly-clustered campaign from flagging ulp-level scatter.
OUTLIER_FLOOR = 0.05

#: Minimum quality-bearing archives before deviation flagging engages
#: (a median over 2 points flags everything or nothing, uselessly).
OUTLIER_MIN_JOBS = 5

#: Absolute zap fraction above which an archive is always flagged,
#: whatever the campaign's spread — 90%+ zapped data is ruined science
#: regardless of how uniformly ruined its neighbours are.
ZAP_FRAC_HIGH = 0.9


def fold_quality(records: list[dict]) -> dict:
    """The campaign QA roll-up from per-archive status records (only
    ``done`` archives carry quality; the counts make any gap visible)."""
    done = [r for r in records if r.get("state") == "done"]
    with_q = [(r, r.get("quality") or {}) for r in done
              if isinstance(r.get("quality"), dict) and r.get("quality")]
    zaps = [(r, float(q["zap_frac"])) for r, q in with_q
            if "zap_frac" in q]
    bounds = list(FRACTION_BOUNDS)
    zap_hist = [sum(1 for _r, z in zaps if z <= b) for b in bounds]
    chan_hist = [0] * len(bounds)
    sub_hist = [0] * len(bounds)
    chans_full = subs_full = 0
    termination: dict[str, int] = {}
    for r, q in with_q:
        # Element-wise histogram sums only make sense on the one shared
        # bucket layout; a record from a different-era replica keeps its
        # counts out of the fold rather than corrupting it.
        if list(q.get("occupancy_bounds", bounds)) == bounds:
            for i, n in enumerate(q.get("channel_occupancy_hist")
                                  or []):
                if i < len(bounds):
                    chan_hist[i] += int(n)
            for i, n in enumerate(q.get("subint_occupancy_hist") or []):
                if i < len(bounds):
                    sub_hist[i] += int(n)
        chans_full += int(q.get("channels_fully_zapped", 0))
        subs_full += int(q.get("subints_fully_zapped", 0))
        reason = str(q.get("termination", "")
                     or r.get("termination", "") or "")
        if reason:
            termination[reason] = termination.get(reason, 0) + 1
    outliers = _flag_outliers(zaps)
    values = [z for _r, z in zaps]
    return {
        "jobs": len(done),
        "with_quality": len(with_q),
        "zap_frac": {
            "mean": (round(sum(values) / len(values), 6)
                     if values else None),
            "min": round(min(values), 6) if values else None,
            "max": round(max(values), 6) if values else None,
            "bounds": bounds,
            "hist": zap_hist,
        },
        "channel_occupancy_hist": chan_hist,
        "subint_occupancy_hist": sub_hist,
        "channels_fully_zapped": chans_full,
        "subints_fully_zapped": subs_full,
        "termination": {k: termination[k] for k in sorted(termination)},
        "outliers": outliers,
    }


def _flag_outliers(zaps: list[tuple[dict, float]]) -> list[dict]:
    """Flagged archives: always at ZAP_FRAC_HIGH, plus median-deviation
    flags once the campaign has enough quality-bearing archives for the
    spread to mean anything."""
    flagged: dict[int, dict] = {}

    def flag(r: dict, z: float, reason: str) -> None:
        idx = int(r.get("index", -1))
        rec = flagged.setdefault(idx, {
            "index": idx, "path": r.get("path", ""),
            "zap_frac": round(z, 6), "reasons": []})
        rec["reasons"].append(reason)

    for r, z in zaps:
        if z >= ZAP_FRAC_HIGH:
            flag(r, z, "zap_frac_high")
    if len(zaps) >= OUTLIER_MIN_JOBS:
        values = [z for _r, z in zaps]
        median = statistics.median(values)
        spread = max(3.0 * statistics.pstdev(values), OUTLIER_FLOOR)
        for r, z in zaps:
            if abs(z - median) > spread:
                flag(r, z, "zap_frac_deviates")
    return [flagged[i] for i in sorted(flagged)]


def fold_cost(records: list[dict]) -> dict:
    """The campaign cost showback from the per-job CostRecords riding
    the archive status records.  Cache hits (fleet-tier born-terminal
    and replica-tier) show up as avoided seconds, the dedupe dividend."""
    out = {
        "jobs_costed": 0,
        "device_s": 0.0,
        "phase_s": 0.0,
        "compile_s": 0.0,
        "avoided_device_s": 0.0,
        "cache_hits": 0,
        "attainment": None,
    }
    for r in records:
        cost = r.get("cost")
        if not isinstance(cost, dict) or not cost:
            continue
        out["jobs_costed"] += 1
        out["device_s"] += float(cost.get("device_s", 0.0) or 0.0)
        # Total attributed wall seconds across every phase the replica
        # booked (dispatch, oracle, emit, ...): the oracle route runs on
        # the host and books NO device seconds, so phase_s is the figure
        # that stays meaningful whatever backend served the campaign.
        phases = cost.get("phases")
        if isinstance(phases, dict):
            out["phase_s"] += sum(float(v or 0.0)
                                  for v in phases.values())
        out["compile_s"] += float(cost.get("compile_s", 0.0) or 0.0)
        out["avoided_device_s"] += float(
            cost.get("avoided_device_s", 0.0) or 0.0)
        if cost.get("cache_hit"):
            out["cache_hits"] += 1
        att = cost.get("attainment")
        if isinstance(att, (int, float)) and (
                out["attainment"] is None or att > out["attainment"]):
            out["attainment"] = float(att)
    for key in ("device_s", "phase_s", "compile_s", "avoided_device_s"):
        out[key] = round(out[key], 6)
    return out
