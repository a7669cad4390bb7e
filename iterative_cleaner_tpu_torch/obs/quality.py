"""RFI data-quality telemetry: what the cleaner *decided*, as metrics.

A copy of ``iterative_cleaner_tpu/obs/quality.py``.

The serving daemon's existing telemetry says how fast jobs move and what
they cost; nothing says what the science got — a drifting receiver or an
RFI storm shows up as "the daemon is healthy, the data is ruined".  This
module turns every finished clean's mask into a handful of cheap,
aggregatable facts (all O(nsub·nchan) host ops on a mask already in
hand):

- the **zap fraction** (per job, plus a cumulative distribution across
  jobs);
- **per-channel / per-subint occupancy**: for each channel, the fraction
  of its subints zapped (and vice versa), histogrammed over fixed
  fraction buckets — a single hot channel and a uniform storm produce the
  same zap fraction but opposite occupancy histograms;
- **per-diagnostic attribution rates** (when ``ICT_FORENSICS=1`` filled
  the per-iteration ``zaps_by_diagnostic`` records — :mod:`.forensics`):
  which of std / mean / ptp / fft is doing the zapping;
- the **termination-reason mix** (fixed_point / cycle / max_iter): a
  rising max_iter rate means masks stopped converging.

Everything lands in the :mod:`.tracing` registries (rendered on the
daemon's ``/metrics`` under ``ict_rfi_*`` / ``ict_jobs_terminated_total``)
and in the JSON :func:`quality_summary` dict the daemon attaches to job
manifests and :class:`..core.cleaner.CleanResult` exposes.  Strictly
read-only on the math: summaries are computed from finished masks and
never feed back.
"""

from __future__ import annotations

import numpy as np

from iterative_cleaner_tpu_torch.obs import tracing

#: Fixed occupancy/zap-fraction bucket upper bounds (fractions, cumulative
#: ``le`` semantics; the implicit last bucket is 1.0 = fully zapped).
#: Fixed, not adaptive, for the same reason as tracing.HIST_BOUNDS: every
#: job shares one layout, so cross-job aggregation is addition.
FRACTION_BOUNDS: tuple[float, ...] = (
    0.0, 0.01, 0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0)


def fraction_hist(fractions: np.ndarray) -> list[int]:
    """Cumulative counts of ``fractions`` (values in [0, 1]) at each
    :data:`FRACTION_BOUNDS` bound — ``hist[-1] == len(fractions)`` by
    construction (every fraction is <= 1.0)."""
    f = np.asarray(fractions, dtype=np.float64).ravel()
    return [int(np.sum(f <= bound)) for bound in FRACTION_BOUNDS]


def quality_summary(weights, termination: str = "") -> dict:
    """One mask's data-quality facts as a JSON-ready dict.

    ``weights`` is a final (nsub, nchan) weights array — zapped entries are
    exactly 0.0 on every route (the invariant rfi_frac already rests on).
    """
    w = np.asarray(weights)
    zap = w == 0
    nsub, nchan = zap.shape
    chan_occ = zap.mean(axis=0)     # per-channel zapped-subint fraction
    sub_occ = zap.mean(axis=1)      # per-subint zapped-channel fraction
    out = {
        "zap_frac": float(zap.mean()),
        "n_zapped": int(zap.sum()),
        "n_profiles": int(zap.size),
        "channels_fully_zapped": int(np.sum(chan_occ == 1.0)),
        "subints_fully_zapped": int(np.sum(sub_occ == 1.0)),
        "channel_occupancy_max": float(chan_occ.max()) if nchan else 0.0,
        "subint_occupancy_max": float(sub_occ.max()) if nsub else 0.0,
        # Cumulative counts at FRACTION_BOUNDS (see fraction_hist).
        "occupancy_bounds": list(FRACTION_BOUNDS),
        "channel_occupancy_hist": fraction_hist(chan_occ),
        "subint_occupancy_hist": fraction_hist(sub_occ),
    }
    if termination:
        out["termination"] = termination
    return out


def record_job_quality(summary: dict, timeline=None) -> None:
    """Account one finished job's :func:`quality_summary` into the metrics
    registries (the /metrics view an alert can watch).  ``timeline`` is the
    job's per-iteration forensics records, mined for per-diagnostic
    attribution when ``ICT_FORENSICS`` filled them.  Never raises —
    telemetry must not fail the job it describes."""
    try:
        frac = float(summary.get("zap_frac", 0.0))
        # Mean zap fraction across jobs = sum / count; the last-job gauge
        # is the "what did the most recent clean look like" spot check.
        tracing.count("rfi_zap_fraction_sum", frac)
        tracing.count("rfi_zap_fraction_count")
        tracing.set_gauge("rfi_last_job_zap_frac", frac)
        for bound in FRACTION_BOUNDS:
            if frac <= bound:
                tracing.count_labeled("rfi_job_zap_fraction_total",
                                      {"le": repr(float(bound))})
        # Occupancy histograms aggregate per CHANNEL / SUBINT, summed over
        # jobs (each job contributes its cumulative bucket counts).
        bounds = summary.get("occupancy_bounds", FRACTION_BOUNDS)
        for axis in ("channel", "subint"):
            hist = summary.get(f"{axis}_occupancy_hist")
            if not hist:
                continue
            for bound, n in zip(bounds, hist):
                if n:
                    tracing.count_labeled(
                        f"rfi_{axis}_occupancy_total",
                        {"le": repr(float(bound))}, n)
        reason = summary.get("termination")
        if reason:
            tracing.count_labeled("jobs_terminated_total", {"reason": reason})
        for rec in timeline or ():
            votes = (rec.get("zaps_by_diagnostic")
                     if isinstance(rec, dict) else None)
            for name, n in (votes or {}).items():
                if n:
                    tracing.count_labeled("rfi_zaps_attributed_total",
                                          {"diagnostic": str(name)}, n)
    except Exception:  # noqa: BLE001 — quality accounting is best-effort
        pass
