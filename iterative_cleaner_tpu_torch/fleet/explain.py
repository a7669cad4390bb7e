"""The per-job explain plane: one causal report from seven sources.

Port of ``iterative_cleaner_tpu/fleet/explain.py``.

The fleet already emits every piece of per-job evidence — the stitched
cross-hop trace (fleet/obs.py), the CostRecord with its roofline
attainment (obs/costs.py), per-diagnostic zap attribution
(obs/forensics.py timeline records), the shadow-audit verdict with its
repro bundle (obs/audit.py), the RFI quality summary (obs/quality.py),
the cache/coalesce disposition (fleet/cache.py + the coalescer's
batch_k), and the SLO journeys (fleet/slo.py) — but across six
endpoints with no causal view.  ``GET /fleet/explain/<job_id>`` (and
``ict-clean-torch explain`` on the CLI) stitches them into ONE JSON report,
answering "why was this job slow / why was this channel zapped / did
the cache serve it" without six manual scrapes.

Every plane is stamped with its provenance (the flight-cache
discipline, generalized):

- ``live`` — fetched from the serving replica (or computed from the
  router's own in-memory state) on this request;
- ``spool`` — served from what the router durably remembers: the
  fleet-cache result record, the placement table's terminal summary,
  or the pre-death flight-ring cache;
- ``unavailable`` — the evidence would live on a replica that is dead
  (or was never recorded); the report says so instead of guessing.

This module deliberately does NOT import the router (it would be a
cycle); it drives the router object through its public read surface.
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.error
import urllib.request

from iterative_cleaner_tpu_torch.fleet.client import ReplicaRefused, ReplicaUnreachable
from iterative_cleaner_tpu_torch.service.scheduler import bucket_label

#: The report's plane names, in causal order: what happened (trace),
#: what it cost, what the cleaner did (zaps/quality), was it right
#: (audit), was it reused (cache), and what it did to the objectives
#: (slo).  tests/test_recorder_explain.py pins this exact set.
PLANES = ("trace", "cost", "zaps", "audit", "quality", "cache", "slo")


def _plane(source: str, **body) -> dict:
    return {"source": source, **body}


def _fetch_timeline(router, p: dict) -> tuple[str, list]:
    """The per-iteration forensics timeline for the CURRENT hop —
    served only by the replica's ``GET /jobs/<id>/trace`` (manifests
    stay lean), so a dead replica means honestly unavailable."""
    if not p.get("base_url"):
        return "unavailable", []
    rep = router.registry.get(p["base_url"])
    if rep is None or not rep.alive:
        return "unavailable", []
    try:
        tr = router.client.job_trace(p["base_url"], p["replica_job_id"])
    except (ReplicaUnreachable, ReplicaRefused):
        return "unavailable", []
    timeline = tr.get("timeline") or []
    return "live", timeline if isinstance(timeline, list) else []


def _zap_attribution(timeline: list) -> dict:
    """Fold the per-iteration ``zaps_by_diagnostic`` votes into one
    per-diagnostic total (the quality summary's attribution source,
    summed across the whole convergence run)."""
    totals: dict[str, int] = {}
    for rec in timeline:
        votes = rec.get("zaps_by_diagnostic") if isinstance(rec, dict) \
            else None
        if not isinstance(votes, dict):
            continue
        for diag, n in votes.items():
            try:
                totals[str(diag)] = totals.get(str(diag), 0) + int(n)
            except (TypeError, ValueError):
                continue
    return totals


def explain_job(router, job_id: str) -> tuple[int, dict]:
    """Build the seven-plane report; (404, ...) for a job the placement
    table no longer remembers."""
    p = router.placement_snapshot(job_id)
    if p is None:
        return 404, {"error": f"no job {job_id!r} in the placement table"}
    code, manifest = router.job_manifest(job_id)
    if code != 200 or not isinstance(manifest, dict):
        manifest = {}
    # Manifest provenance: a fleet-cache placement serves its recorded
    # result summary (spool); a full manifest (it always carries "path")
    # came off the live replica; anything else is the placement table's
    # lean terminal/pending summary (spool).
    if p["cached"] is not None:
        manifest_src = "spool"
    elif "path" in manifest:
        manifest_src = "live"
    else:
        manifest_src = "spool"

    # 1. The cross-hop trace, with its per-hop sources folded into the
    # plane's own provenance: all-live hops read live, any hop recovered
    # from the pre-death flight cache demotes the plane to spool.
    t_code, trace = (router.fleet_trace(p["trace_id"])
                     if p["trace_id"] else (404, {}))
    if t_code != 200:
        trace_plane = _plane("unavailable")
    else:
        hop_sources = trace.get("sources", {})
        if any(s == "flight-cache" for s in hop_sources.values()):
            src = "spool"
        elif any(s == "unavailable" for s in hop_sources.values()):
            src = "spool"   # router spans still tell the story; the
            # missing hop is visible in hop_sources
        else:
            src = "live"
        trace_plane = _plane(src, trace_id=p["trace_id"],
                             state=trace.get("state"),
                             hops=trace.get("hops", []),
                             hop_sources=hop_sources,
                             spans=trace.get("spans", []))

    # 2. Cost + roofline: the manifest's CostRecord, joined with the
    # poll-tick cost fold's per-bucket attainment for context.
    cost = manifest.get("cost") or {}
    shape = manifest.get("shape") or list(p.get("shape") or [])
    bucket = ""
    if isinstance(shape, (list, tuple)) and len(shape) == 3:
        bucket = bucket_label(shape)
    bucket_attainment = None
    try:
        fold = router.fleet_costs()
        bucket_attainment = (fold.get("buckets", {})
                             .get(bucket, {}).get("attainment"))
    except Exception:  # noqa: BLE001 — context, never a report-killer
        pass
    if cost:
        cost_plane = _plane(
            manifest_src, record=cost,
            device_s=cost.get("device_s"),
            compile_s=cost.get("compile_s"),
            phases=cost.get("phases") or {},
            attainment=cost.get("attainment"),
            bucket=bucket, bucket_attainment=bucket_attainment)
    else:
        cost_plane = _plane("unavailable", bucket=bucket,
                            bucket_attainment=bucket_attainment)

    # 3. Per-diagnostic zap attribution: timeline-only evidence — live
    # replica or nothing (manifests exclude the timeline by design).
    tl_src, timeline = _fetch_timeline(router, p)
    if tl_src == "live":
        zaps_plane = _plane("live",
                            by_diagnostic=_zap_attribution(timeline),
                            iterations=len(timeline))
    else:
        zaps_plane = _plane("unavailable")

    # 4. The audit verdict (+ the repro-bundle pointer a divergence
    # writes — obs/audit.py stamps it on the record as "bundle").
    audit = manifest.get("audit_result") or {}
    if audit:
        audit_plane = _plane(
            manifest_src,
            mask_identical=audit.get("mask_identical"),
            n_mask_diffs=audit.get("n_mask_diffs"),
            repro_bundle=audit.get("bundle") or None,
            record=audit)
    else:
        audit_plane = _plane("unavailable",
                             note="no shadow audit ran for this job")

    # 5. The RFI quality summary.
    quality = manifest.get("quality") or {}
    quality_plane = (_plane(manifest_src, **quality) if quality
                     else _plane("unavailable"))

    # 6. Cache/coalesce disposition: who served it (fleet cache /
    # replica cache / a coalesced batch) and what that avoided.
    served_by = str(manifest.get("served_by", "") or "")
    if p["cached"] is not None:
        served_by = served_by or "fleet-cache"
    cache_plane = _plane(
        manifest_src if (manifest or p["cached"] is not None)
        else "unavailable",
        served_by=served_by,
        fleet_cache_hit=p["cached"] is not None,
        cache_hit=bool(cost.get("cache_hit")),
        avoided_device_s=cost.get("avoided_device_s"),
        coalesced_batch_k=cost.get("batch_k"),
        route=cost.get("route"))

    # 7. SLO journeys: classify which journeys this job's path walked
    # (a cache-served job is the cache journey; every real placement
    # walks admission) and report those journeys' SLI rows — computed
    # from the router's own in-memory plane, so always live.
    journeys = ["cache" if (p["cached"] is not None
                            or served_by == "fleet-cache") else "fresh"]
    if not p["synthetic"]:
        journeys.append("admission")
    latency_s = None
    try:
        fin = float(manifest.get("finished_s", 0.0) or 0.0)
        sub = float(manifest.get("submitted_s", 0.0)
                    or p.get("submitted_s", 0.0) or 0.0)
        if fin > 0 and sub > 0:
            latency_s = round(fin - sub, 6)
    except (TypeError, ValueError):
        pass
    slo_report = router.slo.report()
    slo_plane = _plane(
        "live", journeys=journeys, latency_s=latency_s,
        failing_journeys=[j for j in slo_report.get("failing_journeys", [])
                          if j in journeys],
        rows={j: slo_report.get("journeys", {}).get(j) for j in journeys})

    report = {
        "job_id": p["job_id"],
        "state": manifest.get("state", p["state"]),
        "tenant": p["tenant"],
        "trace_id": p["trace_id"],
        "replica_id": p["replica_id"],
        "attempts": p["attempts"],
        "synthetic": p["synthetic"],
        "planes": {
            "trace": trace_plane,
            "cost": cost_plane,
            "zaps": zaps_plane,
            "audit": audit_plane,
            "quality": quality_plane,
            "cache": cache_plane,
            "slo": slo_plane,
        },
    }
    return 200, report


# --- the ``ict-clean-torch explain`` CLI (and fleet_top's one-shot reuse) ---

def fetch_explain(router_url: str, job_id: str,
                  timeout_s: float = 10.0) -> tuple[int, dict]:
    """GET /fleet/explain/<job_id> from a live router; (0, {...}) on a
    transport failure (the CLI and fleet_top share this)."""
    url = f"{router_url.rstrip('/')}/fleet/explain/{job_id}"
    try:
        with urllib.request.urlopen(url, timeout=timeout_s) as resp:
            return resp.status, json.load(resp)
    except urllib.error.HTTPError as exc:
        try:
            body = json.load(exc)
        except ValueError:
            body = {"error": str(exc)}
        return exc.code, body
    except (urllib.error.URLError, OSError, ValueError) as exc:
        return 0, {"error": f"router unreachable: {exc}"}


def render_explain(report: dict) -> str:
    """The human rendering: one header line plus one line per plane,
    provenance first — scannable in a terminal, no JSON spelunking."""
    lines = [
        f"job {report.get('job_id')}  state={report.get('state')}  "
        f"tenant={report.get('tenant')}  replica={report.get('replica_id')}  "
        f"attempts={report.get('attempts')}"]
    planes = report.get("planes", {})
    for name in PLANES:
        plane = planes.get(name) or {}
        src = plane.get("source", "unavailable")
        detail = ""
        if name == "trace":
            detail = (f"{len(plane.get('spans') or [])} spans, "
                      f"{len(plane.get('hops') or [])} hop(s)")
        elif name == "cost" and src != "unavailable":
            detail = (f"device_s={plane.get('device_s')} "
                      f"compile_s={plane.get('compile_s')} "
                      f"attainment={plane.get('attainment')}")
        elif name == "zaps" and src != "unavailable":
            by = plane.get("by_diagnostic") or {}
            detail = " ".join(f"{k}={v}" for k, v in sorted(by.items())) \
                or "no zaps attributed"
        elif name == "audit" and src != "unavailable":
            detail = (f"mask_identical={plane.get('mask_identical')}"
                      + (f" repro={plane['repro_bundle']}"
                         if plane.get("repro_bundle") else ""))
        elif name == "quality" and src != "unavailable":
            detail = f"zap_frac={plane.get('zap_frac')}"
        elif name == "cache":
            detail = (f"served_by={plane.get('served_by') or 'replica'} "
                      f"fleet_cache_hit={plane.get('fleet_cache_hit')} "
                      f"batch_k={plane.get('coalesced_batch_k')}")
        elif name == "slo":
            detail = (f"journeys={','.join(plane.get('journeys') or [])} "
                      f"latency_s={plane.get('latency_s')} "
                      f"failing={plane.get('failing_journeys')}")
        lines.append(f"  {name:<8} [{src:^11}] {detail}".rstrip())
    return "\n".join(lines)


def explain_main(argv: list | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="ict-clean-torch explain",
        description="Fetch one job's seven-plane causal report from a "
                    "fleet router (GET /fleet/explain/<job_id>): trace, "
                    "cost/roofline, zap attribution, audit verdict, "
                    "quality, cache/coalesce disposition, SLO journeys "
                    "— each stamped live/spool/unavailable.")
    p.add_argument("job_id", help="the fleet job id (the id the 202 "
                                  "carried)")
    p.add_argument("--router", default="http://127.0.0.1:8790",
                   metavar="URL", help="fleet router base URL "
                                       "(default http://127.0.0.1:8790)")
    p.add_argument("--timeout_s", type=float, default=10.0)
    p.add_argument("--json", action="store_true",
                   help="emit the raw report JSON instead of the "
                        "human rendering")
    args = p.parse_args(argv)
    code, report = fetch_explain(args.router, args.job_id,
                                 timeout_s=args.timeout_s)
    if code != 200:
        print(json.dumps(report) if args.json
              else f"error: {report.get('error', f'HTTP {code}')}",
              file=sys.stderr)
        return 1
    print(json.dumps(report) if args.json else render_explain(report))
    return 0
