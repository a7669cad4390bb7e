"""``ict-clean-torch campaign MANIFEST`` — the campaign follow client.

Port of ``iterative_cleaner_tpu/campaign/cli.py``.

Reads a manifest JSON file, POSTs it to a fleet router, then follows the
campaign's progress (one line whenever the archive-state counts move)
until it settles terminally.  Exit status is the campaign verdict: 0
only when the campaign finished ``done`` with zero failed archives —
scriptable exactly like a solo ``ict-clean`` batch.

The client is deliberately thin: all state lives on the router (spool-
persisted), so killing and rerunning the follow loop against the same
campaign id — or resubmitting the same manifest after a router restart —
never re-cleans anything (docs/SERVING.md "Campaigns").
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.error
import urllib.request


def _http(url: str, payload: dict | None = None,
          timeout_s: float = 10.0) -> tuple[int, dict]:
    """One JSON round-trip; (status, body-dict).  HTTP error statuses
    come back as values (their JSON bodies carry the router's message),
    transport failures raise OSError for the caller to report."""
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(
        url, data=data,
        headers={"Content-Type": "application/json"} if data else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return resp.status, json.loads(resp.read().decode() or "{}")
    except urllib.error.HTTPError as exc:
        try:
            body = json.loads(exc.read().decode() or "{}")
        except ValueError:
            body = {}
        return exc.code, body


def _progress_line(view: dict) -> str:
    a = view.get("archives", {})
    return (f"campaign {view.get('id', '?')} [{view.get('state', '?')}] "
            f"{a.get('done', 0)}/{a.get('total', 0)} done, "
            f"{a.get('placed', 0)} running, {a.get('pending', 0)} pending, "
            f"{a.get('error', 0)} failed")


def campaign_main(argv: list[str]) -> int:
    p = argparse.ArgumentParser(
        prog="ict-clean-torch campaign",
        description="submit a campaign manifest to a fleet router and "
                    "follow it to completion (docs/SERVING.md 'Campaigns')")
    p.add_argument("manifest", help="campaign manifest JSON file")
    p.add_argument("--router", default="http://127.0.0.1:8790",
                   metavar="URL", help="fleet router base URL "
                   "(default http://127.0.0.1:8790)")
    p.add_argument("--poll_s", type=float, default=2.0, metavar="S",
                   help="seconds between progress polls (default 2)")
    p.add_argument("--timeout_s", type=float, default=0.0, metavar="S",
                   help="give up (exit 1, campaign keeps running server-"
                        "side) after this many seconds; 0 = follow forever")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="print the final GET /campaigns/<id> view (QA "
                        "roll-up + cost showback) as JSON on stdout")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="no progress lines, just the verdict")
    args = p.parse_args(argv)

    try:
        with open(args.manifest) as fh:
            manifest = json.load(fh)
    except (OSError, ValueError) as exc:
        print(f"error: unreadable manifest {args.manifest!r}: {exc}",
              file=sys.stderr)
        return 2

    base = args.router.rstrip("/")
    try:
        code, body = _http(f"{base}/campaigns", payload=manifest)
    except OSError as exc:
        print(f"error: router unreachable at {base}: {exc}",
              file=sys.stderr)
        return 1
    if code != 200:
        print(f"error: router rejected the manifest ({code}): "
              f"{body.get('error', body)}", file=sys.stderr)
        return 2
    cid = body.get("id", "")
    if not args.quiet:
        print(_progress_line(body), file=sys.stderr)

    deadline = time.monotonic() + args.timeout_s if args.timeout_s else None
    last = ""
    view = body
    while view.get("state") == "open":
        if deadline is not None and time.monotonic() >= deadline:
            print(f"error: campaign {cid} still open after "
                  f"{args.timeout_s:g}s (it keeps running; re-follow with "
                  f"GET {base}/campaigns/{cid})", file=sys.stderr)
            return 1
        time.sleep(args.poll_s)
        try:
            code, view = _http(f"{base}/campaigns/{cid}")
        except OSError as exc:
            # A router bounce mid-follow is survivable: the spool has the
            # campaign, so keep polling until the deadline says stop.
            if not args.quiet:
                print(f"campaign {cid}: router unreachable ({exc}); "
                      "retrying", file=sys.stderr)
            continue
        if code != 200:
            print(f"error: campaign {cid} lookup failed ({code})",
                  file=sys.stderr)
            return 1
        line = _progress_line(view)
        if not args.quiet and line != last:
            print(line, file=sys.stderr)
            last = line

    errors = view.get("archives", {}).get("error", 0)
    cost = view.get("cost", {}) or {}
    outliers = (view.get("rollup", {}) or {}).get("outliers", []) or []
    if not args.quiet:
        print(f"campaign {cid} finished {view.get('state')}: "
              f"{errors} failed, "
              f"{cost.get('device_s', 0.0):.3f} device-s "
              f"({cost.get('avoided_device_s', 0.0):.3f} avoided, "
              f"{cost.get('cache_hits', 0)} cache hits), "
              f"{len(outliers)} QA outlier(s)", file=sys.stderr)
        for rec in view.get("archive_records", []):
            if rec.get("state") == "error":
                print(f"  FAILED a{rec.get('index'):05d} "
                      f"{rec.get('path')}: {rec.get('error')}",
                      file=sys.stderr)
        for out in outliers:
            print(f"  OUTLIER a{out.get('index'):05d} {out.get('path')}: "
                  f"zap_frac={out.get('zap_frac')} "
                  f"({','.join(out.get('reasons', []))})", file=sys.stderr)
    if args.as_json:
        print(json.dumps(view, sort_keys=True))
    return 0 if view.get("state") == "done" and not errors else 1
