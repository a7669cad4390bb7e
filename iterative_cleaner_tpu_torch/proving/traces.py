"""Submission-trace record/replay (the proving ground's traffic lane).

Port of ``iterative_cleaner_tpu/proving/traces.py``.

A *trace* is the replayable distillation of one production window: every
submission that entered the fleet — through a replica's ``POST /jobs``,
through the router (placements AND born-terminal cache hits), or through
the batch CLI — reduced to the fields a re-issue needs.  The recorder
derives it from the JSON-lines event log (``--telemetry`` /
``ICT_TELEMETRY``): since the replay-completeness fix that landed with
this module, every ``job_submitted`` / ``fleet_cache_hit`` event carries
the arrival timestamp, tenant, idempotency key, declared shape + bucket,
and the serving replica's config salt, at all three entry points.

Trace file grammar (JSON lines, one object per line):

- line 1, the header::

    {"kind": "ict-trace", "version": 1, "t0": <abs ts of first entry>,
     "source": "<event log path>", "entries": N}

- lines 2..N+1, one entry each, ordered by arrival time::

    {"t": <seconds since t0>, "path": "...", "tenant": "...",
     "idem_key": "...", "shape": [nsub, nchan, nbin] | [],
     "bucket": "...", "salt": "...", "trace_id": "...",
     "entry": "service" | "cli" | "cache"}

The replayer re-issues the trace against a live router at 1×/N× time
compression **under the original idempotency keys**, so replaying a
window the fleet already served must dedupe end to end (the
``fleet_deduped_submissions_total`` counter moves; ``service_jobs_done``
does not) — the record→replay round-trip regression tests/test_proving.py
pins.  Entries recorded without a key (CLI runs) get a deterministic
``replay:``-prefixed key derived from the trace position, so repeated
replays of one trace file still dedupe against each other.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from dataclasses import asdict, dataclass

TRACE_KIND = "ict-trace"
TRACE_VERSION = 1

#: Events a submission trace is derived from.  ``job_submitted`` is the
#: replica-side acceptance record (CLI runs emit it too, entry="cli");
#: ``fleet_cache_hit`` is the ONLY record of a born-terminal cache-served
#: submission, which never reaches a replica's job_submitted.
_SOURCE_EVENTS = ("job_submitted", "fleet_cache_hit")


@dataclass(frozen=True)
class TraceEntry:
    """One recorded submission, relative to the trace's t0."""

    t: float
    path: str
    tenant: str = ""
    idem_key: str = ""
    shape: tuple = ()
    bucket: str = ""
    salt: str = ""
    trace_id: str = ""
    entry: str = "service"

    def to_json(self) -> dict:
        d = asdict(self)
        d["t"] = round(float(self.t), 6)
        d["shape"] = [int(v) for v in self.shape]
        return d


def _entry_from_event(rec: dict, t0: float) -> TraceEntry | None:
    path = str(rec.get("path", "") or "")
    if not path:
        return None
    shape = rec.get("shape") or []
    if not (isinstance(shape, list)
            and all(isinstance(v, int) for v in shape)):
        shape = []
    return TraceEntry(
        t=max(float(rec.get("ts", t0)) - t0, 0.0),
        path=path,
        tenant=str(rec.get("tenant", "") or ""),
        idem_key=str(rec.get("idem_key", "") or ""),
        shape=tuple(shape),
        bucket=str(rec.get("bucket", "") or ""),
        salt=str(rec.get("cache_salt", "") or ""),
        trace_id=str(rec.get("trace_id", "") or ""),
        entry=("cache" if rec.get("event") == "fleet_cache_hit"
               else str(rec.get("entry", "service") or "service")),
    )


def _event_lines(event_log: str):
    """Yield parsed event dicts from the log, rotated generation first
    (``<path>.1`` precedes ``<path>`` in time — obs/events.py rotation).
    Malformed lines are skipped: the log is append-only JSON lines, and a
    line torn by a crash must not lose the window around it."""
    import os

    for p in (event_log + ".1", event_log):
        if not os.path.exists(p):
            continue
        with open(p) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict):
                    yield rec


def record_trace(event_log: str, out_path: str) -> int:
    """Derive a replayable trace from an event log; returns how many
    entries were written.  Submissions are deduplicated by idempotency
    key (a failover re-submits the SAME job to a second replica, which
    emits a second ``job_submitted`` under the same key — one arrival,
    one trace entry) and ordered by arrival timestamp."""
    picked: dict[str, dict] = {}
    anon: list[dict] = []
    for rec in _event_lines(event_log):
        if rec.get("event") not in _SOURCE_EVENTS:
            continue
        if not rec.get("path"):
            continue
        key = str(rec.get("idem_key", "") or "") or str(
            rec.get("job_id", "") or "")
        if key:
            picked.setdefault(key, rec)
        else:
            anon.append(rec)   # CLI runs: no key, every arrival distinct
    events = sorted([*picked.values(), *anon],
                    key=lambda r: float(r.get("ts", 0.0)))
    if not events:
        with open(out_path, "w") as fh:
            fh.write(json.dumps({"kind": TRACE_KIND,
                                 "version": TRACE_VERSION, "t0": 0.0,
                                 "source": event_log, "entries": 0}) + "\n")
        return 0
    t0 = float(events[0].get("ts", 0.0))
    entries = [e for e in (_entry_from_event(rec, t0) for rec in events)
               if e is not None]
    with open(out_path, "w") as fh:
        fh.write(json.dumps({"kind": TRACE_KIND, "version": TRACE_VERSION,
                             "t0": round(t0, 6), "source": event_log,
                             "entries": len(entries)}) + "\n")
        for e in entries:
            fh.write(json.dumps(e.to_json()) + "\n")
    return len(entries)


def load_trace(path: str) -> list[TraceEntry]:
    """Parse + validate a trace file; raises ValueError on anything
    outside the grammar (the trace is an operator-supplied artifact — a
    stale or hand-edited file must fail loudly, not replay garbage)."""
    with open(path) as fh:
        lines = [ln for ln in (raw.strip() for raw in fh) if ln]
    if not lines:
        raise ValueError(f"trace {path!r} is empty (want a header line)")
    try:
        header = json.loads(lines[0])
    except ValueError as exc:
        raise ValueError(f"trace {path!r} header is not JSON: {exc}") from None
    if not isinstance(header, dict) or header.get("kind") != TRACE_KIND:
        raise ValueError(f"trace {path!r} header lacks kind={TRACE_KIND!r}")
    if header.get("version") != TRACE_VERSION:
        raise ValueError(f"trace {path!r} is version "
                         f"{header.get('version')!r}; this reader speaks "
                         f"{TRACE_VERSION}")
    declared = header.get("entries")
    entries: list[TraceEntry] = []
    last_t = 0.0
    for i, line in enumerate(lines[1:], start=2):
        try:
            rec = json.loads(line)
        except ValueError as exc:
            raise ValueError(f"trace {path!r} line {i}: not JSON "
                             f"({exc})") from None
        if not isinstance(rec, dict):
            raise ValueError(f"trace {path!r} line {i}: want an object")
        if not isinstance(rec.get("path"), str) or not rec["path"]:
            raise ValueError(f"trace {path!r} line {i}: missing 'path'")
        t = rec.get("t")
        if not isinstance(t, (int, float)) or t < 0:
            raise ValueError(f"trace {path!r} line {i}: bad 't' {t!r}")
        if float(t) < last_t:
            raise ValueError(f"trace {path!r} line {i}: out of order "
                             f"(t={t} after t={last_t})")
        last_t = float(t)
        shape = rec.get("shape", [])
        if not (isinstance(shape, list)
                and all(isinstance(v, int) and v > 0 for v in shape)):
            raise ValueError(f"trace {path!r} line {i}: bad 'shape' "
                             f"{shape!r}")
        entry = rec.get("entry", "service")
        if entry not in ("service", "cli", "cache"):
            raise ValueError(f"trace {path!r} line {i}: bad 'entry' "
                             f"{entry!r}")
        entries.append(TraceEntry(
            t=float(t), path=rec["path"],
            tenant=str(rec.get("tenant", "") or ""),
            idem_key=str(rec.get("idem_key", "") or ""),
            shape=tuple(shape),
            bucket=str(rec.get("bucket", "") or ""),
            salt=str(rec.get("salt", "") or ""),
            trace_id=str(rec.get("trace_id", "") or ""),
            entry=entry))
    if isinstance(declared, int) and declared != len(entries):
        raise ValueError(f"trace {path!r}: header declares {declared} "
                         f"entries, file has {len(entries)}")
    return entries


def replay_key(e: TraceEntry, index: int) -> str:
    """The idempotency key a replay submits under: the ORIGINAL key when
    one was recorded (the whole point — replaying a served window must
    dedupe), else a deterministic per-position key so repeated replays of
    one trace still dedupe against each other."""
    return e.idem_key or f"replay:{e.trace_id or 'anon'}:{index}"


def replay_trace(entries: list[TraceEntry], base_url: str,
                 compression: float = 1.0, timeout_s: float = 30.0) -> dict:
    """Re-issue a trace against a live router at ``compression``× speed
    (10.0 = ten times faster than recorded).  Returns a report dict:
    submissions attempted/succeeded, per-entry job ids, and collected
    errors (a replay is a measurement run — one refused submission is a
    data point, not an abort)."""
    base = base_url.rstrip("/")
    speed = max(float(compression), 1e-9)
    t_start = time.monotonic()
    job_ids: list[str] = []
    errors: list[str] = []
    submitted = 0
    for i, e in enumerate(entries):
        delay = e.t / speed - (time.monotonic() - t_start)
        if delay > 0:
            time.sleep(delay)
        body = {"path": e.path, "idempotency_key": replay_key(e, i)}
        if len(e.shape) == 3:
            body["shape"] = [int(v) for v in e.shape]
        headers = {"Content-Type": "application/json"}
        if e.tenant:
            headers["X-ICT-Tenant"] = e.tenant
        req = urllib.request.Request(f"{base}/jobs",
                                     data=json.dumps(body).encode(),
                                     headers=headers)
        try:
            row = json.load(urllib.request.urlopen(req, timeout=timeout_s))
            submitted += 1
            jid = str(row.get("id", "") or "")
            if jid:
                job_ids.append(jid)
        except (urllib.error.URLError, OSError, ValueError) as exc:
            errors.append(f"entry {i} ({e.path}): {exc}")
    return {"entries": len(entries), "submitted": submitted,
            "job_ids": job_ids, "errors": errors,
            "compression": speed,
            "wall_s": round(time.monotonic() - t_start, 3)}
