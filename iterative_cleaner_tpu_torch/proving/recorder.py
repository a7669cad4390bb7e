"""Production flight recorder: every *real* submission, always on tape.

Port of ``iterative_cleaner_tpu/proving/recorder.py``.

The proving ground can already replay a trace (proving/traces.py), but
until this module the only traces were the soak's own, and
"replaying *production* traces" was open.  The recorder closes it from
the router side: every submission the router places (fresh placements
AND born-terminal fleet-cache hits) is appended, as it happens, to a
bounded, rotated set of **segments** in the exact versioned trace
grammar, so any production window is a replayable artifact the moment
its segment seals — ``ict-clean-torch prove --replay <segment>`` re-issues it
under the original idempotency keys and must dedupe one-for-one with
zero new replica work.

Discipline (mirrors obs/events.py rotation + fleet/obs.py bundles):

- **synthetic traffic is excluded by construction** — canary probes and
  soak-synthetic submissions arrive with ``synthetic: true`` / the
  ``_canary`` tenant (place_job normalizes both into each other), and
  :meth:`FlightRecorder.record` refuses them before any byte is written
  (counted on ``ict_recorder_excluded_total``).  A sealed segment can
  never contain a probe.
- **durable open segment** — entries append to ``open.trace.part`` (one
  JSON line each, absolute timestamps) so a crash loses at most the
  torn last line; a restarted recorder re-adopts the part file and the
  window survives the process.
- **size-capped rotation, atomic sealing** — when the open segment
  crosses ``max_segment_kb`` it seals: the final grammar file (header
  line + time-relative entries, loadable by ``traces.load_trace``
  unchanged) is written to a ``.part`` sibling and ``os.replace``d into
  ``seg-NNNNNN.trace.jsonl``; readers never see a half segment.
- **bounded keep** — beyond ``keep`` sealed segments the oldest are
  swept (the incident-bundle MAX_INCIDENTS_KEPT idiom): the recorder is
  a flight recorder, not an archive.
- **never in the serving path's way** — a failed append is counted
  (``ict_recorder_dropped_total``) and swallowed; recording must never
  turn a placement into a 500.

The recorder owns ONE lock, acquired strictly after the router's (the
router -> subsystem order); it performs only local file appends under
it, never HTTP.
"""

from __future__ import annotations

import json
import os
import threading
import time

from iterative_cleaner_tpu_torch.proving import traces

#: Open-segment journal (absolute-timestamp JSON lines) and the sealed
#: segment name grammar.  The ``.part`` suffix keeps the open journal
#: (and the seal-in-progress temp file) invisible to the inventory.
OPEN_PART = "open.trace.part"
SEGMENT_FMT = "seg-{seq:06d}.trace.jsonl"
SEGMENT_PREFIX = "seg-"
SEGMENT_SUFFIX = ".trace.jsonl"


def _is_segment(name: str) -> bool:
    return (name.startswith(SEGMENT_PREFIX)
            and name.endswith(SEGMENT_SUFFIX))


class FlightRecorder:
    """Router-side production submission recorder (one per router)."""

    def __init__(self, out_dir: str, max_segment_kb: int = 256,
                 keep: int = 16, enabled: bool = True,
                 quiet: bool = True) -> None:
        self.out_dir = out_dir
        self.max_segment_bytes = max(int(max_segment_kb), 1) * 1024
        self.keep = max(int(keep), 1)
        self.enabled = bool(enabled)
        self.quiet = quiet
        self._lock = threading.Lock()
        # The open segment's entries, in arrival order: dicts carrying
        # the absolute ``ts`` plus every TraceEntry field — relativized
        # against the segment's t0 only at seal time.
        self._open: list[dict] = []  # ict: guarded-by(self._lock)
        self._open_bytes = 0  # ict: guarded-by(self._lock)
        self._seq = 0  # next sealed-segment sequence number  # ict: guarded-by(self._lock)
        self._entries_total = 0  # ict: guarded-by(self._lock)
        self._excluded_total = 0  # ict: guarded-by(self._lock)
        self._dropped_total = 0  # ict: guarded-by(self._lock)
        self._sealed_total = 0  # ict: guarded-by(self._lock)
        if self.enabled:
            os.makedirs(self.out_dir, exist_ok=True)
            self._adopt_existing()

    # --- init recovery ------------------------------------------------

    def _adopt_existing(self) -> None:
        """Resume a predecessor's state: continue the sealed sequence
        past the highest existing segment and re-adopt its open-segment
        journal (the crash-durability half of the ``.part`` append).
        The directory scan and journal read run unlocked (init-only, no
        concurrency yet); the state commit takes the lock."""
        try:
            names = sorted(n for n in os.listdir(self.out_dir)
                           if _is_segment(n))
        except OSError:
            names = []
        next_seq = 0
        for name in names:
            try:
                next_seq = max(
                    next_seq,
                    int(name[len(SEGMENT_PREFIX):-len(SEGMENT_SUFFIX)]) + 1)
            except ValueError:
                continue
        part = os.path.join(self.out_dir, OPEN_PART)
        adopted: list[dict] = []
        part_bytes = 0
        try:
            if os.path.exists(part):
                with open(part) as fh:
                    for line in fh:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            rec = json.loads(line)
                        except ValueError:
                            continue  # the torn last line of a crash
                        if isinstance(rec, dict) and rec.get("path"):
                            adopted.append(rec)
                part_bytes = os.path.getsize(part)
        except OSError:
            adopted = []
            part_bytes = 0
        with self._lock:
            self._seq = max(self._seq, next_seq)
            self._open.extend(adopted)
            self._open_bytes = part_bytes

    # --- the hot path -------------------------------------------------

    def record(self, *, path: str, tenant: str = "", idem_key: str = "",
               shape=(), bucket: str = "", salt: str = "",
               trace_id: str = "", entry: str = "service",
               synthetic: bool = False, ts: float | None = None) -> bool:
        """Append one real submission to the open segment.  Returns True
        when the entry landed on tape; synthetic traffic is refused here
        (excluded by construction — not filtered at seal time), and any
        failure is counted and swallowed, never raised into the
        placement path."""
        if synthetic or tenant == "_canary":
            with self._lock:
                self._excluded_total += 1
            return False
        if not self.enabled:
            with self._lock:
                self._dropped_total += 1
            return False
        rec = {
            "ts": round(float(time.time() if ts is None else ts), 6),
            "path": str(path), "tenant": str(tenant or ""),
            "idem_key": str(idem_key or ""),
            "shape": [int(v) for v in (shape or ())],
            "bucket": str(bucket or ""), "salt": str(salt or ""),
            "trace_id": str(trace_id or ""),
            "entry": entry if entry in ("service", "cli", "cache")
            else "service",
        }
        line = json.dumps(rec) + "\n"
        with self._lock:
            try:
                with open(os.path.join(self.out_dir, OPEN_PART), "a") as fh:
                    fh.write(line)
            except OSError:
                self._dropped_total += 1
                return False
            self._open.append(rec)
            self._open_bytes += len(line)
            self._entries_total += 1
            roll = self._open_bytes >= self.max_segment_bytes
        if roll:
            self.seal()
        return True

    # --- rotation -----------------------------------------------------

    def seal(self) -> str | None:
        """Seal the open segment into the next ``seg-NNNNNN`` grammar
        file (atomic ``.part`` -> ``os.replace``); returns its path, or
        None when there was nothing to seal.  Public so the smoke (and
        an operator export) can close a window on demand."""
        with self._lock:
            if not self.enabled or not self._open:
                return None
            pending = self._open
            self._open = []
            self._open_bytes = 0
            seq = self._seq
            self._seq += 1
        t0 = float(pending[0]["ts"])
        final = os.path.join(self.out_dir, SEGMENT_FMT.format(seq=seq))
        tmp = final + ".part"
        try:
            with open(tmp, "w") as fh:
                fh.write(json.dumps({
                    "kind": traces.TRACE_KIND,
                    "version": traces.TRACE_VERSION,
                    "t0": round(t0, 6), "source": "fleet-recorder",
                    "entries": len(pending)}) + "\n")
                last_t = 0.0
                for rec in pending:
                    e = traces.TraceEntry(
                        # Clamp monotone: wall clocks can step backward
                        # and load_trace requires ordered t.
                        t=max(float(rec["ts"]) - t0, last_t),
                        path=rec["path"], tenant=rec.get("tenant", ""),
                        idem_key=rec.get("idem_key", ""),
                        shape=tuple(rec.get("shape") or ()),
                        bucket=rec.get("bucket", ""),
                        salt=rec.get("salt", ""),
                        trace_id=rec.get("trace_id", ""),
                        entry=rec.get("entry", "service"))
                    last_t = e.t
                    fh.write(json.dumps(e.to_json()) + "\n")
            os.replace(tmp, final)
            try:
                os.remove(os.path.join(self.out_dir, OPEN_PART))
            except OSError:
                pass
        except OSError:
            # The window stays on the open journal; next seal retries.
            with self._lock:
                self._dropped_total += len(pending)
            return None
        with self._lock:
            self._sealed_total += 1
        self._sweep()
        return final

    def _sweep(self) -> None:
        """Drop the oldest sealed segments beyond ``keep`` (sequence
        numbers ARE age: the name sort is the time sort)."""
        try:
            names = sorted(n for n in os.listdir(self.out_dir)
                           if _is_segment(n))
        except OSError:
            return
        for name in names[:-self.keep] if len(names) > self.keep else []:
            try:
                os.remove(os.path.join(self.out_dir, name))
            except OSError:
                pass

    # --- read side ----------------------------------------------------

    def segments(self) -> list[dict]:
        """Inventory of sealed segments, oldest first: name/path/bytes
        plus the header's t0 and entry count (each file is read for its
        header line only)."""
        if not self.enabled and not os.path.isdir(self.out_dir):
            return []
        try:
            names = sorted(n for n in os.listdir(self.out_dir)
                           if _is_segment(n))
        except OSError:
            return []
        rows = []
        for name in names:
            path = os.path.join(self.out_dir, name)
            row = {"name": name, "path": path, "bytes": 0,
                   "t0": 0.0, "entries": 0}
            try:
                row["bytes"] = os.path.getsize(path)
                with open(path) as fh:
                    header = json.loads(fh.readline())
                row["t0"] = float(header.get("t0", 0.0))
                row["entries"] = int(header.get("entries", 0))
            except (OSError, ValueError, TypeError):
                continue  # a segment mid-replace; the next scrape sees it
            rows.append(row)
        return rows

    def export(self, segment: str = "", t_start: float | None = None,
               t_end: float | None = None) -> list[dict]:
        """A replayable trace document as a list of JSON-line objects
        (header first) — written one ``json.dumps`` per element, the
        result IS a valid trace file for ``traces.load_trace``.

        ``segment`` names one sealed segment verbatim; otherwise every
        sealed entry whose ABSOLUTE arrival time falls in
        ``[t_start, t_end]`` (open bounds when None) is merged, in
        order, under a fresh header.  Raises KeyError for an unknown
        segment name."""
        if segment:
            if not _is_segment(segment) or os.sep in segment:
                raise KeyError(segment)
            path = os.path.join(self.out_dir, segment)
            if not os.path.exists(path):
                raise KeyError(segment)
            with open(path) as fh:
                return [json.loads(ln) for ln in fh if ln.strip()]
        picked: list[tuple[float, dict]] = []
        for row in self.segments():
            try:
                entries = traces.load_trace(row["path"])
            except (OSError, ValueError):
                continue
            for e in entries:
                abs_t = row["t0"] + e.t
                if t_start is not None and abs_t < t_start:
                    continue
                if t_end is not None and abs_t > t_end:
                    continue
                picked.append((abs_t, e.to_json()))
        picked.sort(key=lambda p: p[0])
        t0 = picked[0][0] if picked else 0.0
        out = [{"kind": traces.TRACE_KIND,
                "version": traces.TRACE_VERSION, "t0": round(t0, 6),
                "source": "fleet-recorder-window",
                "entries": len(picked)}]
        last_t = 0.0
        for abs_t, rec in picked:
            rec = dict(rec)
            rec["t"] = round(max(abs_t - t0, last_t), 6)
            last_t = rec["t"]
            out.append(rec)
        return out

    def stats(self) -> dict:
        """One snapshot for gauges, /fleet/traces, and fleet_top."""
        rows = self.segments()
        with self._lock:
            return {
                "enabled": self.enabled,
                "segments": len(rows),
                "segment_bytes": sum(r["bytes"] for r in rows),
                "open_entries": len(self._open),
                "open_bytes": self._open_bytes,
                "entries_total": self._entries_total,
                "excluded_total": self._excluded_total,
                "dropped_total": self._dropped_total,
                "sealed_total": self._sealed_total,
            }
