"""Flight recorder: an always-on bounded ring of recent events.

A copy of ``iterative_cleaner_tpu/obs/flight.py``; the port has no serving
daemon yet, so the dumps below are the JAX package's description of where
the ring is written there.

The telemetry event log (:mod:`.events`) answers "what happened" only when
an operator turned a sink on *before* the incident; the flight recorder
answers the post-mortem question — *what was the process doing just now* —
without any opt-in.  Every :func:`.events.emit` call (sink or no sink) and
every completed :func:`.tracing.observe_phase` lands here as one small
record in a fixed-size ring, so the cost is a dict build and a deque
append under a lock: bounded memory, no I/O, nothing on disk until a
:func:`dump` is asked for.

Dumps happen at exactly the moments guesswork used to start: the serving
daemon writes the ring on worker fault-ladder trips and on SIGTERM, and
serves it live at ``GET /debug/flight`` (docs/OBSERVABILITY.md).

Strictly read-only on the math — recording never touches a mask, and the
fuzz spot-check pins bit-identical masks with ``ICT_FLIGHT=1`` and a
profiler capture active.  ``ICT_FLIGHT=0`` disables recording entirely;
``ICT_FLIGHT_SIZE`` resizes the ring (default 512 events).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time

DEFAULT_CAPACITY = 512

#: On-disk dumps kept per directory (oldest swept): a daemon riding a
#: flapping backend must not fill its spool with one dump per trip.
MAX_DUMPS_KEPT = 20

_lock = threading.Lock()
_ring: collections.deque = collections.deque(maxlen=DEFAULT_CAPACITY)  # ict: guarded-by(_lock)


def enabled() -> bool:
    """Recording is ON unless explicitly disabled — the recorder exists for
    the incidents nobody predicted."""
    return os.environ.get("ICT_FLIGHT", "1") != "0"


def capacity() -> int:
    try:
        n = int(os.environ.get("ICT_FLIGHT_SIZE", DEFAULT_CAPACITY))
    except ValueError:
        return DEFAULT_CAPACITY
    return max(n, 1)


def note(event: str, **fields) -> None:
    """Append one record to the ring.  Never raises; values are kept as
    given and coerced to strings only at snapshot/dump time."""
    if not enabled():
        return
    rec = {"ts": round(time.time(), 6), "event": event}
    rec.update(fields)
    cap = capacity()
    with _lock:
        global _ring
        if _ring.maxlen != cap:
            _ring = collections.deque(_ring, maxlen=cap)
        _ring.append(rec)


def note_phase(name: str, seconds: float, error: bool = False) -> None:
    """The :func:`.tracing.observe_phase` hook — phase timings are the
    "what was it doing" half of a post-mortem (events are the "to whom")."""
    if not enabled():
        return
    rec = {"ts": round(time.time(), 6), "event": "phase", "phase": name,
           "duration_s": round(seconds, 6)}
    if error:
        rec["error"] = True
    cap = capacity()
    with _lock:
        global _ring
        if _ring.maxlen != cap:
            _ring = collections.deque(_ring, maxlen=cap)
        _ring.append(rec)


def snapshot() -> list[dict]:
    """Oldest-first copy of the ring (JSON-safe: values stringified the
    same way the event log's sink would)."""
    with _lock:
        recs = list(_ring)
    # Round-trip through json so a record carrying a non-serializable value
    # (an exception object, a numpy scalar) can never break /debug/flight.
    return json.loads(json.dumps(recs, default=str))


def reset() -> None:
    """Clear the ring (tests)."""
    with _lock:
        _ring.clear()


def dump(reason: str, directory: str) -> str | None:
    """Write the ring to ``<directory>/flight-<unixms>.json`` and sweep old
    dumps beyond :data:`MAX_DUMPS_KEPT`.  Returns the path, or None when
    recording is disabled or the write failed — a post-mortem aid must
    never become a second failure."""
    if not enabled():
        return None
    try:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory,
                            f"flight-{int(time.time() * 1000):013d}.json")
        payload = {
            "reason": reason,
            "ts": round(time.time(), 6),
            "pid": os.getpid(),
            "events": snapshot(),
        }
        tmp = f"{path}.part"
        with open(tmp, "w") as fh:
            json.dump(payload, fh, indent=1)
            fh.write("\n")
        os.replace(tmp, path)
        dumps = sorted(n for n in os.listdir(directory)
                       if n.startswith("flight-") and n.endswith(".json"))
        for name in dumps[:-MAX_DUMPS_KEPT]:
            try:
                os.remove(os.path.join(directory, name))
            except OSError:
                pass
        return path
    except Exception:  # noqa: BLE001 — best-effort by contract
        return None
