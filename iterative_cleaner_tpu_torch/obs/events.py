"""Trace context + the JSON-lines telemetry event log.

A copy of ``iterative_cleaner_tpu/obs/events.py``.  In the port the entry
points that mint a trace id are the CLI run and the online session; the
serving daemon is a later slice.

A ``trace_id`` is minted at every entry point (CLI run, POST /jobs, online
session) and threaded through every layer a request crosses — scheduler
admission, worker dispatch, chunked/sharded execution, online block ingest
— so an operator can reconstruct any job's full path from one grep of the
event log.  Propagation is explicit where work crosses threads (the id
rides on the Job / session manifest) and implicit within a thread (a
contextvar, set by :func:`trace_scope` / :func:`span`, that nested
:func:`emit` calls inherit).

The sink is a JSON-lines file: ``--telemetry out.jsonl`` on the CLI and
the serving daemon, or the ``ICT_TELEMETRY`` environment variable.  One
event per line: ``{"ts": ..., "event": ..., "trace_id": ...,
"span_id": ..., ...fields}``.  When no sink is configured every hook here
is a cheap no-op — the hot path pays a single ``if``.

Ids are random hex (16 chars trace / 8 chars span), not time-derived:
they only need to be grep-unique within one log, and minting must stay
nanosecond-cheap on the disabled path too (POST /jobs echoes the id even
with the log off).
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import sys
import threading
import time
import uuid
from dataclasses import dataclass

from iterative_cleaner_tpu_torch.obs import flight


@dataclass(frozen=True)
class TraceContext:
    trace_id: str
    span_id: str = ""


_current: contextvars.ContextVar[TraceContext | None] = contextvars.ContextVar(
    "ict_trace_ctx", default=None)

_UNSET = object()
_explicit = _UNSET          # configure() override; _UNSET -> read the env  # ict: guarded-by(_lock)
_lock = threading.Lock()
_fh = None                  # cached append handle for the active path  # ict: guarded-by(_lock)
_fh_path: str | None = None  # ict: guarded-by(_lock)
_warned = False  # ict: guarded-by(_lock)
_retry_at = 0.0             # sink-failure backoff deadline (monotonic)  # ict: guarded-by(_lock)
_fh_size = 0                # bytes in the active sink file (tracked, not stat-ed per emit)  # ict: guarded-by(_lock)
_rotations = 0              # size-cap rotations this process has performed  # ict: guarded-by(_lock)

#: After a failed sink write, drop events for this long, then try again —
#: transient disk trouble (brief ENOSPC, a remounted log volume) must not
#: silence a weeks-lived daemon's event log forever.
SINK_RETRY_S = 60.0

#: Default size cap (MB) on the sink file before it rotates to
#: ``<path>.1`` (one rotated generation, so the disk footprint is bounded
#: at ~2x the cap); ``ICT_EVENT_LOG_MAX_MB`` overrides, 0 disables
#: rotation entirely.  Rotation is a close + rename + reopen inside the
#: emit path's existing OSError envelope — it can never block or raise.
EVENT_LOG_MAX_MB = 256


def _max_bytes() -> int:
    try:
        mb = float(os.environ.get("ICT_EVENT_LOG_MAX_MB", EVENT_LOG_MAX_MB))
    except ValueError:
        mb = EVENT_LOG_MAX_MB
    return int(mb * (1 << 20)) if mb > 0 else 0


def rotations() -> int:
    """Size-cap rotations performed by this process (tests, /healthz)."""
    with _lock:
        return _rotations


def sink_degraded() -> bool:
    """True while the sink sits in its post-failure drop window (a write
    failed — full disk, yanked directory — and events are being dropped
    until the ``SINK_RETRY_S`` backoff expires).  The proving ground's
    full-disk chaos drill exports this as the ``ict_prove_event_sink_``
    ``degraded`` gauge so the fault is alertable instead of a lone stderr
    warning; :func:`configure` (pointing at a healthy path) clears it
    immediately."""
    with _lock:
        return bool(_retry_at) and time.monotonic() < _retry_at


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def new_span_id() -> str:
    return uuid.uuid4().hex[:8]


def configure(path: str | None) -> None:
    """Point the event log at ``path`` (None/'' disables and, for tests,
    returns to honoring ``ICT_TELEMETRY``).  The file is opened lazily in
    append mode on first emit."""
    global _explicit, _fh, _fh_path, _retry_at
    with _lock:
        _explicit = path if path else _UNSET
        _retry_at = 0.0
        if _fh is not None and _fh_path != _sink_path_locked():
            try:
                _fh.close()
            except OSError:
                pass
            _fh = None
            _fh_path = None


def _sink_path_locked() -> str | None:
    if _explicit is _UNSET:
        return os.environ.get("ICT_TELEMETRY") or None
    return _explicit


def configured_sink() -> str | None:
    """The explicitly :func:`configure`-d JSON-lines sink path, or None
    when disabled / deferring to ``ICT_TELEMETRY``.  The in-process
    replica factory (fleet/autoscale.py) reads this so a replica spawned
    MID-RUN inherits the router's sink instead of resetting the
    process-global configuration out from under it."""
    with _lock:
        return None if _explicit is _UNSET else _explicit


def enabled() -> bool:
    """Whether an event sink is active (the one check every hook makes)."""
    if _explicit is _UNSET:
        return bool(os.environ.get("ICT_TELEMETRY"))
    return _explicit is not None


def active() -> bool:
    """Whether ANY consumer of :func:`emit` exists: the JSON-lines sink OR
    the always-on flight recorder (:mod:`.flight`, which mirrors every
    event into its bounded ring).  Call-site guards that only exist to
    skip building kwargs should use this, not :func:`enabled` — with the
    flight recorder on by default, an event skipped "because no sink" is
    an event missing from the post-mortem."""
    return enabled() or flight.enabled()


def current() -> TraceContext | None:
    return _current.get()


def current_trace_id() -> str:
    ctx = _current.get()
    return ctx.trace_id if ctx is not None else ""


@contextlib.contextmanager
def trace_scope(trace_id: str, span_id: str = ""):
    """Bind a trace context to this thread/task so nested :func:`emit` and
    :func:`span` calls inherit it — the bridge for ids that crossed a
    thread boundary riding on a Job or session manifest."""
    token = _current.set(TraceContext(trace_id, span_id))
    try:
        yield
    finally:
        _current.reset(token)


def emit(event: str, trace_id: str | None = None, span_id: str | None = None,
         **fields) -> None:
    """Append one event line.  No-op without a sink; never raises — a
    failing sink (full disk, yanked directory) drops events for
    ``SINK_RETRY_S`` with one stderr warning, then tries again, rather
    than failing the clean it was observing or going silent forever."""
    global _fh, _fh_path, _warned, _retry_at, _fh_size, _rotations
    ctx = _current.get()
    tid = trace_id if trace_id is not None else (ctx.trace_id if ctx else "")
    sid = span_id if span_id is not None else (ctx.span_id if ctx else "")
    # Mirror every event into the always-on flight ring FIRST (bounded,
    # no I/O, independent of the sink): the recorder's whole point is the
    # incident nobody configured telemetry for.
    flight.note(event, trace_id=tid, **fields)
    if not enabled():
        return
    rec = {
        "ts": round(time.time(), 6),
        "event": event,
        "trace_id": tid,
        "span_id": sid,
    }
    rec.update(fields)
    line = json.dumps(rec, default=str) + "\n"
    with _lock:
        path = _sink_path_locked()
        if path is None:
            return
        if _retry_at and time.monotonic() < _retry_at:
            return
        try:
            if _fh is None or _fh_path != path:
                if _fh is not None:
                    _fh.close()
                _fh = open(path, "a")
                _fh_path = path
                # Size is tracked, not stat-ed per emit: seeded from the
                # file once at open, advanced by the bytes we write
                # (json.dumps is ensure_ascii, so len(line) IS the byte
                # count) — append-mode tell() semantics never enter it.
                _fh_size = os.path.getsize(path)
            cap = _max_bytes()
            if cap and _fh_size + len(line) > cap:
                # Size-cap rotation (ICT_EVENT_LOG_MAX_MB): the current
                # file becomes <path>.1 (replacing the previous rotated
                # generation — disk stays bounded at ~2x the cap) and the
                # sink continues into a fresh file.  A close + rename +
                # reopen under the lock we already hold; any failure
                # lands in the OSError envelope below, so rotation can
                # degrade to the normal drop-and-retry backoff but never
                # block or break the emit path.
                _fh.close()
                os.replace(path, path + ".1")
                _fh = open(path, "a")
                _fh_size = 0
                _rotations += 1
            _fh.write(line)
            _fh.flush()
            _fh_size += len(line)
            _retry_at = 0.0
        except OSError as exc:
            _retry_at = time.monotonic() + SINK_RETRY_S
            try:
                if _fh is not None:
                    _fh.close()
            except OSError:
                pass
            _fh = None
            _fh_path = None
            if not _warned:
                _warned = True
                print(f"warning: telemetry sink {path!r} failed ({exc}); "
                      f"dropping events, retrying every {SINK_RETRY_S:.0f}s",
                      file=sys.stderr)


@contextlib.contextmanager
def span(name: str, trace_id: str | None = None, **fields):
    """Emit ``<name>_start`` / ``<name>_end`` events around a block and bind
    the span's context: nested :func:`emit` calls inherit the trace_id and
    this span's id as their ``span_id``, and nested *spans* record it as
    their ``parent_span_id`` (the span's own start/end events carry both).
    The end event records ``duration_s`` and ``status`` ("ok"/"error").
    Fast no-op when neither the sink nor the flight recorder is active."""
    if not active():
        yield
        return
    ctx = _current.get()
    tid = trace_id if trace_id is not None else (ctx.trace_id if ctx else
                                                new_trace_id())
    sid = new_span_id()
    parent = ctx.span_id if ctx else ""
    emit(f"{name}_start", trace_id=tid, span_id=sid,
         parent_span_id=parent, **fields)
    token = _current.set(TraceContext(tid, sid))
    t0 = time.perf_counter()
    status = "ok"
    try:
        yield
    except BaseException:
        status = "error"
        raise
    finally:
        _current.reset(token)
        emit(f"{name}_end", trace_id=tid, span_id=sid,
             parent_span_id=parent, status=status,
             duration_s=round(time.perf_counter() - t0, 6))
