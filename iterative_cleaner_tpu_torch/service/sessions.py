"""Daemon-side streaming sessions: spool-backed lifecycle over OnlineSession.

A port of ``iterative_cleaner_tpu/service/sessions.py`` over the port's
:class:`..online.session.OnlineSession` (its passes run on ``device``),
``SessionMeta``, ``driver.atomic_save`` and NPZ I/O.  The spool layout and
the replay log's bytes are the JAX daemon's, so either daemon resumes the
other's sessions.

Each session owns a directory under ``<spool>/sessions/<id>/``:

- ``meta.json`` — the SessionMeta the session was opened with (+ options);
- ``block_00000.npz`` … — every accepted block's VERBATIM upload bytes, in
  arrival order (the replay log);
- ``final.json`` — written at finish; its presence is the terminal marker.

Durability is replay, the jobs-spool philosophy applied to streams: blocks
are persisted atomically BEFORE they are ingested, so a daemon that dies
mid-stream loses at most the in-memory provisional state — the next daemon
indexes the directory at startup and lazily rebuilds the resident
:class:`OnlineSession` (re-ingesting the spooled blocks through the
identical path, deterministic) the first time the client touches the
session again.  Finalize itself is the canonical offline clean of the
assembled blocks, so a finish after restart produces the same
oracle-identical mask a never-restarted daemon would.

Provisional passes for DIFFERENT sessions are serialized by one pass lock:
concurrent HTTP handler threads must not stack device dispatches (the
dispatch-worker single-ownership rationale), and a bounded pass is short by
design.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time

from iterative_cleaner_tpu_torch.config import CleanConfig
from iterative_cleaner_tpu_torch.obs import events, tracing
from iterative_cleaner_tpu_torch.online.blocks import decode_block
from iterative_cleaner_tpu_torch.online.session import (
    DEFAULT_ALERT_ITERS,
    OnlineSession,
)
from iterative_cleaner_tpu_torch.online.state import SessionMeta
from iterative_cleaner_tpu_torch.service.jobs import new_job_id

_ID_RE = re.compile(r"^[0-9]{13}-[0-9a-f]{8}$")
_BLOCK_RE = re.compile(r"^block_(\d{5,})\.npz$")


class UnknownSession(KeyError):
    """No such session (API → 404)."""


class SessionClosed(ValueError):
    """Blocks/finish on an already-finished session (API → 409)."""


class SessionManager:
    def __init__(self, root: str, cfg: CleanConfig,
                 alert_iters: int = DEFAULT_ALERT_ITERS,
                 quiet: bool = False, cfg_provider=None,
                 device="cuda") -> None:
        self.root = root
        self.cfg = cfg
        self.device = device
        # ``cfg_provider`` re-resolves the config per touched session so a
        # runtime service-wide backend demotion (daemon.note_dispatch_
        # failure) reaches streaming passes too, not only the job routes.
        self._cfg = cfg_provider or (lambda: self.cfg)
        self.alert_iters = int(alert_iters)
        self.quiet = quiet
        os.makedirs(root, exist_ok=True)
        self._live: dict[str, OnlineSession] = {}  # ict: guarded-by(self._lock)
        self._out_paths: dict[str, str] = {}  # ict: guarded-by(self._lock)
        self._trace_ids: dict[str, str] = {}   # telemetry context per session  # ict: guarded-by(self._lock)
        self._lock = threading.Lock()          # the maps
        self._pass_lock = threading.Lock()     # device passes serialize
        self._locks: dict[str, threading.Lock] = {}  # per-session ordering

    # --- paths ---

    def _dir(self, sid: str) -> str:
        if not _ID_RE.match(sid or ""):
            # Ids come straight off the HTTP path (the jobs-spool traversal
            # rule): anything not shaped like our ids resolves to nothing.
            raise UnknownSession(sid)
        return os.path.join(self.root, sid)

    def _session_lock(self, sid: str) -> threading.Lock:
        with self._lock:
            return self._locks.setdefault(sid, threading.Lock())

    @staticmethod
    def _write_json(path: str, payload: dict) -> None:
        tmp = f"{path}.part"
        with open(tmp, "w") as fh:
            json.dump(payload, fh, indent=1)
            fh.write("\n")
        os.replace(tmp, path)

    def _block_files(self, d: str) -> list[str]:
        try:
            names = sorted(n for n in os.listdir(d) if _BLOCK_RE.match(n))
        except OSError:
            raise UnknownSession(os.path.basename(d)) from None
        return [os.path.join(d, n) for n in names]

    # --- lifecycle ---

    def create(self, meta_dict: dict, out_path: str | None = None,
               alert_iters: int | None = None) -> dict:
        # Validate EVERYTHING before touching the disk: a refused open must
        # not leak a meta-less session directory that /healthz would count
        # as open forever.
        meta = SessionMeta.from_dict(meta_dict)   # ValueError → API 400
        iters = self.alert_iters if alert_iters is None else int(alert_iters)
        if iters < 1:
            raise ValueError(f"alert_iters must be >= 1, got {iters}")
        sid = new_job_id()
        # Streaming sessions are an entry point: the trace context is
        # minted at open, persisted in meta.json (so a restarted daemon
        # keeps the same trace), and echoed in every manifest response.
        trace_id = events.new_trace_id()
        d = os.path.join(self.root, sid)
        os.makedirs(d, exist_ok=True)
        self._write_json(os.path.join(d, "meta.json"), {
            "meta": meta.to_dict(),
            "out_path": out_path,
            "alert_iters": iters,
            "created_s": time.time(),
            "trace_id": trace_id,
        })
        with self._lock:
            self._live[sid] = OnlineSession(
                meta, self._cfg(), alert_iters=iters, device=self.device)
            if out_path:
                self._out_paths[sid] = out_path
            self._trace_ids[sid] = trace_id
        tracing.count("online_sessions_opened")
        if events.active():
            events.emit("session_opened", trace_id=trace_id, session_id=sid,
                        nchan=meta.nchan, nbin=meta.nbin)
        return self.manifest(sid)

    def _materialize(self, sid: str) -> OnlineSession:
        """The resident session — rebuilt from the spool (block replay)
        when this daemon has never touched it (restart resume)."""
        with self._lock:
            live = self._live.get(sid)
        if live is not None:
            return live
        d = self._dir(sid)
        try:
            with open(os.path.join(d, "meta.json")) as fh:
                saved = json.load(fh)
        except OSError:
            raise UnknownSession(sid) from None
        if os.path.exists(os.path.join(d, "final.json")):
            raise SessionClosed(f"session {sid} already finished")
        session = OnlineSession(
            SessionMeta.from_dict(saved["meta"]), self._cfg(),
            alert_iters=int(saved.get("alert_iters") or self.alert_iters),
            device=self.device)
        # replay_block appends without per-block provisional passes (the
        # alerts already fired in the previous life), so a long session's
        # restart costs slab copies, not blocks × device dispatches.
        n = 0
        for p in self._block_files(d):
            with open(p, "rb") as fh:
                data, weights = decode_block(fh.read())
            session.replay_block(data, weights)
            n += 1
        if n:
            tracing.count("online_blocks_replayed", n)
        with self._lock:
            # A concurrent materialize of the same sid may have won; keep
            # the first so block counters stay consistent.
            live = self._live.setdefault(sid, session)
            out = saved.get("out_path")
            if out:
                self._out_paths.setdefault(sid, out)
            self._trace_ids.setdefault(sid, saved.get("trace_id", ""))
        return live

    def _trace_id(self, sid: str) -> str:
        with self._lock:
            return self._trace_ids.get(sid, "")

    def add_block(self, sid: str, payload: bytes) -> dict:
        with self._session_lock(sid):
            session = self._materialize(sid)
            if session.finalized:
                raise SessionClosed(f"session {sid} already finished")
            # Re-resolve the config on every touch: a service-wide backend
            # demotion mid-stream must reach this session's next pass.
            session.cfg = self._cfg()
            data, weights = decode_block(payload)   # ValueError → 400
            d = self._dir(sid)
            idx = session.blocks_ingested
            p = os.path.join(d, f"block_{idx:05d}.npz")
            tmp = f"{p}.part"
            with self._pass_lock, events.trace_scope(self._trace_id(sid)):
                # The spooled copy lands only after ingest ACCEPTED the
                # block (ingest rolls its slab append back on any failure),
                # so spool and resident state can never diverge: crash
                # after ingest loses only advisory provisional state.
                # The trace scope threads the session's trace_id into the
                # ingest pass's per-block / per-iteration telemetry events.
                with open(tmp, "wb") as fh:
                    fh.write(payload)
                try:
                    alert = session.ingest(data, weights)
                except Exception:
                    os.remove(tmp)
                    raise
                os.replace(tmp, p)
            return alert.to_dict()

    def finish(self, sid: str) -> dict:
        from iterative_cleaner_tpu_torch.driver import atomic_save
        from iterative_cleaner_tpu_torch.io.npz import NpzIO

        with self._session_lock(sid):
            session = self._materialize(sid)
            if session.finalized:
                raise SessionClosed(f"session {sid} already finished")
            if session.blocks_ingested == 0:
                raise ValueError(f"session {sid} has no blocks to finalize")
            session.cfg = self._cfg()   # demotion reaches finalize too
            d = self._dir(sid)
            with self._pass_lock, events.trace_scope(self._trace_id(sid)), \
                    events.span("session_finalize", session_id=sid), \
                    tracing.phase("online_finalize"):
                fin = session.finalize()
            out_path = self._out_paths.get(sid) or os.path.join(d, "final.npz")
            atomic_save(NpzIO(), fin.output.cleaned, out_path)
            payload = dict(fin.to_dict(), out_path=out_path,
                           finished_s=time.time())
            self._write_json(os.path.join(d, "final.json"), payload)
            with self._lock:
                # The resident slabs are the big memory; drop them — the
                # manifest below is served from disk from here on.
                self._live.pop(sid, None)
            tracing.count("online_sessions_finished")
            return self.manifest(sid)

    # --- inspection ---

    def manifest(self, sid: str) -> dict:
        d = self._dir(sid)
        try:
            with open(os.path.join(d, "meta.json")) as fh:
                saved = json.load(fh)
        except OSError:
            raise UnknownSession(sid) from None
        out = {
            "id": sid,
            "state": "open",
            "blocks": len(self._block_files(d)),
            "alert_iters": saved.get("alert_iters"),
            "nchan": saved["meta"].get("nchan"),
            "nbin": saved["meta"].get("nbin"),
            "trace_id": saved.get("trace_id", ""),
        }
        with self._lock:
            live = self._live.get(sid)
        if live is not None:
            out["nsub"] = live.state.nsub
            out["provisional_rfi_frac"] = (
                float((live.state.prov_w == 0).mean())
                if live.state.prov_w.size else 0.0)
        try:
            with open(os.path.join(d, "final.json")) as fh:
                final = json.load(fh)
            out["state"] = "done"
            out.update(final)
        except OSError:
            pass
        return out

    def open_count(self) -> int:
        """Unfinished sessions on disk (the /healthz view — includes
        not-yet-rematerialized ones from a previous daemon life)."""
        try:
            sids = [n for n in os.listdir(self.root) if _ID_RE.match(n)]
        except OSError:
            return 0
        return sum(
            1 for s in sids
            if not os.path.exists(os.path.join(self.root, s, "final.json")))
