"""JSON HTTP surface over stdlib ``http.server`` — zero new dependencies.

A copy of ``iterative_cleaner_tpu/service/api.py``: the same endpoints,
bodies and status codes.

Endpoints (JSON unless noted; full reference in docs/SERVING.md and
docs/OBSERVABILITY.md):

- ``POST /jobs``            ``{"path": "/abs/archive.npz"}`` -> 202 + job
                            (the response and its ``X-ICT-Trace`` header
                            carry the job's telemetry ``trace_id``; an
                            inbound ``X-ICT-Trace`` — the fleet router's
                            proxied hop — is adopted instead of minting;
                            the 202 body carries ``replica_id`` so trace
                            logs attribute jobs to replicas; an optional
                            ``"idempotency_key"`` dedupes re-submissions —
                            the router's failover path)
- ``POST /drain``           enter/leave drain mode (body optional
                            ``{"drain": false}`` to undrain): a draining
                            replica 503s new submissions, reports
                            ``draining: true`` on ``/healthz`` (the fleet
                            router stops placing on it), and flushes
                            parked partial buckets so accepted work
                            finishes fast
- ``GET  /jobs/<id>``       job manifest (state machine in service/jobs.py)
- ``GET  /jobs/<id>/trace`` convergence forensics: trace id, termination
                            reason, per-iteration timeline
- ``POST /sessions``        open a streaming session (body: SessionMeta
                            fields + optional out_path/alert_iters)
- ``POST /sessions/<id>/blocks``  one subint block as an NPZ body
                            (online/blocks.py) -> provisional zap alert
- ``POST /sessions/<id>/finish``  canonical finalize -> final manifest
- ``GET  /sessions/<id>``   session manifest
- ``GET  /healthz``         liveness + backend mode + uptime/version +
                            queue/spool depths (the load-balancer drain view)
- ``GET  /metrics``         Prometheus text exposition (obs/metrics.py):
                            per-phase log2 latency histograms, counters,
                            compile/cache accounting with shape-bucket and
                            route labels
- ``GET  /metrics.json``    the legacy raw-JSON counter snapshot
                            (obs/tracing.py: ``*_s`` total seconds, ``*_n``
                            counts, ``*_err_n`` failures, ``*_max_s`` worst
                            single occurrence, ``service_*``/``online_*``
                            events)
- ``POST /debug/profile``   start a bounded ``torch.profiler`` capture around
                            whatever is in flight (body: optional
                            ``{"duration_s": 5}``; ``{"stop": true}`` ends
                            the running one); 409 when a capture is already
                            running (obs/profiling.py)
- ``GET  /debug/profiles``  list capture artifacts (name/bytes/files/mtime)
                            plus the active capture, if any
- ``GET  /debug/flight``    the always-on flight-recorder ring of recent
                            events/phase timings (obs/flight.py) — the live
                            view of what fault-ladder/SIGTERM dumps write
- ``GET  /debug/memory``    host RSS + per-device HBM view + recorded
                            executable analyses (obs/memory.py)
- ``GET  /debug/audit``     shadow-oracle audit state (obs/audit.py):
                            cumulative counters, sampling rate, queue
                            depth, recent audit records, and the repro
                            bundles on disk

ThreadingHTTPServer: each request gets a thread, so a slow client cannot
stall the poll loop; all handlers only touch thread-safe service surfaces
(spool writes are serialized, counters are locked, submission enqueues,
session mutations hold per-session locks).
"""

from __future__ import annotations

import json
import os
import sys
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from iterative_cleaner_tpu_torch.obs import metrics as obs_metrics
from iterative_cleaner_tpu_torch.obs import tracing

#: Default per-socket-read timeout; ``ICT_HTTP_TIMEOUT_S`` overrides — a
#: streaming client uploading multi-hundred-MB blocks over a slow link
#: needs more than the one-shot default, and raising it globally for
#: everyone would let dead sockets pin handler threads longer.
DEFAULT_HTTP_TIMEOUT_S = 30.0


def http_timeout_s() -> float:
    env = os.environ.get("ICT_HTTP_TIMEOUT_S")
    if env is None:
        return DEFAULT_HTTP_TIMEOUT_S
    try:
        val = float(env)
        if val <= 0:
            raise ValueError
        return val
    except ValueError:
        print(f"warning: ignoring unparseable ICT_HTTP_TIMEOUT_S={env!r} "
              f"(want a positive seconds count); using "
              f"{DEFAULT_HTTP_TIMEOUT_S:g}", file=sys.stderr)
        return DEFAULT_HTTP_TIMEOUT_S


class _Handler(BaseHTTPRequestHandler):
    # Bound every socket read (BaseRequestHandler.setup applies this via
    # connection.settimeout): a client that under-sends its declared body
    # or never sends a request line must time out, not leak this handler
    # thread and its FD forever.  The value is resolved per server at bind
    # time (make_http_server) so ICT_HTTP_TIMEOUT_S takes effect without
    # mutating class state shared by other servers in the process.
    timeout = DEFAULT_HTTP_TIMEOUT_S

    def setup(self) -> None:
        self.timeout = self.server.http_timeout_s
        BaseHTTPRequestHandler.setup(self)

    # The default handler logs every request line to stderr; route through
    # the service's quiet flag instead (a health-checked daemon would spam).
    def log_message(self, fmt, *args):  # noqa: A003 — stdlib signature
        if not self.server.service.serve_cfg.quiet:
            BaseHTTPRequestHandler.log_message(self, fmt, *args)

    def _reply(self, code: int, payload: dict, headers: dict | None = None) -> None:
        body = (json.dumps(payload) + "\n").encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if isinstance(payload, dict) and payload.get("trace_id"):
            # Echo the telemetry trace context wherever a payload carries
            # one, so header-only clients can correlate with the event log.
            self.send_header("X-ICT-Trace", str(payload["trace_id"]))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _reply_text(self, code: int, text: str, content_type: str) -> None:
        body = text.encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self, clamp: int) -> bytes:
        # Clamp the client-supplied length: a negative value would make
        # read() block until EOF (leaking this handler thread) and a
        # huge one would buffer it all.  A MALFORMED header reads as an
        # empty body — the downstream parse then 400s, it never drops the
        # socket (online/blocks.py's contract).
        try:
            n = int(self.headers.get("Content-Length", 0))
        except (TypeError, ValueError):
            n = 0
        return self.rfile.read(max(0, min(n, clamp)))

    def do_GET(self) -> None:  # noqa: N802 — stdlib signature
        service = self.server.service
        if self.path == "/healthz":
            self._reply(200, service.health())
        elif self.path == "/metrics":
            self._reply_text(200, obs_metrics.render_prometheus(),
                             obs_metrics.CONTENT_TYPE)
        elif self.path == "/metrics.json":
            self._reply(200, tracing.counters_snapshot())
        elif self.path == "/costs":
            # The replica's lifetime showback ledger (obs/costs.py):
            # spool-persisted, restart-resumed — the durable record next
            # to the per-process-life ict_cost_* counters on /metrics.
            self._reply(200, service.ctx.cost_ledger.report())
        elif self.path.startswith("/jobs/"):
            jid, sep, verb = self.path[len("/jobs/"):].partition("/")
            job = service.job(jid)
            if job is None or (sep and verb != "trace"):
                self._reply(404, {"error": "no such job"
                                  if job is None else
                                  f"no such route {self.path!r}"})
            elif sep:
                # replica_id rides on the trace the same way it rides on
                # the 202: the fleet router's cross-hop trace assembly
                # labels each stitched span with its source replica.
                self._reply(200, {**job.trace_dict(),
                                  "replica_id": service.replica_id})
            else:
                self._reply(200, job.to_dict())
        elif self.path == "/debug/profiles":
            from iterative_cleaner_tpu_torch.obs import profiling

            self._reply(200, {
                "active": profiling.active(),
                "profiles": profiling.list_profiles(service.profile_root),
            })
        elif self.path == "/debug/flight":
            from iterative_cleaner_tpu_torch.obs import flight

            self._reply(200, {
                "enabled": flight.enabled(),
                "capacity": flight.capacity(),
                "events": flight.snapshot(),
            })
        elif self.path == "/debug/memory":
            from iterative_cleaner_tpu_torch.obs import memory as obs_memory

            self._reply(200, obs_memory.memory_report())
        elif self.path == "/debug/audit":
            from iterative_cleaner_tpu_torch.obs import audit as obs_audit

            report = obs_audit.audit_report()
            report["rate"] = service.audit_rate()
            report["queue_depth"] = (service.auditor.queue_depth()
                                     if service.auditor else 0)
            report["recent"] = (service.auditor.recent()
                                if service.auditor else [])
            report["bundles"] = obs_audit.list_bundles(service.repro_dir)
            self._reply(200, report)
        elif self.path.startswith("/sessions/"):
            sid = self.path[len("/sessions/"):]
            self._session_call(lambda s: s.manifest(sid))
        else:
            self._reply(404, {"error": f"no such route {self.path!r}"})

    def do_POST(self) -> None:  # noqa: N802 — stdlib signature
        service = self.server.service
        if self.path == "/jobs":
            self._post_job()
            return
        if self.path == "/sessions":
            self._post_session_open()
            return
        if self.path == "/debug/profile":
            self._post_debug_profile()
            return
        if self.path == "/drain":
            self._post_drain()
            return
        if self.path.startswith("/sessions/"):
            rest = self.path[len("/sessions/"):]
            sid, sep, verb = rest.partition("/")
            if sep and verb == "blocks":
                from iterative_cleaner_tpu_torch.online.blocks import (
                    MAX_BLOCK_BYTES,
                )

                payload = self._read_body(MAX_BLOCK_BYTES)
                self._session_call(lambda s: s.add_block(sid, payload))
                return
            if sep and verb == "finish":
                self._session_call(lambda s: s.finish(sid))
                return
        self._reply(404, {"error": f"no such route {self.path!r}"})

    # --- debug: profiler capture (obs/profiling) ---

    def _post_debug_profile(self) -> None:
        service = self.server.service
        from iterative_cleaner_tpu_torch.obs import profiling

        try:
            body = json.loads(self._read_body(1 << 20) or b"{}")
            if not isinstance(body, dict):
                raise TypeError("body must be a JSON object")
            stop = bool(body.get("stop", False))
            duration_s = float(body.get("duration_s", 5.0))
        except (ValueError, TypeError) as exc:
            self._reply(400, {"error": f"bad profile request: {exc!r}; "
                                       'expected {"duration_s": 5} or '
                                       '{"stop": true}'})
            return
        if stop:
            rec = profiling.stop()
            if rec is None:
                self._reply(409, {"error": "no capture is running"})
            else:
                self._reply(200, rec)
            return
        try:
            rec = profiling.start(service.profile_root, duration_s=duration_s,
                                  device=service.ctx.device)
        except RuntimeError as exc:   # capture already running
            self._reply(409, {"error": str(exc)})
            return
        except Exception as exc:  # noqa: BLE001 — the client deserves a 500
            self._reply(500, {"error": f"profiler start failed: {exc}"})
            return
        self._reply(200, rec)

    # --- drain mode (the fleet router's /healthz-driven eviction hook) ---

    def _post_drain(self) -> None:
        service = self.server.service
        try:
            body = json.loads(self._read_body(1 << 20) or b"{}")
            if not isinstance(body, dict):
                raise TypeError("body must be a JSON object")
            flag = bool(body.get("drain", True))
        except (ValueError, TypeError) as exc:
            self._reply(400, {"error": f"bad drain request: {exc!r}; "
                                       'expected {} or {"drain": false}'})
            return
        service.set_draining(flag)
        self._reply(200, {"replica_id": service.replica_id,
                          "draining": flag})

    # --- jobs ---

    def _post_job(self) -> None:
        service = self.server.service
        try:
            body = json.loads(self._read_body(1 << 20) or b"{}")
            path = body["path"]
            profile = bool(body.get("profile", False))
            audit = bool(body.get("audit", False))
            idem_key = str(body.get("idempotency_key", "") or "")
            tenant = str(body.get("tenant", "") or "")
            # Router-injected canary probes (fleet/canary.py) stamp this;
            # it rides the job record end-to-end so every observer can
            # exclude synthetic traffic from the planes it measures.
            synthetic = bool(body.get("synthetic", False))
            shape = body.get("shape")
            if shape is not None:
                # Same optional grammar the fleet router accepts: the
                # declared [nsub, nchan, nbin] hint rides into the
                # job_submitted event so a recorded trace replays with
                # its original bucket (proving/traces.py).
                shape = [int(v) for v in shape]
        # TypeError covers valid-JSON non-dict bodies ('[]', '5', 'null'):
        # the client gets a 400, not a dropped socket.
        except (ValueError, KeyError, TypeError) as exc:
            self._reply(400, {"error": f"bad request body: {exc!r}; expected "
                                       '{"path": "/abs/archive"}'})
            return
        from iterative_cleaner_tpu_torch.service.daemon import ServiceBusy

        # A submission that already crossed the fleet router carries its
        # trace context in the X-ICT-Trace header; adopt it instead of
        # minting so the event log threads router placement -> replica
        # dispatch under ONE trace_id.  The tenant rides the same way
        # (the router forwards its admission tenant in the body; direct
        # submitters may send the X-ICT-Tenant header) — it is the cost
        # ledger's showback key (obs/costs.py).
        trace_id = str(self.headers.get("X-ICT-Trace", "") or "")
        tenant = tenant or str(self.headers.get("X-ICT-Tenant", "") or "")
        try:
            job = service.submit(str(path), profile=profile, audit=audit,
                                 idempotency_key=idem_key,
                                 trace_id=trace_id, tenant=tenant,
                                 shape=shape, synthetic=synthetic)
        except ServiceBusy as exc:
            self._reply(503, {"error": str(exc)}, headers={"Retry-After": "5"})
            return
        except ValueError as exc:   # --root refusal
            self._reply(400, {"error": str(exc)})
            return
        except Exception as exc:  # noqa: BLE001 — e.g. a spool write failure:
            # the client deserves a 500, not a dropped socket
            self._reply(500, {"error": f"submission failed: {exc}"})
            return
        # replica_id rides on every 202 so multi-replica trace logs (and
        # the fleet router's placement table) attribute jobs to replicas.
        self._reply(202, {**job.to_dict(), "replica_id": service.replica_id})

    # --- streaming sessions ---

    def _post_session_open(self) -> None:
        service = self.server.service
        try:
            body = json.loads(self._read_body(1 << 20) or b"{}")
            if not isinstance(body, dict):
                raise TypeError("body must be a JSON object")
            out_path = body.pop("out_path", None)
            alert_iters = body.pop("alert_iters", None)
            if out_path:
                # The write target obeys the same --root trust boundary as
                # submitted read paths (docs/SERVING.md trust model).
                out_path = service._check_root(str(out_path))
        except (ValueError, TypeError) as exc:
            self._reply(400, {"error": f"bad session request: {exc}"})
            return
        self._session_call(
            lambda s: s.create(body, out_path=out_path,
                               alert_iters=alert_iters), code=201)

    def _session_call(self, fn, code: int = 200) -> None:
        """Run one SessionManager operation with the shared error mapping
        (unknown id → 404, closed → 409, bad payload → 400)."""
        from iterative_cleaner_tpu_torch.service.sessions import (
            SessionClosed,
            UnknownSession,
        )

        sessions = self.server.service.sessions
        if sessions is None:
            self._reply(404, {"error": "streaming sessions are disabled"})
            return
        try:
            self._reply(code, fn(sessions))
        except UnknownSession:
            self._reply(404, {"error": "no such session"})
        except SessionClosed as exc:
            self._reply(409, {"error": str(exc)})
        except ValueError as exc:
            self._reply(400, {"error": str(exc)})
        except Exception as exc:  # noqa: BLE001 — the client deserves a 500
            self._reply(500, {"error": f"session operation failed: {exc}"})


def make_http_server(service, host: str, port: int) -> ThreadingHTTPServer:
    """Bind (port 0 -> ephemeral, for tests); caller runs serve_forever on
    a thread and shutdown() on stop."""
    server = ThreadingHTTPServer((host, port), _Handler)
    server.daemon_threads = True
    server.service = service
    server.http_timeout_s = http_timeout_s()
    return server
