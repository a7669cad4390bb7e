"""Stdlib-HTTP client for the replica API, used by the fleet router.

Port of ``iterative_cleaner_tpu/fleet/client.py``.

The one design point is the error split: a **transport** failure
(connection refused, DNS, socket timeout — the replica may be dead) is
:class:`ReplicaUnreachable`, while an **HTTP** error (the replica is
alive and said no: 503 at the admission cap or draining, 400 for a bad
path) is :class:`ReplicaRefused` with the status attached.  The router's
failover ladder keys on exactly that distinction — transport failures
count toward declaring a replica dead and re-routing its jobs; refusals
never do (a draining replica answering 503 is *healthy*).
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request

#: Default per-request timeout for router -> replica calls.  Small: the
#: router's placement path blocks a client submission on it, and a
#: wedged replica should fail over in seconds, not minutes.
DEFAULT_TIMEOUT_S = 10.0


class ReplicaUnreachable(RuntimeError):
    """Transport-level failure: nothing answered (or the answer never
    arrived).  Counts toward the registry's death threshold."""


class ReplicaRefused(RuntimeError):
    """The replica answered with an HTTP error status; it is alive."""

    def __init__(self, status: int, body: dict) -> None:
        super().__init__(f"replica refused ({status}): "
                         f"{body.get('error', '')!s}")
        self.status = int(status)
        self.body = body


class ReplicaClient:
    """Thin JSON-over-HTTP client; one instance is shared by the router's
    handler threads and the poll loop (it holds no mutable state)."""

    def __init__(self, timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
        self.timeout_s = float(timeout_s)

    def _call(self, url: str, body: dict | None = None,
              headers: dict | None = None) -> dict:
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(url, data=data, headers={
            **({"Content-Type": "application/json"} if data else {}),
            **(headers or {})})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                payload = json.load(resp)
        except urllib.error.HTTPError as exc:
            # The replica spoke HTTP: parse its JSON error envelope if it
            # sent one (it always does), keep the status either way.
            try:
                detail = json.load(exc)
                if not isinstance(detail, dict):
                    detail = {"error": str(detail)}
            except ValueError:
                detail = {"error": exc.reason}
            raise ReplicaRefused(exc.code, detail) from exc
        except (urllib.error.URLError, ConnectionError, TimeoutError,
                OSError) as exc:
            raise ReplicaUnreachable(f"{url}: {exc}") from exc
        if not isinstance(payload, dict):
            raise ReplicaUnreachable(f"{url}: non-object JSON reply")
        return payload

    def _call_text(self, url: str) -> str:
        """GET one non-JSON endpoint (the replica's Prometheus
        ``/metrics``); same transport-vs-HTTP error split as JSON calls."""
        try:
            with urllib.request.urlopen(
                    urllib.request.Request(url),
                    timeout=self.timeout_s) as resp:
                return resp.read().decode("utf-8")
        except urllib.error.HTTPError as exc:
            raise ReplicaRefused(exc.code, {"error": exc.reason}) from exc
        except (urllib.error.URLError, ConnectionError, TimeoutError,
                OSError) as exc:
            raise ReplicaUnreachable(f"{url}: {exc}") from exc

    # --- the replica surface the router speaks ---

    def health(self, base_url: str) -> dict:
        return self._call(f"{base_url}/healthz")

    def metrics_text(self, base_url: str) -> str:
        """The replica's raw Prometheus exposition — the federation
        scrape (fleet/obs.py parses it strictly)."""
        return self._call_text(f"{base_url}/metrics")

    def job_trace(self, base_url: str, job_id: str) -> dict:
        """GET /jobs/<id>/trace: the replica's persisted per-job
        forensics timeline — the lazy half of cross-hop trace assembly."""
        return self._call(f"{base_url}/jobs/{job_id}/trace")

    def flight(self, base_url: str) -> dict:
        """GET /debug/flight: the replica's live flight ring — cached by
        the poll loop as the best-effort pre-death record."""
        return self._call(f"{base_url}/debug/flight")

    def submit(self, base_url: str, payload: dict,
               trace_id: str = "") -> dict:
        """POST /jobs on one replica; the trace context crosses the hop in
        the X-ICT-Trace header (the replica adopts it instead of minting),
        so the event log threads placement -> dispatch under one id.  The
        payload-stamped tenant ALSO rides the X-ICT-Tenant header — the
        replica reads body first, header second, so this is belt and
        braces keeping failover re-routes and direct replica submissions
        on the same attribution path (service/api.py)."""
        headers = {}
        if trace_id:
            headers["X-ICT-Trace"] = trace_id
        if payload.get("tenant"):
            headers["X-ICT-Tenant"] = str(payload["tenant"])
        return self._call(f"{base_url}/jobs", body=payload,
                          headers=headers or None)

    def job(self, base_url: str, job_id: str) -> dict:
        return self._call(f"{base_url}/jobs/{job_id}")

    # --- streaming-session proxy (the router's /sessions surface) ---

    def session_open(self, base_url: str, body: dict) -> dict:
        """POST /sessions on one replica (SessionMeta dict + optional
        out_path/alert_iters) — the router's session-proxy open hop."""
        return self._call(f"{base_url}/sessions", body=body)

    def session_block(self, base_url: str, sid: str,
                      payload: bytes) -> dict:
        """POST /sessions/<id>/blocks: one encoded subint block, raw wire
        bytes (online/blocks.py codec) forwarded verbatim."""
        req = urllib.request.Request(
            f"{base_url}/sessions/{sid}/blocks", data=payload,
            headers={"Content-Type": "application/octet-stream"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                reply = json.load(resp)
        except urllib.error.HTTPError as exc:
            try:
                detail = json.load(exc)
                if not isinstance(detail, dict):
                    detail = {"error": str(detail)}
            except ValueError:
                detail = {"error": exc.reason}
            raise ReplicaRefused(exc.code, detail) from exc
        except (urllib.error.URLError, ConnectionError, TimeoutError,
                OSError) as exc:
            raise ReplicaUnreachable(f"{base_url}: {exc}") from exc
        if not isinstance(reply, dict):
            raise ReplicaUnreachable(f"{base_url}: non-object JSON reply")
        return reply

    def session_finish(self, base_url: str, sid: str) -> dict:
        return self._call(f"{base_url}/sessions/{sid}/finish", body={})

    def session_get(self, base_url: str, sid: str) -> dict:
        return self._call(f"{base_url}/sessions/{sid}")

    def drain(self, base_url: str, flag: bool = True) -> dict:
        return self._call(f"{base_url}/drain", body={"drain": bool(flag)})
