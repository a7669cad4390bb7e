"""Black-box canary prober: deterministic synthetic user journeys driven
through the fleet router's PUBLIC HTTP surface (measurement
half; the accounting half is fleet/slo.py).

Port of ``iterative_cleaner_tpu/fleet/canary.py``.

Four journeys, each a real user path end to end:

- ``fresh``    POST /jobs -> status polls -> result.  Every round
  re-stamps the canary archive's ``source`` header with a nonce, so the
  bytes (and the fleet cache digest) are new each round and the journey
  genuinely exercises placement + dispatch.
- ``cache``    byte-identical resubmit of the same round's file — must
  come back ``served_by == "fleet-cache"``, born terminal.
- ``session``  POST /sessions -> per-subint blocks -> finish, through
  the router's session proxy.
- ``campaign`` a 2-entry micro-manifest (one cache-warm path, one
  fresh) through POST /campaigns -> status polls.

Every verdict carries a **bit-identical mask check** against the stored
numpy-oracle answer (computed once per prepare from the same archive
bytes the replicas clean — the repo's parity invariant is what makes
"canary green" mean "users get correct masks"), plus per-hop latency
folded out of the existing trace assembly (fleet/obs.span_hops).

Synthetic traffic is stamped ``synthetic=true`` end-to-end and runs
under the reserved ``_canary`` tenant (fleet/tenants.SYNTHETIC_TENANT):
excluded from capacity demand, tenant quotas, cost showback, and scoped
out of the shared result-cache salt (fleet/router.py) — a probe that
moved the planes it measures would be measuring itself.

Threading: rounds run on a dedicated daemon thread kicked by the
router's poll tick (``maybe_start``); journeys are plain blocking HTTP
against the router, so the poll loop is never blocked and no router
lock is ever held across a probe.  ``run_round`` may also be called
synchronously (tests, the smoke lane).
"""

from __future__ import annotations

import os
import threading
import time
import urllib.error
import urllib.request
import uuid
from dataclasses import replace

from iterative_cleaner_tpu_torch.fleet import obs as fleet_obs
from iterative_cleaner_tpu_torch.fleet.tenants import SYNTHETIC_TENANT

#: Canary archive dims — tiny (one subint block per POST, four blocks a
#: session) but inside the parity floor (nbin >= 3, CLAUDE.md).
CANARY_SHAPE = (4, 16, 64)

#: Deterministic seeds for the two probe archives.
_SEED_A = 1801
_SEED_B = 1802

#: Replica job states that end a status poll.
_TERMINAL = ("done", "error")


class CanaryError(RuntimeError):
    """One journey failed in transit (HTTP error, timeout, bad reply)."""


def _flip_one(weights):
    """The fault-injection seam's single-bit mask flip: toggle the zap
    state of exactly one (subint, channel) cell."""
    flipped = weights.copy()
    flipped.flat[0] = 0.0 if flipped.flat[0] != 0.0 else 1.0
    return flipped


class CanaryProber:
    """Owns the probe corpus (archives + precomputed oracle masks under
    ``<spool>/canary/``) and runs probe rounds against the router's
    public base URL.  One round = all four journeys, sequentially (the
    cache journey NEEDS the fresh journey's entry to be learned)."""

    def __init__(self, spool_dir: str, base_url_fn, clean_cfg=None,
                 timeout_s: float = 120.0, quiet: bool = True) -> None:
        self.dir = os.path.join(spool_dir, "canary")
        os.makedirs(self.dir, exist_ok=True)
        self.base_url_fn = base_url_fn
        self.clean_cfg = clean_cfg
        self.timeout_s = float(timeout_s)
        self.quiet = quiet
        #: The SLO plane verdicts feed (set by the router after both
        #: planes exist) and the mask-mismatch incident hook.
        self.slo = None
        self.on_mask_mismatch = None
        #: Test/drill seam: while True, one bit of every OBSERVED mask is
        #: flipped before the oracle compare — the injected-corruption
        #: path the e2e tests and chaos drills drive (the
        #: acceptance chain: canary -> correctness SLI -> burn alert ->
        #: incident bundle).
        self.corrupt_mask = False
        self._lock = threading.Lock()
        self._thread = None            # ict: guarded-by(self._lock)
        self._rounds = 0               # ict: guarded-by(self._lock)
        self._prepared = False         # ict: guarded-by(self._lock)
        # Probe corpus, written once by _ensure_prepared under _lock and
        # read-only afterwards.
        self._arch_a = None            # ict: guarded-by(self._lock)
        self._path_b = ""              # ict: guarded-by(self._lock)
        self._oracle_a = None          # ict: guarded-by(self._lock)
        self._oracle_b = None          # ict: guarded-by(self._lock)

    # --- corpus ---

    def _ensure_prepared(self) -> None:
        with self._lock:
            if self._prepared:
                return
            # Lazy heavy imports: the prober only pulls the cleaning
            # stack into the router process when probing is enabled.
            from iterative_cleaner_tpu_torch.config import CleanConfig
            from iterative_cleaner_tpu_torch.io.npz import NpzIO
            from iterative_cleaner_tpu_torch.io.synthetic import make_archive

            if self.clean_cfg is None:
                # The oracle must be computed under the SAME cleaning
                # config the replicas serve (the cache-salt homogeneity
                # assumption); default-config fleets need no knob.
                self.clean_cfg = CleanConfig(backend="numpy", quiet=True,
                                             no_log=True)
            nsub, nchan, nbin = CANARY_SHAPE
            io = NpzIO()
            self._arch_a = make_archive(nsub=nsub, nchan=nchan, nbin=nbin,
                                        seed=_SEED_A)
            path_a = os.path.join(self.dir, "canary_a.npz")
            io.save(self._arch_a, path_a)
            self._path_b = os.path.join(self.dir, "canary_b.npz")
            io.save(make_archive(nsub=nsub, nchan=nchan, nbin=nbin,
                                 seed=_SEED_B), self._path_b)
            # Oracle masks from the round-tripped bytes (what replicas
            # will actually load), recomputed at every prepare so a
            # config change can never serve a stale stored answer.
            self._oracle_a = self._oracle(path_a)
            self._oracle_b = self._oracle(self._path_b)
            self._prepared = True

    def _oracle(self, path: str):
        """The numpy-oracle mask for one archive file, under the port's
        oracle replay config of the replicas' cleaning config."""
        from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
        from iterative_cleaner_tpu_torch.io.npz import NpzIO
        from iterative_cleaner_tpu_torch.models.surgical import finalize_weights
        from iterative_cleaner_tpu_torch.obs.audit import oracle_config
        from iterative_cleaner_tpu_torch.ops.preprocess import preprocess

        cfg = oracle_config(self.clean_cfg)
        w, _nbs, _nbc = finalize_weights(
            clean_cube(*preprocess(NpzIO().load(path)), cfg).weights, cfg)
        return w

    def _fresh_file(self) -> str:
        """Re-stamp the canary archive's source header with a nonce and
        rewrite it: new bytes (new cache digest) every round, identical
        mask (metadata never feeds the cleaner) — the fresh journey
        stays fresh without recomputing the oracle."""
        from iterative_cleaner_tpu_torch.io.npz import NpzIO

        path = os.path.join(self.dir, "canary_fresh.npz")
        stamped = replace(self._arch_a,
                          source=f"CANARY-{uuid.uuid4().hex[:12]}")
        NpzIO().save(stamped, path)
        return path

    # --- HTTP (the router's public surface; stdlib only) ---

    def _base(self) -> str:
        return str(self.base_url_fn()).rstrip("/")

    def _http(self, route: str, data: bytes | None = None,
              content_type: str = "application/json",
              timeout: float | None = None) -> dict:
        import json

        req = urllib.request.Request(
            self._base() + route, data=data,
            headers={"Content-Type": content_type} if data else {})
        try:
            with urllib.request.urlopen(
                    req, timeout=30.0 if timeout is None else timeout
                    ) as resp:
                reply = json.load(resp)
        except urllib.error.HTTPError as exc:
            try:
                detail = json.load(exc)
            except ValueError:
                detail = {"error": exc.reason}
            raise CanaryError(
                f"{route}: HTTP {exc.code}: {detail.get('error', '')!s}"
                ) from exc
        except (urllib.error.URLError, ConnectionError, TimeoutError,
                OSError, ValueError) as exc:
            raise CanaryError(f"{route}: {exc}") from exc
        if not isinstance(reply, dict):
            raise CanaryError(f"{route}: non-object JSON reply")
        return reply

    def _get(self, route: str) -> dict:
        return self._http(route)

    def _post(self, route: str, body: dict,
              timeout: float | None = None) -> dict:
        import json

        return self._http(route, data=json.dumps(body).encode(),
                          timeout=timeout)

    def _await(self, route: str, done, what: str) -> dict:
        deadline = time.monotonic() + self.timeout_s
        while True:
            view = self._get(route)
            if done(view):
                return view
            if time.monotonic() >= deadline:
                raise CanaryError(
                    f"{what} not terminal after {self.timeout_s:g}s "
                    f"(state {view.get('state')!r})")
            time.sleep(0.05)

    # --- verdict plumbing ---

    def _verify_against(self, out_path, oracle) -> bool | None:
        """Bit-identical mask check of one result file against the
        stored oracle answer; None when no result exists to check."""
        import numpy as np

        from iterative_cleaner_tpu_torch.io.npz import NpzIO

        if not out_path or not os.path.exists(str(out_path)):
            return None
        try:
            observed = NpzIO().load(str(out_path)).weights
        except Exception:  # noqa: BLE001 — a torn result file is "wrong"
            return False
        if self.corrupt_mask:
            observed = _flip_one(observed)
        return bool(np.array_equal(observed, oracle))

    def _hops(self, trace_id: str) -> dict | None:
        """Per-hop latency off the assembled trace (best-effort: a probe
        must never fail on forensics)."""
        if not trace_id:
            return None
        try:
            trace = self._get(f"/fleet/trace/{trace_id}")
        except CanaryError:
            return None
        return fleet_obs.span_hops(trace.get("spans") or [])

    def _verdict(self, journey: str, ok: bool, correct, latency_s: float,
                 trace_id: str = "", error: str = "",
                 **extra) -> dict:
        v = {"journey": journey, "ok": bool(ok), "correct": correct,
             "latency_s": round(latency_s, 6), "trace_id": trace_id,
             "error": error, "ts": round(time.time(), 3),
             "hops": self._hops(trace_id)}
        v.update(extra)
        slo = self.slo
        if slo is not None:
            slo.note_verdict(v)
        if correct is False and self.on_mask_mismatch is not None:
            self.on_mask_mismatch(v)
        return v

    # --- the journeys ---

    def _submit_probe(self, path: str, label: str) -> dict:
        return self._post("/jobs", {
            "path": path,
            "shape": list(CANARY_SHAPE),
            "synthetic": True,
            "tenant": SYNTHETIC_TENANT,
            "idempotency_key": f"canary-{label}-{uuid.uuid4().hex[:12]}",
        })

    def _journey_fresh(self, path: str) -> dict:
        t0 = time.monotonic()
        reply = self._submit_probe(path, "fresh")
        man = self._await(f"/jobs/{reply.get('id')}",
                          lambda v: v.get("state") in _TERMINAL,
                          "fresh canary job")
        latency = time.monotonic() - t0
        correct = self._verify_against(man.get("out_path"), self._oracle_a)
        ok = man.get("state") == "done" and correct is True
        return self._verdict(
            "fresh", ok, correct, latency,
            trace_id=str(reply.get("trace_id", "") or ""),
            error=str(man.get("error") or ""),
            job_id=str(reply.get("id", "")))

    def _journey_cache(self, path: str) -> dict:
        t0 = time.monotonic()
        reply = self._submit_probe(path, "cache")
        born_terminal = reply.get("state") in _TERMINAL
        man = (reply if born_terminal else
               self._await(f"/jobs/{reply.get('id')}",
                           lambda v: v.get("state") in _TERMINAL,
                           "cache canary job"))
        latency = time.monotonic() - t0
        correct = self._verify_against(man.get("out_path"), self._oracle_a)
        # The journey's contract is the reuse tier itself: a resubmit
        # that quietly recleans is a broken cache plane even though the
        # mask would come back right.
        hit = (reply.get("served_by") == "fleet-cache") and born_terminal
        ok = hit and man.get("state") == "done" and correct is True
        return self._verdict(
            "cache", ok, correct, latency,
            trace_id=str(reply.get("trace_id", "") or ""),
            error="" if hit else "resubmit missed the fleet cache",
            job_id=str(reply.get("id", "")), cache_hit=hit)

    def _journey_session(self) -> dict:
        from iterative_cleaner_tpu_torch.online.blocks import encode_block
        from iterative_cleaner_tpu_torch.online.state import SessionMeta

        arch = self._arch_a
        t0 = time.monotonic()
        opened = self._post("/sessions",
                            SessionMeta.from_archive(arch).to_dict())
        sid = str(opened.get("id", ""))
        if not sid:
            raise CanaryError("session open returned no id")
        for i in range(arch.data.shape[0]):
            self._http(f"/sessions/{sid}/blocks",
                       data=encode_block(arch.data[i:i + 1],
                                         arch.weights[i:i + 1]),
                       content_type="application/octet-stream")
        # Finish runs the replica's finalize (which may build the kernels
        # under the torch backend) — give it the full round budget, not the default
        # per-call timeout.
        fin = self._post(f"/sessions/{sid}/finish", {},
                         timeout=self.timeout_s)
        latency = time.monotonic() - t0
        correct = self._verify_against(fin.get("out_path"), self._oracle_a)
        ok = fin.get("state") == "done" and correct is True
        return self._verdict(
            "session", ok, correct, latency,
            trace_id=str(opened.get("trace_id", "") or ""),
            session_id=sid, blocks=int(arch.data.shape[0]))

    def _journey_campaign(self, fresh_path: str) -> dict:
        t0 = time.monotonic()
        created = self._post("/campaigns", {
            "name": f"canary-{uuid.uuid4().hex[:8]}",
            "tenant": SYNTHETIC_TENANT,
            "synthetic": True,
            "archives": [fresh_path, self._path_b],
            "max_inflight": 2,
        })
        cid = str(created.get("id", ""))
        if not cid:
            raise CanaryError("campaign create returned no id")
        view = self._await(f"/campaigns/{cid}",
                           lambda v: v.get("state") in
                           ("done", "failed", "cancelled"),
                           f"canary campaign {cid}")
        latency = time.monotonic() - t0
        oracles = {fresh_path: self._oracle_a, self._path_b: self._oracle_b}
        checks = [self._verify_against(
                      rec.get("out_path"), oracles.get(rec.get("path")))
                  for rec in view.get("archive_records") or []]
        correct = (None if not checks or any(c is None for c in checks)
                   else all(checks))
        ok = view.get("state") == "done" and correct is True
        return self._verdict("campaign", ok, correct, latency,
                             campaign_id=cid, archives=len(checks))

    # --- rounds ---

    def run_round(self) -> list[dict]:
        """One full probe round, synchronously: all four journeys in
        order (cache depends on fresh's entry being learned).  A journey
        that raises records a failed verdict and the round continues —
        one broken journey must not blind the other three."""
        self._ensure_prepared()
        with self._lock:
            self._rounds += 1
        fresh_path = self._fresh_file()
        verdicts = []
        for journey, fn in (("fresh",
                             lambda: self._journey_fresh(fresh_path)),
                            ("cache",
                             lambda: self._journey_cache(fresh_path)),
                            ("session", self._journey_session),
                            ("campaign",
                             lambda: self._journey_campaign(fresh_path))):
            t0 = time.monotonic()
            try:
                verdicts.append(fn())
            except Exception as exc:  # noqa: BLE001 — the verdict IS the
                # error report; the prober itself must survive anything
                # the fleet does to it.
                verdicts.append(self._verdict(
                    journey, False, None, time.monotonic() - t0,
                    error=f"{type(exc).__name__}: {exc}"))
        return verdicts

    def maybe_start(self) -> bool:
        """Kick one probe round on the dedicated canary thread unless a
        round is still in flight (a slow fleet gets measured as slow, it
        does not accumulate a thread pileup).  Returns whether a round
        was started.  Called from the router's poll tick — never blocks,
        never holds the router lock."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return False
            t = threading.Thread(target=self._round_guarded,
                                 name="ict-fleet-canary", daemon=True)
            self._thread = t
        t.start()
        return True

    def _round_guarded(self) -> None:
        try:
            self.run_round()
        except Exception:  # noqa: BLE001 — run_round already folds
            # per-journey failures into verdicts; anything else here is
            # corpus preparation, and the next tick retries it.
            pass

    def rounds(self) -> int:
        with self._lock:
            return self._rounds

    def busy(self) -> bool:
        with self._lock:
            return self._thread is not None and self._thread.is_alive()
