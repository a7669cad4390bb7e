"""Oracle parity auditing + divergence repro bundles.

A port of ``iterative_cleaner_tpu/obs/audit.py:1-346``.  The repo's
load-bearing invariant — flag masks bit-identical to the numpy oracle on
every route — is checked offline by the tests; this module checks it on a
real run:

- :func:`run_audit` replays one finished clean's inputs through the port's
  copy of the numpy oracle and compares: masks bit-for-bit (any difference
  is a **divergence**), float scores against the documented ~5e-5
  unit-floored envelope (:data:`AUDIT_DRIFT_BOUND`).  Results land in the
  :mod:`.tracing` registries (``audit_*``, with a per-route drift
  histogram) and in a JSON-safe record with the JAX package's keys.
- :func:`write_repro_bundle` captures everything a divergence needs to be
  re-run anywhere — input cube npz, config, versions, trace context,
  flight-ring dump — as one directory (the CLI's ``--audit`` writes it
  under :func:`default_repro_dir`).  The bundle has the JAX writer's file
  set and manifest keys; its ``config`` is the port's ``CleanConfig``.

- :class:`ShadowAuditor` is the serving daemon's background auditor: the
  dispatch worker offers finished jobs, sampled by :func:`should_audit` at
  :func:`audit_rate` (``ICT_AUDIT_RATE`` / ``serve --audit_rate``) or asked
  for per job (``{"audit": true}``), and one thread replays them on the
  host.

Strictly read-only on the math: the audit replays the inputs after the
clean already produced its result.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import platform
import queue
import random
import sys
import threading
import time
import uuid

import numpy as np

from iterative_cleaner_tpu_torch.obs import events, flight, tracing

#: The documented score-drift envelope: float scores may differ from the
#: oracle's by a few ulps — up to ~5e-5 unit-floored relative — on the
#: incremental-template and chunked routes; masks are bit-identical
#: everywhere.
AUDIT_DRIFT_BOUND = 5e-5

#: Cumulative drift histogram bounds (``le`` labels on
#: ``audit_drift_total{route=...}``); the last finite bound is the
#: envelope, so "beyond the bound" is the +Inf-minus-last-bucket residue.
DRIFT_BOUNDS: tuple[float, ...] = (0.0, 1e-7, 1e-6, 1e-5, AUDIT_DRIFT_BOUND)

#: Repro bundles kept per directory (oldest swept): a route that diverges
#: systematically must not fill the disk with one cube-sized bundle per run.
MAX_BUNDLES_KEPT = 20

#: Mask-difference coordinates recorded verbatim on the audit record.
MAX_DIFF_COORDS = 16


def audit_rate(default: float = 0.0) -> float:
    """The sampling fraction from ``ICT_AUDIT_RATE``, clamped to [0, 1]
    (0, the default, samples nothing; ``--audit`` always audits)."""
    env = os.environ.get("ICT_AUDIT_RATE")
    if env is None:
        return default
    try:
        val = float(env)
    except ValueError:
        print(f"warning: ignoring unparseable ICT_AUDIT_RATE={env!r} "
              "(want a fraction in [0, 1])", file=sys.stderr)
        return default
    return min(max(val, 0.0), 1.0)


def should_audit(requested: bool, rate: float) -> bool:
    """Per-job opt-in always audits; otherwise sample at ``rate``."""
    if requested:
        return True
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    return random.random() < rate


def oracle_config(cfg):
    """The numpy-oracle replay config for ``cfg``: same algorithm
    parameters, the torch-only routing fields reset (CleanConfig rejects
    them with backend='numpy'), and ``audit`` off so a replay can never
    recurse."""
    return cfg.replace(backend="numpy", fused=False, kernel=None,
                       sharded_batch=False, stream=False, chunk_block=0,
                       audit=False)


def run_audit(D, w0, cfg, weights_served, scores_served=None, route="",
              oracle_result=None):
    """Replay one clean through the numpy oracle and compare.

    ``weights_served`` is the FINAL mask the caller emitted (bad-parts
    sweep included; the oracle side runs the same sweep);
    ``scores_served`` the route's last-iteration scores, or None to skip
    the drift check.  ``oracle_result`` lets a caller that already ran the
    oracle skip the replay.

    Returns ``(record, oracle_weights)``.  Counters: ``audit_runs``
    always, ``audit_divergences`` + the ``audit_last_divergence_ts`` gauge
    on a mask mismatch, ``audit_drift_exceeded`` on scores beyond the
    bound, and one ``audit_drift_total{route,le}`` histogram observation.
    """
    from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
    from iterative_cleaner_tpu_torch.models.surgical import finalize_weights

    t0 = time.perf_counter()
    cfg_np = oracle_config(cfg)
    res_np = oracle_result
    if res_np is None:
        res_np = clean_cube(np.asarray(D), np.asarray(w0), cfg_np)
    oracle_w, _nbs, _nbc = finalize_weights(res_np.weights, cfg_np)

    served = np.asarray(weights_served)
    diff = served != oracle_w
    n_diffs = int(diff.sum())
    record: dict = {
        "ts": round(time.time(), 3),
        "route": route,
        "mask_identical": n_diffs == 0,
        "n_mask_diffs": n_diffs,
        "oracle_loops": int(res_np.loops),
        "drift_bound": AUDIT_DRIFT_BOUND,
    }
    if n_diffs:
        coords = np.argwhere(diff)[:MAX_DIFF_COORDS]
        record["mask_diff_coords"] = [[int(i), int(j)] for i, j in coords]

    max_rel = None
    finite_mismatch = 0
    if scores_served is not None and res_np.test_results is not None:
        a = np.asarray(scores_served, np.float64)
        b = np.asarray(res_np.test_results, np.float64)
        fin = np.isfinite(a) & np.isfinite(b)
        # A score finite on one side and not the other is a structural
        # disagreement no tolerance covers: counted, and it fails the bound.
        finite_mismatch = int(np.sum(np.isfinite(a) != np.isfinite(b)))
        max_rel = 0.0
        if fin.any():
            # Unit-floored drift: relative above |score| = 1, absolute
            # below it (scores are threshold-scaled: a zap fires at 1).
            max_rel = float(np.max(np.abs(a[fin] - b[fin])
                                   / np.maximum(np.abs(b[fin]), 1.0)))
        record["max_score_drift"] = max_rel
        record["score_finite_mismatch"] = finite_mismatch
    within = (finite_mismatch == 0
              and (max_rel is None or max_rel <= AUDIT_DRIFT_BOUND))
    record["drift_within_bound"] = within
    record["duration_s"] = round(time.perf_counter() - t0, 3)

    tracing.count("audit_runs")
    if max_rel is not None:
        route_lbl = route or "unknown"
        for bound in DRIFT_BOUNDS:
            if max_rel <= bound:
                tracing.count_labeled(
                    "audit_drift_total",
                    {"route": route_lbl, "le": repr(float(bound))})
        tracing.count_labeled("audit_drift_total",
                              {"route": route_lbl, "le": "+Inf"})
    if not within:
        tracing.count("audit_drift_exceeded")
    if n_diffs:
        tracing.count("audit_divergences")
        tracing.set_gauge("audit_last_divergence_ts", time.time())
    return record, oracle_w


def audit_report() -> dict:
    """The cumulative audit counters as one JSON block."""
    snap = tracing.counters_snapshot()
    gauges, _ = tracing.gauges_snapshot()
    return {
        "rate": audit_rate(),
        "audits_run": int(snap.get("audit_runs", 0)),
        "divergences": int(snap.get("audit_divergences", 0)),
        "drift_exceeded": int(snap.get("audit_drift_exceeded", 0)),
        "skipped": int(snap.get("audit_skipped", 0)),
        "last_divergence_ts": float(
            gauges.get("audit_last_divergence_ts", 0.0)),
    }


# --- divergence repro bundles ---


def default_repro_dir() -> str:
    """Bundle directory of the CLI's ``--audit``: ``ICT_REPRO_DIR``, else
    ``./ict_repro``."""
    return os.environ.get("ICT_REPRO_DIR") or "./ict_repro"


def write_repro_bundle(directory: str, *, D, w0, cfg, reason: str,
                       weights_served=None, weights_oracle=None,
                       scores_served=None, trace_id: str = "",
                       job_id: str = "", route: str = "",
                       record: dict | None = None) -> str | None:
    """Write one self-contained divergence bundle under ``directory``.

    Layout: ``repro-<unixms>-<hex6>/`` holding ``arrays.npz`` (the input
    cube + weights, plus whatever masks/scores the caller has),
    ``manifest.json`` (reason, config, versions, trace context, the audit
    record), and ``flight.json`` (the flight ring at write time).  Built
    under a ``.part`` name and renamed, so a half-written bundle is never
    taken for a replayable one; bundles beyond :data:`MAX_BUNDLES_KEPT`
    are swept.  Returns the bundle path, or None on failure — a forensics
    aid must never become a second failure."""
    try:
        os.makedirs(directory, exist_ok=True)
        name = f"repro-{int(time.time() * 1000):013d}-{uuid.uuid4().hex[:6]}"
        final = os.path.join(directory, name)
        tmp = f"{final}.part"
        os.makedirs(tmp)
        arrays = {"D": np.asarray(D), "w0": np.asarray(w0)}
        if weights_served is not None:
            arrays["weights_served"] = np.asarray(weights_served)
        if weights_oracle is not None:
            arrays["weights_oracle"] = np.asarray(weights_oracle)
        if scores_served is not None:
            arrays["scores_served"] = np.asarray(scores_served)
        np.savez_compressed(os.path.join(tmp, "arrays.npz"), **arrays)
        torch_mod = sys.modules.get("torch")
        from iterative_cleaner_tpu_torch import __version__

        manifest = {
            "reason": reason,
            "ts": round(time.time(), 6),
            "pid": os.getpid(),
            "trace_id": trace_id,
            "job_id": job_id,
            "route": route,
            "config": dataclasses.asdict(cfg),
            "arrays": sorted(arrays),
            "record": record or {},
            "versions": {
                "iterative_cleaner_tpu_torch": __version__,
                "numpy": np.__version__,
                "torch": getattr(torch_mod, "__version__", None),
                "cuda": getattr(getattr(torch_mod, "version", None), "cuda", None),
                "python": platform.python_version(),
            },
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as fh:
            json.dump(manifest, fh, indent=1, default=str)
            fh.write("\n")
        with open(os.path.join(tmp, "flight.json"), "w") as fh:
            json.dump({"events": flight.snapshot()}, fh, indent=1)
            fh.write("\n")
        os.replace(tmp, final)
        bundles = sorted(n for n in os.listdir(directory)
                         if n.startswith("repro-")
                         and not n.endswith(".part"))
        for old in bundles[:-MAX_BUNDLES_KEPT]:
            _rmtree_quiet(os.path.join(directory, old))
        return final
    except Exception:  # noqa: BLE001 — best-effort by contract
        return None


def _rmtree_quiet(path: str) -> None:
    import shutil

    try:
        shutil.rmtree(path)
    except OSError:
        pass


def load_repro_bundle(path: str) -> tuple[dict, dict]:
    """Read a bundle back: ``(manifest, arrays)``.  Raises on a missing or
    malformed bundle."""
    with open(os.path.join(path, "manifest.json")) as fh:
        manifest = json.load(fh)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    return manifest, arrays


def config_from_manifest(manifest: dict):
    """Rebuild the CleanConfig a bundle recorded (unknown keys dropped, so
    an old bundle replays on a newer tree)."""
    from iterative_cleaner_tpu_torch.config import CleanConfig

    raw = manifest.get("config") or {}
    known = {f.name for f in dataclasses.fields(CleanConfig)}
    return CleanConfig(**{k: v for k, v in raw.items() if k in known})


def list_bundles(directory: str) -> list[dict]:
    """Bundle inventory (name / path / reason / ts / job_id / route)."""
    out = []
    try:
        names = sorted(n for n in os.listdir(directory)
                       if n.startswith("repro-") and not n.endswith(".part"))
    except OSError:
        return out
    for name in names:
        entry = {"name": name, "path": os.path.join(directory, name)}
        try:
            with open(os.path.join(directory, name, "manifest.json")) as fh:
                m = json.load(fh)
            entry.update(reason=m.get("reason"), ts=m.get("ts"),
                         job_id=m.get("job_id"), route=m.get("route"))
        except (OSError, ValueError):
            entry["reason"] = "unreadable manifest"
        out.append(entry)
    return out


_STOP = object()


# --- the serving daemon's background auditor ---


class ShadowAuditor(threading.Thread):
    """Low-priority shadow-oracle replay thread for the serving daemon.

    The dispatch worker offers completed jobs (with their already-decoded
    cubes) via :meth:`submit`; the queue is small and non-blocking — under
    load, audits are *sampled down* by back-pressure (``audit_skipped``
    counts the drops) instead of pinning cube-sized arrays or delaying
    the dispatch thread.  One replay at a time, pure numpy on host: the
    device never sees an audit.
    """

    def __init__(self, spool, repro_dir: str, on_divergence=None,
                 quiet: bool = False, queue_max: int = 8) -> None:
        super().__init__(daemon=True, name="ict-audit")
        self.spool = spool
        self.repro_dir = repro_dir
        self.on_divergence = on_divergence
        self.quiet = quiet
        self._q: queue.Queue = queue.Queue(maxsize=queue_max)
        self._recent: collections.deque = collections.deque(maxlen=20)
        # Accepted-but-unfinished count, incremented BEFORE the enqueue
        # and decremented only after the audit completes: drain() keys off
        # this, not queue emptiness, so the instant between a dequeue and
        # the audit starting can never read as "idle".
        self._outstanding = 0  # ict: guarded-by(self._lock)
        self._lock = threading.Lock()
        self._stop_evt = threading.Event()

    def submit(self, job, D, w0, weights, scores, served_by: str,
               clean_cfg) -> bool:
        """Queue one completed job for auditing; False (and a counted
        skip) when the queue is full."""
        with self._lock:
            self._outstanding += 1
        try:
            self._q.put_nowait((job, np.asarray(D), np.asarray(w0),
                                np.asarray(weights), scores, served_by,
                                clean_cfg))
            return True
        except queue.Full:
            with self._lock:
                self._outstanding -= 1
            tracing.count("audit_skipped")
            return False

    def queue_depth(self) -> int:
        return self._q.qsize()

    def stop(self) -> None:
        """Non-blocking: a full audit queue must not stall the daemon's
        graceful stop behind a cube-sized oracle replay — queued audits
        are abandoned (the jobs already served their results)."""
        self._stop_evt.set()
        try:
            self._q.put_nowait(_STOP)
        except queue.Full:
            pass  # run() checks the event on every dequeued item

    def drain(self, timeout_s: float = 60.0) -> bool:
        """Block until every accepted audit has finished (tests, the smoke
        check); True on success, False on timeout."""
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            with self._lock:
                if self._outstanding == 0:
                    return True
            time.sleep(0.02)
        return False

    def recent(self) -> list[dict]:
        with self._lock:
            return list(self._recent)

    def run(self) -> None:
        while True:
            item = self._q.get()
            if item is _STOP or self._stop_evt.is_set():
                # Abandon whatever is still queued (stop() may not have
                # fit its sentinel into a full queue) and keep the
                # outstanding count honest on the way out.
                with self._lock:
                    if item is not _STOP:
                        self._outstanding -= 1
                    while True:
                        try:
                            nxt = self._q.get_nowait()
                        except queue.Empty:
                            break
                        if nxt is not _STOP:
                            self._outstanding -= 1
                return
            try:
                self._audit_one(*item)
            except Exception as exc:  # noqa: BLE001 — the thread must live
                tracing.count("audit_errors")
                if not self.quiet:
                    print(f"ict-serve: shadow audit failed: {exc}",
                          file=sys.stderr)
            finally:
                with self._lock:
                    self._outstanding -= 1

    def _audit_one(self, job, D, w0, weights, scores, served_by,
                   clean_cfg) -> None:
        with events.trace_scope(job.trace_id), tracing.phase("service_audit"):
            record, oracle_w = run_audit(
                D, w0, clean_cfg, weights, scores_served=scores,
                route=served_by)
        record["job_id"] = job.id
        bundle = None
        if not record["mask_identical"]:
            bundle = write_repro_bundle(
                self.repro_dir, D=D, w0=w0, cfg=clean_cfg,
                reason=f"shadow-audit divergence: job {job.id} "
                       f"(route {served_by})",
                weights_served=weights, weights_oracle=oracle_w,
                scores_served=scores, trace_id=job.trace_id,
                job_id=job.id, route=served_by, record=record)
            record["bundle"] = bundle
            if events.active():
                events.emit("audit_divergence", trace_id=job.trace_id,
                            job_id=job.id, route=served_by,
                            n_mask_diffs=record["n_mask_diffs"],
                            bundle=bundle or "")
            print(f"ict-serve: AUDIT DIVERGENCE job {job.id} "
                  f"(route {served_by}): {record['n_mask_diffs']} mask "
                  f"bit(s) differ from the numpy oracle"
                  + (f"; repro bundle at {bundle}" if bundle else ""),
                  file=sys.stderr)
        elif events.active():
            events.emit("audit_done", trace_id=job.trace_id, job_id=job.id,
                        route=served_by,
                        drift_within_bound=record["drift_within_bound"])
        with self._lock:
            self._recent.append(record)
        job.audit_result = record
        # Re-persist the manifest only once the worker's own terminal save
        # happened (the worker queues the audit just BEFORE that save): a
        # save here with state still "running" could win the race and
        # leave a served job looking unfinished to a restart replay.  The
        # worker's transition is microseconds away, so the wait is
        # bounded-short and normally zero iterations.
        from iterative_cleaner_tpu_torch.service.jobs import TERMINAL

        deadline = time.time() + 5.0
        while job.state not in TERMINAL and time.time() < deadline:
            time.sleep(0.005)
        if job.state in TERMINAL:
            try:
                self.spool.save(job)
            except Exception:  # noqa: BLE001 — the job already served
                pass
        # Escalation keys off the CONFIRMED divergence, never off the
        # bundle write succeeding: a full spool disk (likely exactly when
        # a route diverges repeatedly — each bundle holds a cube) must not
        # keep a wrong-mask route in service.
        if not record["mask_identical"] and self.on_divergence is not None:
            self.on_divergence(record)
