"""Dispatch worker: fault-isolated execution of flushed shape buckets.

A port of ``iterative_cleaner_tpu/service/worker.py``.  A bucket goes
through the port's ``parallel/batch._finish_bucket`` and ``sharded_clean``
(one ``batched_fused_clean`` dispatch on the card, launching
``fused_fit_moments`` over the archive axis and ``ordered_template`` with
its archive strides); the cost record's static figures come from the
port's cost model (``obs/memory.analyze_batch_route``) and its compile
seconds from the ``nvcc`` kernel builds (``kernel_build_s``).

One thread runs the buckets (they serialize on the card anyway); the
loader threads and the HTTP server stay responsive while it runs.  The
worker is constructed purely from a :class:`~.context.ReplicaContext`, so
fleet tests run several workers in one process without shared state.  The
failure ladder, top to bottom:

1. a job whose archive fails to DECODE never reaches this worker — the
   loader marks it ``error`` alone (the parallel/batch isolation rule);
2. a sharded bucket dispatch that throws is retried with full-jitter
   exponential backoff (``dispatch_retries`` / ``retry_backoff_s``,
   utils/backoff.py — jittered so replicas recovering together don't
   thundering-herd the spool);
3. retries exhausted: every still-unfinished job in the bucket degrades to
   the numpy ORACLE backend, individually — slower, but masks are the
   oracle's by definition, and one poisoned cube cannot take its bucket
   siblings down;
4. repeated bucket failures demote the whole replica to oracle mode
   (context.note_dispatch_failure).

Rungs 3 and 4 are the JAX daemon's, kept for ``--device cpu``.  A
replica on the card (``ctx.on_card``) stops at rung 2: the bucket's
unfinished jobs fail with the dispatch's error, and the replica keeps
its backend, so a kernel that does not build or launch shows as failed
jobs and never as masks the plain route served.
"""

from __future__ import annotations

import dataclasses
import queue
import sys
import threading
import time

import numpy as np

from iterative_cleaner_tpu_torch.obs import (
    audit as obs_audit,
    costs as obs_costs,
    events,
    flight,
    forensics,
    memory as obs_memory,
    profiling,
    quality as obs_quality,
    tracing,
)
from iterative_cleaner_tpu_torch.service.jobs import TERMINAL, Job
from iterative_cleaner_tpu_torch.service.scheduler import Entry, bucket_label
from iterative_cleaner_tpu_torch.utils import backoff

_STOP = object()


class DispatchWorker(threading.Thread):
    """Consumes entry groups (same-shape buckets) from the scheduler."""

    def __init__(self, ctx) -> None:
        super().__init__(daemon=True,
                         name=f"ict-serve-dispatch-{ctx.replica_id}")
        self.ctx = ctx
        self._q: queue.Queue = queue.Queue()

    def submit(self, entries: list[Entry]) -> None:
        self._q.put(entries)

    def queue_depth(self) -> int:
        """Flushed-but-undispatched bucket count (the /healthz drain view)."""
        return self._q.qsize()

    def stop(self) -> None:
        self._q.put(_STOP)

    def run(self) -> None:
        while True:
            item = self._q.get()
            if item is _STOP:
                return
            try:
                self._dispatch(item)
            except Exception as exc:  # noqa: BLE001 — the thread must live
                for e in item:
                    if e.job.state not in TERMINAL:
                        self._fail(e.job, f"dispatch worker error: {exc}")

    # --- the failure ladder ---

    def _dispatch(self, entries: list[Entry]) -> None:
        ctx = self.ctx
        # The content-cache rung runs FIRST: a cube whose bytes + config
        # hash to a known key is served from the cached mask — the
        # sibling misses still share one coalesced dispatch below.
        entries = self._serve_cached(entries)
        if not entries:
            return
        for e in entries:
            e.job.state = "running"
            ctx.spool.save(e.job)
            if events.active():
                events.emit("dispatch", trace_id=e.job.trace_id,
                            job_id=e.job.id, bucket_size=len(entries),
                            backend=ctx.backend_mode)
        # Per-job profiler capture (obs/profiling): requested at submit
        # time, taken around this bucket's whole dispatch (device work is
        # bucket-granular — the capture necessarily covers the siblings
        # too, which the artifact dir's job tag makes plain).  Skipped
        # silently when the profiler is busy with an operator capture.
        want_profile = [e for e in entries if e.job.profile]
        with profiling.maybe_capture(
                ctx.profile_root,
                tag=want_profile[0].job.id if want_profile else "",
                want=bool(want_profile), device=ctx.device) as profile_dir:
            if profile_dir:
                for e in want_profile:
                    e.job.profile_dir = profile_dir
            self._dispatch_routed(entries)

    def _serve_cached(self, entries: list[Entry]) -> list[Entry]:
        """Content-addressed reuse (service/results_cache.py, keys from
        ingest/cas.py): serve every entry whose cube key has a cached
        mask — byte-identical to a fresh clean by construction (the key
        covers cube bytes + config + code version) with zero device
        work — and return the misses for the coalesced dispatch.  A hit
        is only shadow-audited on explicit request (``{"audit": true}``
        replays the oracle against the cached mask); sampled audits stay
        on the freshly-cleaned routes."""
        ctx = self.ctx
        if not ctx.result_cache.enabled:
            return entries
        misses: list[Entry] = []
        for e in entries:
            if e.job.state in TERMINAL:
                continue
            bucket = bucket_label(e.D.shape)
            rec = (ctx.result_cache.get(e.job.content_key)
                   if e.job.content_key else None)
            if rec is None:
                tracing.count("service_result_cache_misses")
                tracing.count_labeled("result_cache_total",
                                      {"outcome": "miss",
                                       "shape_bucket": bucket})
                misses.append(e)
                continue
            e.job.state = "running"
            ctx.spool.save(e.job)
            tracing.count("service_result_cache_hits")
            tracing.count_labeled("result_cache_total",
                                  {"outcome": "hit",
                                   "shape_bucket": bucket})
            # Bytes that never crossed to (or through) a device because
            # of this hit — the campaign-dedupe savings figure.
            tracing.count("service_result_cache_bytes_saved",
                          float(e.D.nbytes))
            if events.active():
                events.emit("dispatch", trace_id=e.job.trace_id,
                            job_id=e.job.id, bucket_size=1,
                            backend="cache",
                            origin_job_id=rec.get("origin_job_id", ""))
            # Cost accounting (obs/costs): a hit consumes no device time;
            # the avoided cost is the ORIGIN job's recorded figures (its
            # manifest outlives retire() in the spool; a pruned origin
            # just reads as zero avoided cost, never a guess).  The one
            # manifest read is noise next to the archive decode this hit
            # already paid in the loader.
            origin_id = str(rec.get("origin_job_id", "") or "")
            origin = ctx.spool.get(origin_id) if origin_id else None
            obs_costs.add_cache_hit(
                e.job, origin.cost if origin is not None else None)
            t0c = time.perf_counter()
            try:
                with tracing.phase("service_cache_emit"):
                    self._emit(e, rec["weights"], rec["loops"],
                               rec["converged"], rec["rfi_frac"], "cache",
                               termination=rec.get("termination") or "")
            except Exception as exc:  # noqa: BLE001 — isolate the one job
                self._fail(e.job, f"cache-hit emission failed: {exc}")
            finally:
                self._record_cost(e.job, phases={
                    "cache_emit": time.perf_counter() - t0c})
        return misses

    def _record_cost(self, job, phases: dict | None = None) -> None:
        """Finalize one TERMINAL job's CostRecord exactly once: stamp the
        trailing phase seconds, fold it into the replica ledger (which
        renders the ``ict_cost_*`` counters the fleet federates), and
        re-persist the manifest so the record rides it (the exec_analysis
        re-persist pattern — the terminal save already happened).  A job
        that is still open (mid-retry) is skipped; its accumulators keep
        growing until the attempt that finishes it."""
        if job.state not in TERMINAL or getattr(job, "_cost_recorded",
                                                False):
            return
        for phase, dt in (phases or {}).items():
            if dt:
                obs_costs.add_phase(job, phase, dt)
        obs_costs.finalize(job)
        job._cost_recorded = True
        try:
            self.ctx.cost_ledger.record(job.cost)
            self.ctx.spool.save(job)
        except Exception:  # noqa: BLE001 — accounting must not fail a
            pass           # job that already served its result

    def _dispatch_routed(self, entries: list[Entry]) -> None:
        ctx = self.ctx
        if ctx.backend_mode == "torch":
            err = self._try_sharded(entries)
            if err is None:
                return
            if ctx.on_card:
                flight.dump(f"dispatch_failed: {err}", ctx.flight_dir)
                for e in entries:
                    if e.job.state not in TERMINAL:
                        self._fail(e.job, "sharded dispatch failed after "
                                   f"{e.job.attempts} attempt(s): {err}")
                        self._record_cost(e.job)
                return
            tracing.count("service_oracle_fallbacks")
            # A fault-ladder trip is exactly the moment the flight ring
            # exists for: persist what the daemon was doing (dispatches,
            # phase timings, retries) next to the spool.
            flight.dump(f"oracle_fallback: {err}", ctx.flight_dir)
            print(f"ict-serve: sharded dispatch failed after retries ({err}); "
                  f"serving {len(entries)} job(s) via the numpy oracle",
                  file=sys.stderr)
        # "oracle" = the configured numpy route; "oracle-fallback" = the
        # degraded one — an intentionally-numpy deployment must not raise
        # permanent fallback alarms.
        label = ("oracle" if ctx.clean_cfg.backend == "numpy"
                 else "oracle-fallback")
        for e in entries:
            if e.job.state not in TERMINAL:
                self._clean_oracle(e, label)

    def _try_sharded(self, entries: list[Entry]):
        """Bounded retry around one bucket dispatch; returns the final
        exception, or None on success.  Retry delays draw full jitter
        from the replica's private RNG (utils/backoff.py) so N replicas
        recovering from the same incident spread their re-contacts
        instead of herding — deterministic under ICT_BACKOFF_SEED."""
        ctx = self.ctx
        last = None
        for attempt in range(1 + ctx.serve_cfg.dispatch_retries):
            live = [e for e in entries if e.job.state not in TERMINAL]
            if not live:
                return None
            if attempt:
                tracing.count("service_dispatch_retries")
                time.sleep(backoff.full_jitter(
                    ctx.serve_cfg.retry_backoff_s, attempt - 1,
                    rng=ctx.backoff_rng))
            for e in live:
                e.job.attempts += 1
            try:
                self._dispatch_sharded(live)
                ctx.note_dispatch_ok()
                return None
            except Exception as exc:  # noqa: BLE001 — retried, then degraded
                last = exc
        ctx.note_dispatch_failure(last)
        return last

    def _dispatch_sharded(self, entries: list[Entry]) -> None:
        """One bucket on the card — literally the directory-batch
        dispatcher (_finish_bucket: the batched dispatch, bad-parts sweep,
        per-item emission), fed from the admission queue instead of a
        directory listing.  The cubes go over as a list: the batch is
        stacked once, on the card."""
        from iterative_cleaner_tpu_torch.parallel.batch import (
            BatchItem,
            _finish_bucket,
        )

        ctx = self.ctx
        items = [BatchItem(path=e.job.path, archive=e.archive)
                 for e in entries]
        batch_shape = (len(entries), *np.shape(entries[0].D))
        # Coalescing accounting (the throughput-tier rung): the realized
        # batch size per shape bucket, as a low-cardinality labeled
        # counter (k is pow2-bounded by the scheduler, O(log cap) values
        # per shape) — federated into /fleet/metrics, rendered as a
        # per-bucket batch-size p50.
        tracing.count_labeled("coalesce_batch_size_total",
                              {"shape_bucket": bucket_label(batch_shape[1:]),
                               "k": str(len(entries))})
        if len(entries) > 1:
            tracing.count("service_coalesced_dispatches")
            tracing.count("service_coalesced_jobs", float(len(entries)))

        emit_s = [0.0]

        def on_item(i, item) -> None:
            # Emission failures are per-job: they must neither abort the
            # bucket loop for the sibling jobs nor read as a (retryable)
            # dispatch failure.
            t0 = time.perf_counter()
            try:
                if item.error is not None:
                    # _finish_bucket refused the archive (one alone does
                    # not fit the card): a per-job failure, not a retry.
                    raise RuntimeError(item.error)
                self._emit(entries[i], item.weights, item.loops,
                           item.converged, item.rfi_frac, "sharded",
                           iterations=item.iterations,
                           termination=item.termination,
                           emit_iteration_events=True,
                           scores=item.test_results)
            except Exception as exc:  # noqa: BLE001 — isolate the one job
                self._fail(entries[i].job, f"output emission failed: {exc}")
            finally:
                dt = time.perf_counter() - t0
                emit_s[0] += dt
                tracing.observe_phase("service_emit", dt)
                obs_costs.add_phase(entries[i].job, "emit", dt)

        # Compile-accounting baseline for this dispatch's cost
        # attribution: any kernel build the window pays (nvcc runs
        # synchronously on this thread at first use) is apportioned
        # across the bucket's member jobs.  Best-effort in multi-replica
        # single-process tests (the counters are process-global); exact in
        # the one-replica-per-process production layout.
        compile_before = tracing.counters_snapshot().get(
            "kernel_build_s", 0.0)
        t0 = time.perf_counter()
        ok = False
        try:
            _finish_bucket(items, list(range(len(items))),
                           [e.D for e in entries], [e.w0 for e in entries],
                           ctx.clean_cfg, ctx.mesh, on_item=on_item,
                           # The per-job iteration timeline (GET /jobs/<id>/
                           # trace) costs a history fetch per bucket; pay it
                           # only when the operator turned forensics on.
                           want_history=forensics.timeline_enabled())
            ok = True
        finally:
            # _finish_bucket calls on_item inline, so subtract the emission
            # seconds: the per-stage means (_s/_n) must not double-count
            # I/O time as device-dispatch time.  try/finally so FAILED
            # dispatches count too (tracing.phase's rule) — a backend
            # incident must not make the mean dispatch latency look healthy,
            # and error=True makes the failure RATE visible on /metrics
            # (service_dispatch_err_n — the fallback-ladder alarm).
            dispatch_s = time.perf_counter() - t0 - emit_s[0]
            tracing.observe_phase("service_dispatch", dispatch_s,
                                  error=not ok)
            # Cost attribution (obs/costs): the EXACT seconds the line
            # above recorded, split equally across the bucket's member
            # jobs — failed attempts included, so the per-replica
            # conservation invariant (Σ attributed device-seconds ==
            # Δict_service_dispatch_s) holds by construction.
            compile_s = max(tracing.counters_snapshot().get(
                "kernel_build_s", 0.0) - compile_before, 0.0)
            obs_costs.add_dispatch_share([e.job for e in entries],
                                         dispatch_s, compile_s)
            if not ok:
                # A raised dispatch can still have emitted some items
                # terminal (a partial-emission edge): record those NOW —
                # the retry drops them from `live`, so the success path
                # below would never see them again.
                for e in entries:
                    self._record_cost(e.job)
        # The cost model of this bucket's dispatch (obs/memory's stand-in
        # for XLA's static accounting: the two kernels' bytes and
        # operations of one iteration and the batched peak), memoized per
        # shape bucket (ICT_EXEC_ANALYSIS=0 opts out).  Manifests were
        # already written terminal by on_item, so the analysis — and the
        # finalized
        # CostRecord, bytes/FLOPs apportioned across the K members with
        # the batch's attainment ratio — is re-persisted onto them
        # (GET /jobs/<id> falls back to the spool after retire()).
        analysis = obs_memory.analyze_batch_route(batch_shape, ctx.clean_cfg)
        if analysis:
            obs_costs.add_exec_share(
                [e.job for e in entries], analysis, dispatch_s,
                # the batched loop runs until its last archive stops
                iterations=max((it.loops or 0 for it in items), default=1),
                on_card=ctx.on_card)
            for e in entries:
                e.job.exec_analysis = analysis
        for e in entries:
            self._record_cost(e.job)
            if analysis and not getattr(e.job, "_cost_recorded", False):
                # Open jobs (mid-retry emission failure edge) still get
                # the analysis persisted, the historical behavior.
                try:
                    ctx.spool.save(e.job)
                except Exception:  # noqa: BLE001 — telemetry must not fail
                    pass           # a job that already served its result

    def _clean_oracle(self, e: Entry, served_by: str = "oracle-fallback") -> None:
        """The numpy-oracle route, one job at a time (isolated).  Runs
        inside the job's trace scope, so the core loop's per-iteration
        telemetry events carry the job's trace_id."""
        from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
        from iterative_cleaner_tpu_torch.models.surgical import finalize_weights

        ctx = self.ctx
        t0 = time.perf_counter()
        try:
            with events.trace_scope(e.job.trace_id), \
                    tracing.phase("service_oracle"):
                cfg = obs_audit.oracle_config(ctx.clean_cfg)
                res = clean_cube(e.D, e.w0, cfg)
                # rfi_frac is the mask before the bad-parts sweep, as on
                # the batched route.
                rfi = float((res.weights == 0).mean())
                final_w, _nbs, _nbc = finalize_weights(res.weights, cfg)
                self._emit(e, final_w, res.loops, res.converged, rfi,
                           served_by, iterations=res.iterations,
                           termination=res.termination,
                           scores=res.test_results)
        except Exception as exc:  # noqa: BLE001 — isolate, report, continue
            self._fail(e.job, str(exc))
        finally:
            # Oracle wall seconds are HOST cost, recorded as their own
            # phase — never device_s (the conservation invariant is
            # against ict_service_dispatch_s alone; a degraded job keeps
            # whatever failed-attempt dispatch share it accumulated).
            self._record_cost(e.job, phases={
                "oracle": time.perf_counter() - t0})

    # --- terminal transitions ---

    def _emit(self, e: Entry, weights, loops, converged, rfi_frac,
              served_by: str, iterations=None, termination: str = "",
              emit_iteration_events: bool = False, scores=None) -> None:
        """``iterations``/``termination`` land on the job manifest as the
        forensics timeline; ``emit_iteration_events`` additionally writes
        them to the event log (the batched route's post-hoc equivalent of
        the core loop's inline per-iteration events — the oracle route
        already emitted inline under its trace scope, so it passes False).
        ``scores`` is the route's last-iteration test scores, handed to the
        shadow auditor for the ulp-drift check."""
        from iterative_cleaner_tpu_torch.driver import atomic_save, output_name
        from iterative_cleaner_tpu_torch.io.base import get_io
        from iterative_cleaner_tpu_torch.models.surgical import apply_output_policy

        ctx = self.ctx
        job = e.job
        cleaned = apply_output_policy(e.archive, np.asarray(weights), ctx.clean_cfg)
        o_name = output_name(ctx.clean_cfg, e.archive, job.path)
        atomic_save(get_io(job.path), cleaned, o_name)
        job.out_path = o_name
        job.loops = int(loops)
        job.converged = bool(converged)
        job.rfi_frac = float(rfi_frac)
        job.served_by = served_by
        job.termination = termination
        if iterations:
            job.timeline = [forensics.iteration_record(i) for i in iterations]
            if emit_iteration_events and events.active():
                for rec in job.timeline:
                    events.emit("iteration", trace_id=job.trace_id,
                                job_id=job.id, **rec)
        # RFI data-quality telemetry (obs/quality.py): the served mask's
        # zap fraction, occupancy histograms, and termination/attribution
        # mix, on the manifest and as /metrics counters — a drifting
        # receiver shows up as a metric anomaly, not a mystery.
        job.quality = obs_quality.quality_summary(
            np.asarray(weights), termination=termination)
        obs_quality.record_job_quality(job.quality, timeline=job.timeline)
        # Store-through into the content cache: every freshly-cleaned
        # result (sharded or oracle — masks are identical by the parity
        # invariant) becomes the answer for the next byte-identical
        # submission.  Cache-served jobs are not re-stored.
        if served_by != "cache" and job.content_key:
            ctx.result_cache.put(
                job.content_key, np.asarray(weights), loops=job.loops,
                converged=job.converged, rfi_frac=job.rfi_frac,
                termination=termination, origin_job_id=job.id)
        # Shadow-oracle audit (obs/audit.py): sampled (ICT_AUDIT_RATE) or
        # per-job requested jobs are offered to the background auditor
        # BEFORE the terminal transition below, so "every job is terminal"
        # (drain) implies "every due audit is at least queued" — the drain
        # + auditor.drain sequence the smoke check and tests rely on.  The
        # queue keeps the cube arrays alive past the release below; a full
        # queue skips, never blocks.  Jobs the oracle itself served are
        # only audited on explicit request — a sampled replay of the
        # oracle against the oracle proves nothing.
        auditor = ctx.auditor
        if (auditor is not None
                and (job.audit or served_by == "sharded")
                and obs_audit.should_audit(job.audit, ctx.audit_rate())):
            auditor.submit(job, e.D, e.w0, np.asarray(weights), scores,
                           served_by, ctx.clean_cfg)
        job.finished_s = time.time()
        # Persist the done-stamped manifest BEFORE the in-memory state
        # flips: drain() keys off ``job.state``, so flipping first opens a
        # window where "every job is terminal" is true while the spool
        # still says "running" — a reader (or a crash) in that window sees
        # a served job without its quality/profile fields (observed as a
        # test flake).  A copy carries the stamp; the shared field refs
        # are only read for serialization.
        ctx.spool.save(dataclasses.replace(job, state="done"))
        job.state = "done"
        ctx.retire(job)
        tracing.count("service_jobs_done")
        tracing.count_labeled("jobs_served_total", {"route": served_by})
        if events.active():
            events.emit("job_done", trace_id=job.trace_id, job_id=job.id,
                        served_by=served_by, loops=job.loops,
                        termination=termination,
                        rfi_frac=round(job.rfi_frac, 6))
        # Release the decoded cube — steady-state host residency stays
        # bounded by the admission queue, not the job history.
        e.archive = e.D = e.w0 = None

    def _fail(self, job: Job, msg: str) -> None:
        """Terminal error transition.  Must NEVER raise: it is the last
        resort of the dispatch and loader threads, and a spool write that
        fails (disk full, spool dir removed) would otherwise kill the only
        dispatch thread while /healthz keeps reporting ok."""
        job.state = "error"
        job.error = msg
        job.finished_s = time.time()
        if events.active():
            events.emit("job_error", trace_id=job.trace_id, job_id=job.id,
                        error=msg)
        try:
            self.ctx.spool.save(job)
            self.ctx.retire(job)
        except Exception as exc:  # noqa: BLE001 — keep the job in memory:
            # with the manifest unwritten, the in-memory record is the only
            # true view of its state (GET /jobs/<id> reads it first).
            tracing.count("service_spool_save_errors")
            print(f"ict-serve: spool save failed for job {job.id}: {exc}",
                  file=sys.stderr)
        tracing.count("service_jobs_error")
        trace = f" trace={job.trace_id}" if job.trace_id else ""
        print(f"ict-serve: job {job.id} ({job.path}){trace} failed: {msg}",
              file=sys.stderr)
