"""Shape-bucketed admission: fill a coalesced dp slice or hit a deadline.

A copy of ``iterative_cleaner_tpu/service/scheduler.py``.  The daemon's
default ``bucket_cap`` is the mesh's ``dp`` extent (1 on one card), so a
full bucket puts an archive on each ``dp`` slice;
``parallel/batch._finish_bucket`` still cuts a dispatch the cards cannot
hold into smaller ones.

The batching rules are the ones `parallel/batch.py` established for
directories, applied to a continuous arrival stream:

- same-shape cubes stack into ONE sharded dispatch (zero-weight padding
  is never used — it would perturb the mask-blind FFT diagnostic, see
  parallel/sharded.py);
- the **coalescing rung**: the flush
  threshold is ``dp_cap x coalesce`` cubes — one data-parallel slice
  times a pow2 coalesce factor — so ONE ``batched_fused_clean`` launch
  amortizes over K cubes, each device vmapping ``coalesce`` archives of
  its slice.  ``coalesce=1`` (the default) is the historical
  one-archive-per-slice behavior; raising it trades bounded added
  latency (the deadline still caps the wait) and per-device residency
  (``coalesce`` cubes live per chip) for launch amortization on
  small-cube campaign traffic;
- a bucket flushes the moment it holds ``bucket_cap`` cubes, or when its
  OLDEST entry has waited ``deadline_s`` (latency bound for sparse
  traffic);
- deadline flushes are chunked to power-of-two batch sizes, the
  clean_directory_streaming pressure-flush trick: pow2 chunking bounds
  the batch sizes to O(log cap) per shape — exactly the set service/pool.py
  warms at startup (dp_cap and coalesce are each pow2-clamped, so their
  product keeps the warm set closed).

The scheduler owns no threads: the daemon's loader threads call
:meth:`offer` and a tick loop calls :meth:`tick`; ``flush_fn(entries)``
must be cheap (the worker enqueues, it does not dispatch inline).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np

from iterative_cleaner_tpu_torch.io.base import Archive
from iterative_cleaner_tpu_torch.obs import events, tracing
from iterative_cleaner_tpu_torch.service.jobs import Job

#: Canonical shape-bucket label, ``8x16x64`` — ONE grammar shared by the
#: ``--warm`` CLI spec, ``/healthz`` bucket depths, the fleet router's
#: placement keys, and compile-scope attribution.  The implementation
#: lives in obs/tracing.py (the lowest layer that needs it); this alias
#: is the name the service/fleet tier imports, so the two spellings can
#: never drift apart again (tests/test_coalesce.py pins the unification).
bucket_label = tracing.shape_bucket_label


@dataclass
class Entry:
    """One admitted job with its decoded cube (host arrays)."""

    job: Job
    archive: Archive
    D: np.ndarray
    w0: np.ndarray
    arrived_s: float            # time.monotonic() — immune to clock steps


def pow2_chunks(n: int, cap: int) -> list[int]:
    """Split ``n`` into power-of-two chunk sizes <= cap, largest first
    (5, cap 4 -> [4, 1]) — the closed set of batch sizes the scheduler can
    emit, {1, 2, 4, ..., cap}."""
    sizes = []
    while n > 0:
        k = 1 << (n.bit_length() - 1)
        k = min(k, 1 << (cap.bit_length() - 1))
        sizes.append(k)
        n -= k
    return sizes


class ShapeBucketScheduler:
    def __init__(self, bucket_cap: int, deadline_s: float, flush_fn,
                 coalesce: int = 1) -> None:
        if bucket_cap < 1:
            raise ValueError(f"bucket_cap must be >= 1, got {bucket_cap}")
        if coalesce < 1:
            raise ValueError(f"coalesce must be >= 1, got {coalesce}")
        # Clamp to powers of two HERE, in the mechanism that owns the
        # invariant: full-bucket flushes emit exactly bucket_cap entries
        # unchunked, and the warm pool only precompiles pow2 batch sizes —
        # a cap of 3 would dispatch batches no warm set covers.  dp_cap
        # and coalesce are clamped separately so their product (the
        # effective flush threshold) stays pow2 AND dp-divisible: a full
        # coalesced batch shards evenly over the mesh's dp axis, each
        # device vmapping `coalesce` archives.
        self.dp_cap = 1 << (int(bucket_cap).bit_length() - 1)
        self.coalesce = 1 << (int(coalesce).bit_length() - 1)
        self.bucket_cap = self.dp_cap * self.coalesce
        self.deadline_s = float(deadline_s)
        self._flush_fn = flush_fn
        self._buckets: dict[tuple, list[Entry]] = {}  # ict: guarded-by(self._lock)
        self._lock = threading.Lock()

    def offer(self, job: Job, archive: Archive, D, w0) -> None:
        """Admit one decoded cube; flushes its bucket if that fills a dp
        slice.  Shape is the preprocessed-cube shape — the executable
        identity, exactly the key parallel/batch buckets on."""
        entry = Entry(job=job, archive=archive, D=D, w0=w0,
                      arrived_s=time.monotonic())
        job.shape = list(D.shape)
        if events.active():
            events.emit("admission", trace_id=job.trace_id, job_id=job.id,
                        shape=list(D.shape))
        flush = None
        with self._lock:
            group = self._buckets.setdefault(tuple(D.shape), [])
            group.append(entry)
            if len(group) >= self.bucket_cap:
                flush = self._buckets.pop(tuple(D.shape))
        if flush:
            tracing.count("service_bucket_full_flushes")
            self._flush_fn(flush)

    def tick(self, now: float | None = None) -> None:
        """Flush every bucket whose oldest entry has exceeded the deadline,
        in pow2 chunks (see module docstring)."""
        now = time.monotonic() if now is None else now
        due: list[list[Entry]] = []
        with self._lock:
            for shape in [s for s, g in self._buckets.items()
                          if now - g[0].arrived_s >= self.deadline_s]:
                due.append(self._buckets.pop(shape))
        for group in due:
            tracing.count("service_bucket_deadline_flushes")
            self._emit_chunks(group)

    def flush_all(self) -> None:
        """Drain everything (shutdown / drain barrier)."""
        with self._lock:
            groups = list(self._buckets.values())
            self._buckets.clear()
        for group in groups:
            self._emit_chunks(group)

    def _emit_chunks(self, group: list[Entry]) -> None:
        i = 0
        for size in pow2_chunks(len(group), self.bucket_cap):
            self._flush_fn(group[i: i + size])
            i += size

    def pending_count(self) -> int:
        with self._lock:
            return sum(len(g) for g in self._buckets.values())

    def pending_by_bucket(self) -> dict[str, int]:
        """Queued-cube depth per shape bucket, keyed by the ``NSUBxNCHANx
        NBIN`` label (the ``--warm`` spec grammar).  This is the
        bucket-resolved signal the fleet router's affinity placement
        reads off ``/healthz`` — the aggregate depths alone cannot tell
        it WHICH replica is already working a shape."""
        with self._lock:
            return {bucket_label(shape): len(group)
                    for shape, group in self._buckets.items()}
