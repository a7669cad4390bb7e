"""Warm pool: make declared shape classes fast before the API opens.

A port of ``iterative_cleaner_tpu/service/pool.py``.  Operators declare the
shape classes their telescope emits (``--warm NSUBxNCHANxNBIN``), and the
pool warms, before the API accepts traffic, every batch size the scheduler
can dispatch for them: one per power of two up to the bucket cap (the
closed set scheduler.pow2_chunks emits).

The JAX package warms by compiling XLA executables and keeps its account in
``utils/compile_cache.py``.  PyTorch compiles nothing per shape, so the
port's substitute is one real dispatch of zeros per batch size through
``parallel/sharded.sharded_clean``: it builds and loads both hand kernels
(``ops/cuda_build``, keyed by source hash) and fills their launch-plan
caches, the first-call costs a steady-state request must not pay.  On a
zero cube the loop stops after one iteration, so the run is cheap.
:meth:`WarmPool.is_warm` reports what those dispatches did in this
process.
"""

from __future__ import annotations

import sys
import threading

import numpy as np

from iterative_cleaner_tpu_torch.obs import tracing


def warm_batch_sizes(bucket_cap: int) -> list[int]:
    """Every batch size the scheduler can emit for one shape: ALL powers of
    two up to the cap — deadline flushes chunk to any pow2 size (a 3-cube
    bucket under cap 8 emits [2, 1]), not just the cap itself."""
    return [1 << k for k in range(bucket_cap.bit_length())
            if (1 << k) <= bucket_cap]


class WarmPool:
    """Constructed purely from a :class:`~.context.ReplicaContext` — the
    pool holds no process-global state, so several replicas' pools in one
    process never see each other."""

    def __init__(self, ctx, bucket_cap: int) -> None:
        self.ctx = ctx
        self.cfg = ctx.clean_cfg
        self.mesh = ctx.mesh
        self.bucket_cap = int(bucket_cap)
        self.quiet = ctx.serve_cfg.quiet  # gates info lines; warnings stay loud
        self.declared: tuple = ()   # shape classes declared at startup
        self._lock = threading.Lock()
        self._warm: set[tuple] = set()  # ict: guarded-by(self._lock)

    def warm_shape(self, shape) -> int:
        """Dispatch zeros once per batch size for one (nsub, nchan, nbin)
        shape class; returns how many batch sizes were warmed now.
        Failures are swallowed per size — warming is an optimization, the
        real dispatch pays the first-call costs itself."""
        from iterative_cleaner_tpu_torch.obs import memory as obs_memory
        from iterative_cleaner_tpu_torch.parallel.sharded import sharded_clean

        shape = tuple(int(v) for v in shape)
        warmed = 0
        with tracing.phase("service_warm"):
            for bsz in warm_batch_sizes(self.bucket_cap):
                key = (bsz, *shape)
                with self._lock:
                    if key in self._warm:
                        continue
                try:
                    Db = np.zeros(key, np.float32)
                    w0b = np.zeros(key[:3], np.float32)
                    with tracing.compile_scope(tracing.shape_bucket_label(key)):
                        sharded_clean(Db, w0b, self.cfg, self.mesh)
                    # The cost model lands on /metrics now, so the first real
                    # dispatch finds it memoized.
                    obs_memory.analyze_batch_route(key, self.cfg)
                    with self._lock:
                        self._warm.add(key)
                    warmed += 1
                except Exception as exc:  # noqa: BLE001 — best-effort, and
                    # per size: one failed warm-up must not skip the others.
                    print(f"ict-serve: warmup for shape {shape} batch "
                          f"{bsz} failed: {exc}", file=sys.stderr)
        return warmed

    def warm_startup(self, shapes) -> None:
        self.declared = tuple(tuple(int(v) for v in s) for s in shapes)
        for shape in self.declared:
            n = self.warm_shape(shape)
            if n and not self.quiet:
                print(f"ict-serve: warmed shape {shape} "
                      f"({n} batch sizes)", file=sys.stderr)

    def is_warm(self, shape) -> bool:
        """Whether a warm-up dispatch ran for EVERY batch size of this
        shape in this process."""
        shape = tuple(int(v) for v in shape)
        with self._lock:
            return all((bsz, *shape) in self._warm
                       for bsz in warm_batch_sizes(self.bucket_cap))

    def warm_shapes_now(self) -> list[tuple]:
        """The declared shapes currently fully warm (the /healthz view)."""
        return [s for s in self.declared if self.is_warm(s)]
