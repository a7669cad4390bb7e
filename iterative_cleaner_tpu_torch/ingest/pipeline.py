"""Double-buffered host→device block staging for the streaming route.

A copy of ``iterative_cleaner_tpu/ingest/pipeline.py`` (``BlockStager``,
``stream_map``, the ``_Failure`` propagation, ``stream_depth`` /
``ICT_INGEST_DEPTH`` and the stats counters) with the moving parts the card
needs, in :class:`SlabUploader`.

The chunked (>device memory) backend streams ``(block, nchan, nbin)``
subint slabs through the device.  The stager moves each block's ``load``
onto a background thread under a credit protocol:

- ``depth`` credits (default 2) bound how many device blocks are live at
  once; the consumer returns a credit only after the compute that consumed
  the oldest block has *completed*, so at steady state ``depth`` blocks
  exist on the device — at the default, the one computing and the one
  uploading — the budget ``parallel/autoshard.chunk_block_subints`` sizes
  blocks for;
- the consumer's only wait is ``queue.get`` on a block whose upload did not
  finish under the previous block's compute; the share of that wait not
  absorbed by still-running compute (``stall``) against the upload busy
  time gives ``overlap efficiency = 1 − stall/upload``.

On the card (:class:`SlabUploader`) a load copies the host slab, piece by
piece, into two preallocated pinned staging buffers in turn, issues a
``non_blocking`` copy of each piece on a dedicated copy stream into one of
``depth`` preallocated device slabs, and records a ``ready`` event; the
consumer's stream waits on it.  After the consumer's compute on a slab it
records a ``done`` event, and the credit comes back only once that event
has completed.  The device slabs are allocated once, never per block on the
side stream, so the caching allocator cannot hand a slab's memory to
another stream while it is still read.  The host cube is only ever read.

Each pass observes the ``ingest_upload`` phase (the stager's load time)
and, when the consumer waited, ``ingest_stall`` in ``obs.tracing``.

Determinism: the stager changes when bytes move, never their values or the
order the consumer sees blocks in.  ``ICT_INGEST_DEPTH=1`` reverts to the
serial in-line path.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from iterative_cleaner_tpu_torch.obs import tracing

#: Default staging depth: current block computing + next block uploading.
DEFAULT_DEPTH = 2

_stats_lock = threading.Lock()
_STATS = {
    "blocks": 0,           # blocks staged through any stager
    "serial_blocks": 0,    # of which on the serial (depth=1) path
    "bytes": 0,            # device bytes staged
    "upload_busy_s": 0.0,  # stager-thread time spent loading blocks
    "wait_s": 0.0,         # raw consumer time blocked on a not-yet-ready
                           # block (first-block pipeline fill excluded)
    "stall_s": 0.0,        # the critical-path share of that wait: per block,
                           # the get-wait minus the compute-sync time that
                           # ran anyway right after it; serial loads count
                           # entirely
}


def stream_depth() -> int:
    """The staging depth (``ICT_INGEST_DEPTH``, default 2; 1 = serial)."""
    try:
        return max(1, int(os.environ.get("ICT_INGEST_DEPTH", DEFAULT_DEPTH)))
    except ValueError:
        return DEFAULT_DEPTH


def stats_snapshot() -> dict:
    """Cumulative pipeline counters + the derived overlap figures:
    ``overlap_efficiency = 1 − stall/upload`` clamped to [0, 1] (0 on the
    serial path by construction) and ``effective_gbps`` = bytes over upload
    busy time."""
    with _stats_lock:
        s = dict(_STATS)
    busy = s["upload_busy_s"]
    s["overlap_efficiency"] = (
        max(0.0, min(1.0, 1.0 - s["stall_s"] / busy)) if busy > 1e-9 else 0.0)
    s["effective_gbps"] = s["bytes"] / 1e9 / busy if busy > 1e-9 else 0.0
    return s


def reset_stats() -> None:
    """Zero the cumulative counters (callers measure deltas)."""
    with _stats_lock:
        _STATS.update(blocks=0, serial_blocks=0, bytes=0,
                      upload_busy_s=0.0, wait_s=0.0, stall_s=0.0)


def _note(blocks=0, serial=0, nbytes=0, upload_s=0.0, wait_s=0.0,
          stall_s=0.0) -> None:
    with _stats_lock:
        _STATS["blocks"] += blocks
        _STATS["serial_blocks"] += serial
        _STATS["bytes"] += nbytes
        _STATS["upload_busy_s"] += upload_s
        _STATS["wait_s"] += wait_s
        _STATS["stall_s"] += stall_s


def _nbytes(blk) -> int:
    return int(getattr(blk, "nbytes", 0))


class _Failure:
    __slots__ = ("exc",)

    def __init__(self, exc: BaseException) -> None:
        self.exc = exc


class BlockStager:
    """Iterate ``((lo, hi), block)`` with loads staged ahead on a thread.

    ``load(lo, hi)`` runs on the stager thread.  The consumer drives the
    credit protocol: after the compute that consumed a block has completed,
    it calls :meth:`release` to let the stager start the next load.
    :func:`stream_map` packages that protocol — prefer it.
    """

    def __init__(
        self,
        ranges: Iterable[tuple[int, int]],
        load: Callable[[int, int], object],
        depth: int | None = None,
    ) -> None:
        self.ranges: Sequence[tuple[int, int]] = list(ranges)
        self._load = load
        self.depth = stream_depth() if depth is None else max(1, int(depth))
        self.last_wait_s = 0.0  # this block's get-wait, read by stream_map
        self.serial = False     # which path __iter__ took
        self.upload_busy_s = 0.0  # this pass's load time (stager thread)
        self.stall_s = 0.0        # this pass's critical-path wait
        self._credits = threading.Semaphore(self.depth)
        self._stop = threading.Event()

    def release(self) -> None:
        """Return one residency credit: the oldest staged block's compute
        has completed, so its device slab may be refilled."""
        self._credits.release()

    def __iter__(self):
        if self.depth == 1 or len(self.ranges) <= 1:
            # Serial path: load in-line on the consumer thread.  Every
            # in-line load is exposed wall clock, so it all counts as stall.
            self.serial = True
            for lo, hi in self.ranges:
                t0 = time.perf_counter()
                blk = self._load(lo, hi)
                dt = time.perf_counter() - t0
                self.upload_busy_s += dt
                self.stall_s += dt
                _note(blocks=1, serial=1, nbytes=_nbytes(blk), upload_s=dt, stall_s=dt)
                yield (lo, hi), blk
            return

        q: queue.Queue = queue.Queue()  # bounded by the credit semaphore

        def run() -> None:
            try:
                for lo, hi in self.ranges:
                    self._credits.acquire()
                    if self._stop.is_set():
                        return
                    t0 = time.perf_counter()
                    blk = self._load(lo, hi)
                    dt = time.perf_counter() - t0
                    self.upload_busy_s += dt
                    _note(blocks=1, nbytes=_nbytes(blk), upload_s=dt)
                    q.put(((lo, hi), blk))
            except BaseException as exc:  # noqa: BLE001 — re-raised consumer-side
                q.put(_Failure(exc))

        th = threading.Thread(target=run, daemon=True, name="ict-ingest-stage")
        th.start()
        try:
            for i in range(len(self.ranges)):
                t0 = time.perf_counter()
                item = q.get()
                dt = time.perf_counter() - t0
                if isinstance(item, _Failure):
                    raise item.exc
                # The first block's fill has nothing to overlap with.
                self.last_wait_s = dt if i else 0.0
                _note(wait_s=self.last_wait_s)
                yield item
        finally:
            # Consumer done or dying mid-stream: unblock the stager thread
            # (it re-checks _stop after every credit) and let it exit.
            self._stop.set()
            self._credits.release()
            th.join()


def stream_map(
    ranges: Iterable[tuple[int, int]],
    load: Callable[[int, int], object],
    compute: Callable[[int, int, object], object],
    sync: Callable[[object], None],
    depth: int | None = None,
) -> list:
    """Run ``compute`` over staged blocks with the full overlap protocol.

    For each range, ``compute(lo, hi, block)`` enqueues the device work;
    ``sync(prev_out)`` waits for each previous output's work to complete
    before the stager may load another block — the one ordering rule that
    bounds device residency to ``depth`` blocks while the next upload hides
    under the current compute.  Returns the compute outputs, in order.
    """
    unset = object()  # sentinel: a compute() returning None is still synced
    outs: list = []
    stager = BlockStager(ranges, load, depth=depth)
    prev = unset
    for (lo, hi), blk in stager:
        get_wait = stager.last_wait_s
        out = compute(lo, hi, blk)
        if prev is not unset:
            t0 = time.perf_counter()
            sync(prev)
            sync_s = time.perf_counter() - t0
            stager.release()
            if not stager.serial:
                # This block's get-wait ran while the previous block's
                # compute was still in flight (the sync right after shows
                # how much was left); only the surplus cost wall clock.
                stall = max(0.0, get_wait - sync_s)
                stager.stall_s += stall
                _note(stall_s=stall)
        outs.append(out)
        prev = out
    if prev is not unset:
        sync(prev)
    # One phase observation per pass (not per block), as in the JAX package.
    tracing.observe_phase("ingest_upload", stager.upload_busy_s)
    if stager.stall_s:
        tracing.observe_phase("ingest_stall", stager.stall_s)
    return outs


class _Slot:
    __slots__ = ("dev", "ready", "done")


class StagedSlab:
    """One loaded block: its slot and the device view of ``hi - lo``
    subints."""

    __slots__ = ("slot", "tensor", "nbytes")

    def __init__(self, slot: _Slot, tensor: torch.Tensor) -> None:
        self.slot = slot
        self.tensor = tensor
        self.nbytes = tensor.numel() * tensor.element_size()


#: float32 elements per pinned staging buffer (2^24, 64 MiB).
PIECE_ELEMENTS = 1 << 24


class SlabUploader:
    """``depth`` preallocated device slabs of ``block`` subints, filled from
    a host cube that is only read.

    Protocol: :meth:`load` (stager thread) → :meth:`take` (consumer: the
    device view, its stream ordered after the upload) → the consumer's
    compute → :meth:`finish` (records ``done``) → :meth:`wait` (the credit
    condition: that compute has completed).  On the card a load moves the
    slab in pieces through two pinned staging buffers: the host copy of
    piece k+1 into one overlaps the ``non_blocking`` copy of piece k out of
    the other, on a dedicated copy stream; the stager thread then waits for
    the slab's ``ready`` event, so the upload busy time is the whole upload.
    On the CPU a load is one copy into the slot's slab.
    """

    def __init__(self, host: np.ndarray, block: int, device, depth: int) -> None:
        self.host = host
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        slab = (min(int(block), host.shape[0]), *host.shape[1:])
        self._slots = []
        for _ in range(max(1, int(depth))):
            s = _Slot()
            s.dev = torch.empty(slab, dtype=torch.float32, device=self.device)
            s.ready = torch.cuda.Event() if self._cuda else None
            s.done = torch.cuda.Event() if self._cuda else None
            self._slots.append(s)
        self._next = 0
        self.copy_s = 0.0   # host memcpy into the staging buffers
        if self._cuda:
            piece = min(PIECE_ELEMENTS, int(np.prod(slab)))
            self._pinned = [torch.empty(piece, dtype=torch.float32, pin_memory=True)
                            for _ in range(2)]
            self._pinned_free = [torch.cuda.Event() for _ in range(2)]
            self._stream = torch.cuda.Stream(self.device)

    def load(self, lo: int, hi: int) -> StagedSlab:
        slot = self._slots[self._next % len(self._slots)]
        self._next += 1
        view = slot.dev[: hi - lo]
        if not self._cuda:
            t0 = time.perf_counter()
            view.numpy()[...] = self.host[lo:hi]
            self.copy_s += time.perf_counter() - t0
            return StagedSlab(slot, view)
        # The slot's previous block must be fully consumed before its slab
        # is overwritten (the credit protocol already ensures it at depth
        # >= 2; this keeps the serial path safe too).
        slot.done.synchronize()
        src = self.host[lo:hi].reshape(-1)
        dst = view.reshape(-1)
        piece = self._pinned[0].numel()
        with torch.cuda.stream(self._stream):
            for k, off in enumerate(range(0, src.size, piece)):
                buf, free = self._pinned[k % 2], self._pinned_free[k % 2]
                m = min(piece, src.size - off)
                free.synchronize()  # the copy out of this buffer has finished
                t0 = time.perf_counter()
                np.copyto(buf.numpy()[:m], src[off:off + m])
                self.copy_s += time.perf_counter() - t0
                dst[off:off + m].copy_(buf[:m], non_blocking=True)
                free.record(self._stream)
            slot.ready.record(self._stream)
        slot.ready.synchronize()
        return StagedSlab(slot, view)

    def take(self, staged: StagedSlab) -> torch.Tensor:
        if self._cuda:
            torch.cuda.current_stream(self.device).wait_event(staged.slot.ready)
        return staged.tensor

    def finish(self, staged: StagedSlab) -> None:
        if self._cuda:
            staged.slot.done.record(torch.cuda.current_stream(self.device))

    def wait(self, staged: StagedSlab) -> None:
        if self._cuda:
            staged.slot.done.synchronize()

    def stream(self, ranges, compute, depth: int) -> list:
        """``stream_map`` over ``ranges`` with this uploader's protocol;
        ``compute(lo, hi, device_block)`` returns the block's outputs."""
        def run(lo, hi, staged):
            out = compute(lo, hi, self.take(staged))
            self.finish(staged)
            return staged, out

        outs = stream_map(ranges, self.load, run, lambda o: self.wait(o[0]),
                          depth=depth)
        return [out for _, out in outs]
