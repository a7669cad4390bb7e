"""Fill a device tensor from a host array through reused pinned pieces.

A pageable ``torch.from_numpy(a).to(card)`` runs at the speed of one host
thread's memcpy into CUDA's own staging buffers (5.3-5.7 GB/s on the H100's
host, against 48.8 GB/s from pinned memory).  :meth:`StagingPool.fill`
splits the copy instead: the array's C-order elements are cut into pieces of
``piece_bytes``, and several host threads each gather a piece into a pinned
buffer (``np.copyto``, which releases the interpreter lock; a strided array,
such as the pol-0 plane ``data[:, 0]`` of a 4-pol cube, is gathered piece by
piece, never made contiguous whole) and enqueue its ``non_blocking`` copy
on a dedicated copy stream, recording the buffer's event.  A buffer is
taken again only once that event has completed.  The calling thread gathers
the last piece first, then works through the others beside the pool's
threads, and ends the fill with the last piece's blocking copy on the copy
stream, which returns when every piece is on the card: one upload and one
synchronisation, as ``analysis/contracts`` counts it (torch's sync debug
mode does not report the waits on the buffers' events).

The destination is the caller's tensor, so nothing is staged on the device.
The pinned buffers (:data:`PIECES_PER_THREAD` a copying thread, each of
:data:`PIECE_BYTES`) and the threads belong to one :class:`StagingPool` per
process and device (:func:`pool_for`), made on the first call and reused by
every later one; a forked process makes its own.  No caller's array is pinned
(``cudaHostRegister``) and nothing is kept of one.  A pool on the CPU (the
tests) takes the same steps with plain buffers and synchronous copies.

The gauge ``clean_upload_pinned_bytes`` holds the pinned bytes of every pool
of the process.
"""

from __future__ import annotations

import contextlib
import math
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from iterative_cleaner_tpu_torch.obs import tracing

#: Bytes of one pinned piece.
PIECE_BYTES = 16 << 20
#: Pinned pieces per copying thread: one filling while the last one's copy
#: to the card runs.
PIECES_PER_THREAD = 2
#: Most host threads that copy at once, the caller's included: the card's
#: host (8 cores) peaks at 6-8 threads (15-18 GB/s) and gains nothing beyond.
MAX_THREADS = 8
#: Host arrays from this size up take the staged route (``to_device``).
STAGED_MIN_BYTES = 32 << 20


def copying_threads() -> int:
    """Host threads a fill copies with, the caller's included: the cores
    this process may run on, at most :data:`MAX_THREADS`."""
    return max(1, min(MAX_THREADS, len(os.sched_getaffinity(0))))


def piece_plan(n: int, piece: int) -> list[tuple[int, int]]:
    """The ``[lo, hi)`` element ranges, ``piece`` elements each but the
    last, that cover ``n`` elements in order."""
    return [(lo, min(lo + piece, n)) for lo in range(0, n, piece)]


def gather(src: np.ndarray, lo: int, hi: int, out: np.ndarray) -> None:
    """Copy the C-order elements ``[lo, hi)`` of ``src``, of any strides,
    into the 1-D ``out``: whole rows of the leading axis in one copy, a
    partial first or last row by the same rule one axis down."""
    if hi <= lo:
        return
    if src.ndim <= 1 or src.flags.c_contiguous:
        np.copyto(out, src.reshape(-1)[lo:hi])
        return
    inner = math.prod(src.shape[1:])
    first, last = lo // inner, (hi - 1) // inner
    if first == last:
        gather(src[first], lo - first * inner, hi - first * inner, out)
        return
    pos = 0
    head = lo - first * inner
    if head:
        gather(src[first], head, inner, out[: inner - head])
        pos, first = inner - head, first + 1
    tail = hi - last * inner
    stop = last + 1 if tail == inner else last
    if stop > first:
        n = (stop - first) * inner
        np.copyto(out[pos:pos + n].reshape((stop - first, *src.shape[1:])), src[first:stop])
        pos += n
    if tail < inner:
        gather(src[last], 0, tail, out[pos:pos + tail])


class _Piece:
    """One staging buffer: its bytes as a numpy array, and on the card the
    event of its last copy to the device."""

    def __init__(self, owner: torch.Tensor, cuda: bool) -> None:
        self.owner = owner                 # keeps the (pinned) memory alive
        self.bytes = owner.numpy()
        self.event = torch.cuda.Event() if cuda else None

    def view(self, dtype: np.dtype, n: int) -> np.ndarray:
        return self.bytes.view(dtype)[:n]

    def wait(self) -> None:
        """Return once the buffer's last copy to the card has completed."""
        if self.event is not None:
            self.event.synchronize()


class StagingPool:
    """Pinned pieces, a copy stream and threads for host-to-``device``
    fills (see the module docstring).  One fill runs at a time; a
    concurrent caller waits for the one before it."""

    def __init__(self, device, threads: int | None = None,
                 piece_bytes: int | None = None) -> None:
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self.threads = copying_threads() if threads is None else max(1, int(threads))
        self.piece_bytes = PIECE_BYTES if piece_bytes is None else int(piece_bytes)
        self.pieces = [_Piece(torch.empty(self.piece_bytes, dtype=torch.uint8,
                                          pin_memory=self._cuda), self._cuda)
                       for _ in range(PIECES_PER_THREAD * self.threads)]
        self.nbytes = len(self.pieces) * self.piece_bytes
        self._free: queue.SimpleQueue[_Piece] = queue.SimpleQueue()
        for piece in self.pieces:
            self._free.put(piece)
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._workers = (ThreadPoolExecutor(self.threads - 1, thread_name_prefix="ict-stage")
                         if self.threads > 1 else None)
        self._lock = threading.Lock()

    def fill(self, dst: torch.Tensor, src: np.ndarray) -> torch.Tensor:
        """Copy ``src`` into the contiguous ``dst`` of its size and type;
        returns ``dst`` once every byte is there.  An exception in any
        thread is raised here, after every copy already enqueued has ended."""
        src = np.asarray(src)
        if (not dst.is_contiguous() or dst.numel() != src.size
                or str(dst.dtype) != f"torch.{src.dtype}"):
            raise ValueError(f"cannot fill a {tuple(dst.shape)} {dst.dtype} tensor "
                             f"from a {src.shape} {src.dtype} array")
        plan = piece_plan(src.size, max(1, self.piece_bytes // src.itemsize))
        if not plan:
            return dst
        flat = dst.view(-1)
        todo: queue.SimpleQueue[tuple[int, int]] = queue.SimpleQueue()
        for p in plan[:-1]:
            todo.put(p)
        failed = threading.Event()
        with self._lock:
            if self._cuda:
                # dst's memory may still be read by work queued on the
                # caller's stream before the allocator handed it out.
                self._stream.wait_stream(torch.cuda.current_stream(self.device))  # ict: backend-init-ok(dst is on the card: CUDA is live)
            helpers = min(self.threads - 1, len(plan) - 1)
            futures = [self._workers.submit(self._work, src, flat, todo, failed)
                       for _ in range(helpers)]
            errors = []
            last = self._free.get()
            try:
                lo, hi = plan[-1]
                last.wait()
                gather(src, lo, hi, last.view(src.dtype, hi - lo))
                self._work(src, flat, todo, failed)
            except BaseException as exc:
                failed.set()
                errors.append(exc)
            for f in futures:
                if f.exception() is not None:
                    errors.append(f.exception())
            try:
                if errors:
                    if self._cuda:
                        self._stream.synchronize()
                    raise errors[0]
                with self._on_stream():
                    # Blocking: returns when this and every earlier piece on
                    # the copy stream is on the card.
                    flat[lo:hi].copy_(torch.from_numpy(last.view(src.dtype, hi - lo)))
            finally:
                self._free.put(last)
        return dst

    def close(self) -> None:
        """Stop the pool's threads (a pool of :func:`pool_for` lives as long
        as its process)."""
        if self._workers is not None:
            self._workers.shutdown()

    def _on_stream(self):
        return torch.cuda.stream(self._stream) if self._cuda else contextlib.nullcontext()

    def _work(self, src, flat, todo, failed) -> None:
        """Gather and send pieces until ``todo`` is empty or a thread
        failed."""
        with self._on_stream():
            while not failed.is_set():
                try:
                    lo, hi = todo.get_nowait()
                except queue.Empty:
                    return
                piece = self._free.get()
                try:
                    piece.wait()
                    buf = piece.view(src.dtype, hi - lo)
                    gather(src, lo, hi, buf)
                    flat[lo:hi].copy_(torch.from_numpy(buf), non_blocking=True)
                    if piece.event is not None:
                        piece.event.record(self._stream)
                except BaseException:
                    failed.set()
                    raise
                finally:
                    self._free.put(piece)


_pools_lock = threading.Lock()
_POOLS: dict[tuple[int, str], StagingPool] = {}  # ict: guarded-by(_pools_lock)


def pool_for(device) -> StagingPool:
    """This process's :class:`StagingPool` for ``device`` (a CUDA device
    without an index means the current one), made on the first call."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())  # ict: backend-init-ok(a CUDA destination exists: CUDA is live)
    key = (os.getpid(), str(dev))
    with _pools_lock:
        pool = _POOLS.get(key)
        if pool is None:
            pool = _POOLS[key] = StagingPool(dev)
            tracing.set_gauge("clean_upload_pinned_bytes", float(sum(
                p.nbytes for (pid, _), p in _POOLS.items() if pid == key[0])))
    return pool
