"""Directory batch: bucket archives by shape, clean each bucket in batched
dispatches on the mesh, keep per-archive failure isolation.

Port of ``iterative_cleaner_tpu/parallel/batch.py:33-261``: ``BatchItem``,
``_finish_bucket``, ``clean_directory_batch`` (decode everything with a
small thread pool, then :func:`clean_archives`) and
``clean_directory_streaming`` (a throttled loader pool; a bucket is
dispatched as soon as enough same-shape archives have arrived).
:func:`clean_archives` is the batch's in-memory entry: it preprocesses
the archives on the same small pool (phase ``clean_batch_preprocess`` on
the calling thread, each archive's ``clean_preprocess`` on a pool thread),
buckets them by exact shape and dispatches one bucket at a time.  The
mesh defaults to this process's cards (``parallel/multihost.local_mesh``,
as the JAX package's ``make_mesh()``), with archives over ``dp``.  Where the JAX package fits a
bucket by spreading it over the mesh's ``dp`` axis, the port cuts a bucket
into dispatches of at most ``dp`` times
``parallel/autoshard.archives_per_dispatch`` archives — the most whose
batched working set fits each card — and the streaming dispatcher's
default bucket size is that count for the shape.  An archive
whose own working set does not fit is reported as its item's error, naming
the sequential route that streams it through the card.  An out-of-memory
error is never caught and retried smaller.  ``want_history`` derives each
item's per-iteration forensics records and termination reason (the serving
daemon's ``GET /jobs/<id>/trace``).  The JAX package's compile-cache notes
have no counterpart: PyTorch does not compile per shape.
"""

from __future__ import annotations

from collections import defaultdict
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from dataclasses import dataclass
from itertools import islice

import numpy as np

from iterative_cleaner_tpu_torch.config import CleanConfig
from iterative_cleaner_tpu_torch.core.cleaner import _iteration_info
from iterative_cleaner_tpu_torch.io.base import Archive, get_io
from iterative_cleaner_tpu_torch.models.surgical import finalize_weights
from iterative_cleaner_tpu_torch.obs import forensics, tracing
from iterative_cleaner_tpu_torch.obs import memory as obs_memory
from iterative_cleaner_tpu_torch.ops.preprocess import preprocess
from iterative_cleaner_tpu_torch.parallel.autoshard import archives_per_dispatch
from iterative_cleaner_tpu_torch.parallel.multihost import local_mesh
from iterative_cleaner_tpu_torch.parallel.sharded import sharded_clean


@dataclass
class BatchItem:
    path: str
    archive: Archive | None = None
    weights: np.ndarray | None = None   # final cleaned weights
    test_results: np.ndarray | None = None
    loops: int = 0
    converged: bool = False
    rfi_frac: float = 0.0
    error: str | None = None
    # Convergence forensics (filled only when the dispatcher ran with
    # want_history — the serving daemon's per-job timeline source).
    iterations: list | None = None      # list[IterationInfo]
    termination: str = ""               # "fixed_point" | "cycle" | "max_iter"


def _load_and_preprocess(path: str):
    archive = get_io(path).load(path)
    D, w0 = preprocess(archive)
    return archive, D, w0


def _require_torch_backend(cfg: CleanConfig) -> None:
    if cfg.backend != "torch":
        raise ValueError(
            "the directory batch runs on the device and requires backend='torch'; "
            "use driver.run() without sharded_batch for the sequential numpy path")


def _dispatch_size(shape, cfg, mesh) -> int | None:
    """The most archives of ``shape`` one dispatch on ``mesh`` may take:
    ``archives_per_dispatch`` on one of its devices for each ``dp``
    slice (a slice's devices each hold a block of its archives)."""
    k = archives_per_dispatch(shape, cfg, mesh.device)
    return None if k is None else k * mesh.shape["dp"]


def _finish_bucket(items, idxs, cubes, w0s, cfg, mesh, on_item=None,
                   want_history=False) -> None:
    """Clean one same-shape bucket and write the results into its
    BatchItems.  ``cubes`` and ``w0s`` are lists the caller hands over: each
    dispatch's entries are released once it returns.  The bucket goes in
    dispatches of at most :func:`_dispatch_size` archives (all of them
    where the device reports no memory limit); an archive too large for one
    gets an error instead.  ``on_item(i, item)`` fires per
    finished archive — the streaming driver emits outputs there and
    releases the item's host arrays, which is what makes its memory bound
    real.  ``rfi_frac`` is the mask before the bad-parts sweep, which runs
    only when a flag differs from 1.  ``want_history`` additionally fetches
    the per-archive mask histories and derives each item's per-iteration
    forensics records and termination reason (off by default — extra host
    traffic).

    Each dispatch counts ``clean_batch_dispatches`` and its archives in
    ``clean_batch_archives``, records the card's peak under the route
    ``sharded_batch`` (``obs/memory.observe_route``, failed dispatches
    too) and finalizes its archives in one ``clean_finalize`` phase,
    before ``on_item`` sees any of them."""
    shape = tuple(np.shape(cubes[0]))
    k = _dispatch_size(shape, cfg, mesh)
    if k == 0:
        why = (f"archive shape {shape}: one archive's batched working set exceeds "
               "the device's usable memory; clean it without --sharded_batch (the "
               "sequential route streams it through the card in subint blocks)")
        for j, i in enumerate(idxs):
            items[i].error = why
            cubes[j] = w0s[j] = None
            if on_item is not None:
                on_item(i, items[i])
        return
    k = len(idxs) if k is None else k
    for lo in range(0, len(idxs), k):
        hi = min(lo + k, len(idxs))
        tracing.count("clean_batch_dispatches")
        tracing.count("clean_batch_archives", float(hi - lo))
        try:
            out = sharded_clean(cubes[lo:hi], w0s[lo:hi], cfg, mesh, want_history=want_history)
        finally:
            # Read while this dispatch is the freshest thing in the
            # allocator's peak.
            obs_memory.observe_route("sharded_batch")
        test_b, w_b, loops_b, done_b = out[:4]
        cubes[lo:hi] = w0s[lo:hi] = [None] * (hi - lo)
        with tracing.phase("clean_finalize"):
            for j in range(hi - lo):
                item = items[idxs[lo + j]]
                item.rfi_frac = float((w_b[j] == 0).mean())
                item.weights, _nbs, _nbc = finalize_weights(w_b[j], cfg)
                item.test_results = test_b[j]
                item.loops = int(loops_b[j])
                item.converged = bool(done_b[j])
                if want_history:
                    hist = out[5][j][: int(out[4][j]) + 1]
                    item.iterations = [_iteration_info(k, hist[k - 1], hist[k])
                                       for k in range(1, len(hist))]
                    item.termination = forensics.termination_reason(item.converged, hist)
        if on_item is not None:
            for i in idxs[lo:hi]:
                on_item(i, items[i])


def clean_archives(archives: list[Archive], cfg: CleanConfig, mesh=None) -> list[BatchItem]:
    """Clean in-memory archives; same-shape archives share batched
    dispatches.  Returns one BatchItem per archive, in order (``path``
    empty).

    An archive that fails to preprocess fails alone — it is reported in its
    BatchItem and never takes the bucket down.  Every preprocessed cube
    stays in host memory until its bucket is dispatched; a bucket's cubes
    are released as its dispatches return.
    """
    return _clean_items([BatchItem(path="", archive=a) for a in archives], cfg, mesh)


def _clean_items(items: list[BatchItem], cfg: CleanConfig, mesh) -> list[BatchItem]:
    """:func:`clean_archives` of the items that hold an archive; an item
    without one (its decode failed) is left as it is."""
    _require_torch_backend(cfg)
    if mesh is None:
        mesh = local_mesh()

    def prepare(item: BatchItem):
        if item.archive is None:
            return None
        try:
            return preprocess(item.archive)
        except Exception as exc:  # noqa: BLE001 — isolate the bad archive
            item.error = str(exc)
            return None

    with tracing.phase("clean_batch_preprocess"), ThreadPoolExecutor(max_workers=4) as pool:
        loaded = list(pool.map(prepare, items))

    buckets: dict[tuple, list[int]] = defaultdict(list)
    for i, out in enumerate(loaded):
        if out is not None:
            buckets[out[0].shape].append(i)
    for idxs in buckets.values():
        cubes = [loaded[i][0] for i in idxs]
        w0s = [loaded[i][1] for i in idxs]
        for i in idxs:   # the lists are now the sole owners: per-dispatch release works
            loaded[i] = None
        _finish_bucket(items, idxs, cubes, w0s, cfg, mesh)
    return items


def clean_directory_batch(paths: list[str], cfg: CleanConfig, mesh=None) -> list[BatchItem]:
    """Clean many archive files: each is decoded on a small thread pool,
    then :func:`clean_archives` runs on them.  A file that fails to decode
    fails alone, in its BatchItem."""
    _require_torch_backend(cfg)
    items = [BatchItem(path=p) for p in paths]

    def decode(item: BatchItem) -> None:
        try:
            item.archive = get_io(item.path).load(item.path)
        except Exception as exc:  # noqa: BLE001 — isolate the bad archive
            item.error = str(exc)

    with ThreadPoolExecutor(max_workers=4) as pool:
        list(pool.map(decode, items))
    return _clean_items(items, cfg, mesh)


def clean_directory_streaming(paths: list[str], cfg: CleanConfig, mesh=None,
                              bucket_cap: int | None = None, n_loaders: int = 4,
                              on_item=None) -> list[BatchItem]:
    """Streaming variant: archive decode overlaps device compute.

    A loader pool decodes archives concurrently; the consumer dispatches a
    bucket as soon as its shape's cap of same-shape cubes has arrived while
    the loaders keep reading ahead.  The cap is ``bucket_cap`` when given,
    else the shape's :func:`_dispatch_size` (one full dispatch, standing
    in for the JAX package's ``dp`` extent), or ``n_loaders``
    where the device reports no memory limit.  Unlike
    :func:`clean_directory_batch` this never holds the whole directory on
    the host: decoded and decoding archives together stay below the
    read-ahead window (the largest cap seen plus ``n_loaders``), and when
    parked sub-cap buckets (a shape-heterogeneous directory) fill it, the
    fullest bucket is flushed early, trimmed to a power of two.  Same-shape
    archives split across flushes land in separate dispatches — masks are
    per-archive either way.

    The bound is only real when the caller passes ``on_item(i, item)`` and
    releases each item's ``archive``/``weights``/``test_results`` there
    after emitting outputs (as ``driver.run_sharded_batch`` does) — without
    it every decoded Archive stays resident on its BatchItem.
    """
    _require_torch_backend(cfg)
    if mesh is None:
        mesh = local_mesh()
    items = [BatchItem(path=p) for p in paths]
    caps: dict[tuple, int] = {}

    def cap_for(shape) -> int:
        if shape not in caps:
            k = bucket_cap if bucket_cap is not None else _dispatch_size(shape, cfg, mesh)
            caps[shape] = max(1, n_loaders if k is None else k)
        return caps[shape]

    def load(i: int):
        try:
            items[i].archive, D, w0 = _load_and_preprocess(items[i].path)
            return i, D, w0
        except Exception as exc:  # noqa: BLE001 — isolate the bad archive
            items[i].error = str(exc)
            return i, None, None

    pending: dict[tuple, list[tuple[int, np.ndarray, np.ndarray]]] = defaultdict(list)

    def parked() -> int:
        return sum(len(g) for g in pending.values())

    def flush(shape, pow2: bool = False) -> None:
        group = pending.pop(shape)
        if pow2 and len(group) > 1:
            # Early (pressure) flushes trim to a power-of-two batch; the
            # remainder stays parked for a later flush.
            k = 1 << (len(group).bit_length() - 1)
            group, rest = group[:k], group[k:]
            if rest:
                pending[shape] = rest
        idxs = [i for i, _, _ in group]
        cubes = [d for _, d, _ in group]
        w0s = [w for _, _, w in group]
        del group
        _finish_bucket(items, idxs, cubes, w0s, cfg, mesh, on_item=on_item)

    # Submission is throttled to bound host memory: loads in flight plus
    # parked cubes stay below the read-ahead window, so a device dispatch
    # slower than decode cannot pile the whole directory into finished
    # futures.  The window grows with the largest cap seen.
    read_ahead = (bucket_cap if bucket_cap is not None else 1) + n_loaders
    next_idx = iter(range(len(paths)))
    with ThreadPoolExecutor(max_workers=n_loaders) as pool:
        futures = {pool.submit(load, i) for i in islice(next_idx, read_ahead)}
        while futures:
            done, futures = wait(futures, return_when=FIRST_COMPLETED)
            for fut in done:
                i, D, w0 = fut.result()
                if D is None:
                    continue
                shape = D.shape
                cap = cap_for(shape)
                read_ahead = max(read_ahead, cap + n_loaders)
                pending[shape].append((i, D, w0))
                del D, w0
                # Dispatch blocks this (consumer) thread on the device; the
                # pool threads keep decoding the read-ahead meanwhile.
                if len(pending[shape]) >= cap:
                    flush(shape)
                elif parked() >= read_ahead:
                    # Parked sub-cap buckets count against residency: flush
                    # the fullest early (a smaller dispatch, same masks).
                    flush(max(pending, key=lambda s: len(pending[s])), pow2=True)
            room = read_ahead - len(futures) - parked()
            for j in islice(next_idx, max(0, room)):
                futures.add(pool.submit(load, j))
    for shape in list(pending):
        flush(shape)
    return items
