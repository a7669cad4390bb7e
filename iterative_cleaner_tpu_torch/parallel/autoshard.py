"""Working-set estimate and block sizing for cubes beyond one card.

Port of ``iterative_cleaner_tpu/parallel/autoshard.py``: ``working_set_bytes``
(:73-78), ``chunk_block_subints`` (:134-155), ``HBM_USABLE_FRACTION`` (:34)
and ``device_memory_bytes``.  The routing decision is made before the run,
from the estimate: a cube whose estimated peak exceeds the usable memory
streams through the chunked backend (``parallel/chunked.py``); an
out-of-memory error on the in-memory route is never caught and retried.

The estimate is the port's own, one per route, fitted by ``chip_smoke.py``
(phase 8) to ``torch.cuda.max_memory_allocated()`` of whole cleans (the
worst of the stepwise and fused loops) at two shapes of the same cube bytes,
256 x 1024 x 1024 and 2048 x 1024 x 128: ``PEAK_CUBE_FACTOR`` cubes plus
``PER_PROFILE_BYTES`` for each (subint, channel) profile (the weight and
score maps, the scalers' sort keys and indices, the fused loop's mask
history at the default ``max_iter``; a larger ``max_iter`` adds 4 bytes per
profile per iteration to the fused loop).  Both shapes cut the FFT
diagnostic into 8 pieces (1/8 cube of complex output and workspace); a
larger cube has a smaller share of it, so the estimate stays an upper bound
for every cube of at least 2^28 elements (1 GiB f32).  A smaller cube's FFT share is larger (up to about 2.5 cubes
for one piece), but such a cube is far below any card's memory.
The multi-device reroute (``maybe_clean_sharded``, ``single_archive_mesh``)
belongs to a later slice; on one card it declines in the JAX package too.

The directory batch has no JAX counterpart here (the JAX package fits a
bucket by spreading it over ``dp``): on one card a bucket is cut into
dispatches of at most :func:`archives_per_dispatch` archives, each sized by
:func:`batch_working_set_bytes` before it runs.  The threshold sweep
(``models/sweep.py``) sizes its pairs the same way, one plain-route archive
per pair (the cube counted once per pair, though the pairs share it).
"""

from __future__ import annotations

import torch

from iterative_cleaner_tpu_torch.ingest.pipeline import stream_depth
from iterative_cleaner_tpu_torch.obs import memory as obs_memory

#: Peak device bytes of one clean in cube-sized units, per route, fitted by
#: chip_smoke.py on an NVIDIA H100 80GB HBM3, 700.00 W (2.3125 and 6.0000,
#: rounded up; PERF.md).  "kernel" is the CUDA fit/moments route (the cube,
#: the centred cube, one FFT piece's complex output, workspace and
#: magnitudes); "plain" the plain PyTorch route (the model and residual
#: cubes, the weighted and centred cubes and the squared deviations on top).
PEAK_CUBE_FACTOR = {"kernel": 2.32, "plain": 6.01}

#: Peak device bytes per (subint, channel) profile on top of the cubes, per
#: route, fitted with PEAK_CUBE_FACTOR (same card, same run: 55.50 and
#: 49.00, rounded up).
PER_PROFILE_BYTES = {"kernel": 64, "plain": 64}

#: The ``max_iter`` of those cleans: the fused loop's (max_iter + 1)-row
#: mask history is inside PER_PROFILE_BYTES up to it.
FIT_MAX_ITER = 5

#: Fraction of the card's memory treated as usable (the CUDA context, the
#: caching allocator's fragmentation and the library workspaces).
HBM_USABLE_FRACTION = 0.9


def device_memory_bytes(device=None) -> int | None:
    """Memory capacity of ``device`` — ``obs.memory.device_memory_bytes``,
    the one owner of the card's memory reads: the ``ICT_HBM_BYTES``
    override first, then the card's total; None on the CPU."""
    return obs_memory.device_memory_bytes(device)


def _route(use_kernel: bool) -> str:
    return "kernel" if use_kernel else "plain"


def working_set_bytes(shape: tuple[int, ...], itemsize: int = 4,
                      use_kernel: bool = True, history_rows: int = 0) -> int:
    """Estimated peak device bytes for cleaning one cube of ``shape`` on
    the kernel route or the plain route; ``history_rows`` more (nsub,
    nchan) float32 rows of the fused loop's mask history than the fit
    saw."""
    profiles = 1
    for dim in shape[:-1]:
        profiles *= int(dim)
    route = _route(use_kernel)
    return (int(profiles * int(shape[-1]) * itemsize * PEAK_CUBE_FACTOR[route])
            + profiles * (PER_PROFILE_BYTES[route] + 4 * max(0, int(history_rows))))


def clean_working_set_bytes(shape: tuple[int, ...], cfg, use_kernel: bool) -> int:
    """:func:`working_set_bytes` of an in-memory clean with ``cfg``: the
    fused loop keeps ``max_iter + 1`` mask rows on the device."""
    rows = int(cfg.max_iter) - FIT_MAX_ITER if cfg.fused else 0
    return working_set_bytes(shape, 4, use_kernel, rows)


def block_subints(shape: tuple[int, ...], hbm: int, use_kernel: bool = True,
                  itemsize: int = 4, depth: int | None = None) -> int:
    """Subints per streamed block: the usable budget, less the whole cube's
    per-profile maps, split between the ``depth`` device slabs the uploader
    keeps live (default ``ICT_INGEST_DEPTH``), each with a block's working
    set; at least 1, at most ``nsub``."""
    depth = stream_depth() if depth is None else max(1, int(depth))
    route = _route(use_kernel)
    profiles = 1
    for dim in shape[:-1]:
        profiles *= int(dim)
    usable = hbm * HBM_USABLE_FRACTION - profiles * PER_PROFILE_BYTES[route]
    per_sub = 1
    for dim in shape[1:]:
        per_sub *= int(dim)
    per_sub = int(per_sub * itemsize * PEAK_CUBE_FACTOR[route])
    block = int(usable / depth // per_sub)
    return max(1, min(block, int(shape[0])))


def chunk_block_subints(shape: tuple[int, ...], cfg, device=None,
                        want_residual: bool = False) -> int | None:
    """Subint slab size for the single-device streaming backend
    (:class:`.chunked.ChunkedTorchCleaner`), or None when the cube's working
    set fits the device (or its memory is unknown, as on the CPU)."""
    from iterative_cleaner_tpu_torch.ops.fused_kernels import resolve_use_kernel

    hbm = device_memory_bytes(device)
    if hbm is None:
        return None
    use_kernel = resolve_use_kernel(
        cfg, int(shape[-1]), "cuda" if device is None else device, want_residual)
    if clean_working_set_bytes(shape, cfg, use_kernel) <= hbm * HBM_USABLE_FRACTION:
        return None
    # The chunked route runs the loop stepwise: no device history.
    return block_subints(shape, hbm, use_kernel)


def batch_working_set_bytes(shape: tuple[int, ...], cfg, use_kernel: bool,
                            narch: int) -> int:
    """Estimated peak device bytes of one batched dispatch of ``narch``
    archives of ``shape``: ``narch`` times the route's per-archive estimate,
    plus the batched loop's (narch, max_iter + 1, nsub, nchan) float32 mask
    history on top."""
    profiles = 1
    for dim in shape[:-1]:
        profiles *= int(dim)
    per_archive = (working_set_bytes(shape, 4, use_kernel)
                   + (int(cfg.max_iter) + 1) * profiles * 4)
    return int(narch) * per_archive


def archives_per_dispatch(shape: tuple[int, ...], cfg, device=None) -> int | None:
    """The most archives of ``shape`` one batched dispatch may take on
    ``device``: the largest count whose :func:`batch_working_set_bytes`
    stays within HBM_USABLE_FRACTION of the device's memory (the
    ``ICT_HBM_BYTES`` override included).  0 when one archive alone does
    not fit; None where the device reports no limit (the CPU)."""
    from iterative_cleaner_tpu_torch.ops.fused_kernels import resolve_use_kernel

    dev = torch.device("cuda" if device is None else device)
    hbm = device_memory_bytes(dev)
    if hbm is None:
        return None
    use_kernel = resolve_use_kernel(cfg, int(shape[-1]), dev)
    one = batch_working_set_bytes(shape, cfg, use_kernel, 1)
    return int(hbm * HBM_USABLE_FRACTION // one)
