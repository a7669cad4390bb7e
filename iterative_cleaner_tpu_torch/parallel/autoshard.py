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
for one piece), but such a cube is far below any card's memory.  Under
``--x64`` every element is 8 bytes: the cubes, the per-profile maps and the
mask history (the FFT pieces are cut by bytes, so the cube factors hold),
as ``iterative_cleaner_tpu/parallel/autoshard.py:142-180`` counts 8-byte
elements.
One oversized archive over the ranks of a process group:
:func:`single_archive_mesh` (``:101-133`` of the JAX module) gives its
subints to the ``sp`` ranks of a one-slice mesh, which
``parallel/sharded.sharded_clean_single`` cleans.  The JAX package's
automatic reroute over the cards of one process (``maybe_clean_sharded``)
is not ported (ROADMAP.md queue A.2); on one card it declines there too.

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
    """Estimated peak device bytes for cleaning one cube of ``shape`` in
    elements of ``itemsize`` bytes (8: ``--x64``) on the kernel route or
    the plain route; ``history_rows`` more (nsub, nchan) rows of the fused
    loop's mask history than the fit saw."""
    profiles = 1
    for dim in shape[:-1]:
        profiles *= int(dim)
    factor, per_profile = _peak_model(use_kernel, itemsize)
    return (int(profiles * int(shape[-1]) * itemsize * factor)
            + profiles * (per_profile + itemsize * max(0, int(history_rows))))


def _peak_model(use_kernel: bool, itemsize: int) -> tuple[float, int]:
    """(cubes, bytes per profile) of a route in elements of ``itemsize``:
    the float32 fit scaled by the element size (chip_smoke.py phase 9
    holds the float64 plain route's peak under it)."""
    route = _route(use_kernel)
    return PEAK_CUBE_FACTOR[route], PER_PROFILE_BYTES[route] * max(1, int(itemsize) // 4)


def itemsize_of(cfg) -> int:
    """Bytes per element of a clean with ``cfg``: 8 under ``x64``, else 4."""
    return 8 if cfg.x64 else 4


def clean_working_set_bytes(shape: tuple[int, ...], cfg, use_kernel: bool) -> int:
    """:func:`working_set_bytes` of an in-memory clean with ``cfg``: the
    fused loop keeps ``max_iter + 1`` mask rows on the device."""
    rows = int(cfg.max_iter) - FIT_MAX_ITER if cfg.fused else 0
    return working_set_bytes(shape, itemsize_of(cfg), use_kernel, rows)


def block_subints(shape: tuple[int, ...], hbm: int, use_kernel: bool = True,
                  itemsize: int = 4, depth: int | None = None) -> int:
    """Subints per streamed block: the usable budget, less the whole cube's
    per-profile maps, split between the ``depth`` device slabs the uploader
    keeps live (default ``ICT_INGEST_DEPTH``), each with a block's working
    set; at least 1, at most ``nsub``."""
    depth = stream_depth() if depth is None else max(1, int(depth))
    factor, per_profile = _peak_model(use_kernel, itemsize)
    profiles = 1
    for dim in shape[:-1]:
        profiles *= int(dim)
    usable = hbm * HBM_USABLE_FRACTION - profiles * per_profile
    per_sub = 1
    for dim in shape[1:]:
        per_sub *= int(dim)
    per_sub = int(per_sub * itemsize * factor)
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
    return block_subints(shape, hbm, use_kernel, itemsize_of(cfg))


def batch_working_set_bytes(shape: tuple[int, ...], cfg, use_kernel: bool,
                            narch: int, itemsize: int = 4) -> int:
    """Estimated peak device bytes of one batched dispatch of ``narch``
    archives of ``shape`` in elements of ``itemsize`` bytes (4: the
    directory batch has no x64 handling; the threshold sweep passes its
    compute type's): ``narch`` times the route's per-archive estimate, plus
    the batched loop's (narch, max_iter + 1, nsub, nchan) mask history on
    top."""
    profiles = 1
    for dim in shape[:-1]:
        profiles *= int(dim)
    per_archive = (working_set_bytes(shape, itemsize, use_kernel)
                   + (int(cfg.max_iter) + 1) * profiles * itemsize)
    return int(narch) * per_archive


def archives_per_dispatch(shape: tuple[int, ...], cfg, device=None) -> int | None:
    """The most archives of ``shape`` one batched dispatch may take on
    ``device``: the largest count whose :func:`batch_working_set_bytes`
    stays within HBM_USABLE_FRACTION of the device's memory (the
    ``ICT_HBM_BYTES`` override included).  0 when one archive alone does
    not fit; None where the device reports no limit (the CPU).  The batch
    ignores ``x64``, as the JAX package's does: float32 and the route it
    takes without it."""
    from iterative_cleaner_tpu_torch.ops.fused_kernels import resolve_use_kernel

    dev = torch.device("cuda" if device is None else device)
    hbm = device_memory_bytes(dev)
    if hbm is None:
        return None
    use_kernel = resolve_use_kernel(cfg.replace(x64=False), int(shape[-1]), dev)
    one = batch_working_set_bytes(shape, cfg, use_kernel, 1)
    return int(hbm * HBM_USABLE_FRACTION // one)


def subint_ranks(nsub: int, n_ranks: int) -> int:
    """The ``sp`` extent of one archive's mesh over ``n_ranks`` ranks: the
    prime factors of ``n_ranks`` peeled, smallest first, while they divide
    ``nsub`` (the JAX package's peel; the factors it would give to ``tp``
    are left out)."""
    sp, m, p = 1, int(n_ranks), 2
    while m > 1 and p <= m:
        if m % p == 0 and int(nsub) % (sp * p) == 0:
            sp *= p
            m //= p
        else:
            p += 1
    return sp


def single_archive_mesh(shape: tuple[int, ...], n_ranks: int | None = None):
    """A (dp=1, sp) mesh over the first ``sp`` ranks of the default process
    group for one archive of ``shape``: ``sp`` = :func:`subint_ranks` of
    ``n_ranks`` (default: the group's size); the other ranks stay out of
    the mesh, do no device work and receive the result.  None where ``sp``
    is 1: nothing to shard (the JAX package declines there too).  Every
    rank of the group calls it: ``make_mesh`` makes process groups."""
    import torch.distributed as dist

    from iterative_cleaner_tpu_torch.parallel.mesh import make_mesh

    if n_ranks is None:
        n_ranks = dist.get_world_size()
    sp = subint_ranks(int(shape[0]), n_ranks)
    if sp == 1:
        return None
    return make_mesh(n_devices=sp, dp=1, sp=sp, tp=1, group=dist.group.WORLD)
