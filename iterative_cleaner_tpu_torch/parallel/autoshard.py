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

One oversized archive over several devices: :func:`single_archive_mesh`
(``:101-131`` of the JAX module) gives its subints to the ``sp`` devices
of a one-slice mesh — this process's devices (:func:`default_devices`,
a rank's own under a process group), or the ranks of a process group ×
their devices — which
``parallel/sharded.sharded_clean_single`` cleans; the devices its peel
cannot use stay out, and none goes to ``tp``.  :func:`maybe_clean_sharded`
(``:158-204``) is ``core/cleaner.clean_cube``'s automatic reroute: when
:func:`should_shard` says the cube's working set exceeds one device's
usable memory and the process has more than one device, the cube is
cleaned over them before the chunked route is considered.  On one card it
declines and the cube streams through the chunked route.

The directory batch has no JAX counterpart here (the JAX package fits a
bucket by spreading it over ``dp``): a bucket is cut into dispatches that
give each ``dp`` slice at most :func:`archives_per_dispatch` archives, each
sized by :func:`batch_working_set_bytes` before it runs.  The threshold sweep
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


def default_devices(device="cuda") -> list[torch.device]:
    """The devices a clean on ``device`` may spread over (the JAX module's
    ``:37-56``, ``jax.local_devices()``): for ``cuda`` every card of this
    process (``parallel/mesh.local_devices``), or under a process group
    the rank's devices (``parallel/mesh.rank_devices``), which an
    unindexed name of their type also gives; for ``cuda:N`` that card
    alone; otherwise ``[device]`` (``[cpu]``)."""
    import torch.distributed as dist

    from iterative_cleaner_tpu_torch.parallel.mesh import local_devices, rank_devices

    dev = torch.device(device)
    if dev.index is not None:
        return [dev]
    if dist.is_available() and dist.is_initialized():
        mine = rank_devices()
        return mine if dev.type in ("cuda", mine[0].type) else [dev]
    return local_devices() if dev.type == "cuda" else [dev]


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


def should_shard(shape: tuple[int, ...], device="cuda", n_devices: int | None = None,
                 nbytes: int | None = None) -> bool:
    """True when more than one device is there to spread over (``n_devices``,
    default ``len(default_devices(device))``) and a clean of ``shape``
    will not fit one: its working set ``nbytes`` (default: the kernel
    route's float32 :func:`working_set_bytes`) beyond the usable share of
    the device's memory.  False where that memory is unknown (the CPU
    without ``ICT_HBM_BYTES``), as in the JAX module (``:81-98``)."""
    if n_devices is None:
        n_devices = len(default_devices(device))
    if n_devices < 2:
        return False
    hbm = device_memory_bytes(device)
    if hbm is None:
        return False
    if nbytes is None:
        nbytes = working_set_bytes(shape)
    return nbytes > hbm * HBM_USABLE_FRACTION


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


def single_archive_mesh(shape: tuple[int, ...], n_devices: int | None = None, devices=None):
    """A (dp=1, sp) mesh for one archive of ``shape``, with ``sp`` =
    :func:`subint_ranks` of ``n_devices``: over the first ``sp`` of
    ``devices`` (this process's; default :func:`default_devices`), or,
    with no ``devices`` and a default process group initialized, over the
    first ``sp`` positions of its ranks × their devices (``n_devices``
    defaults to the group's size times the rank's device count; every
    rank of the group calls it, since ``make_mesh`` makes process groups,
    and the ranks left out do no device work and receive the result).
    The devices or ranks the peel cannot use stay out of the mesh.  None
    where ``sp`` is 1: nothing to shard (the JAX package declines there
    too)."""
    import torch.distributed as dist

    from iterative_cleaner_tpu_torch.parallel.mesh import make_mesh, rank_devices

    over_ranks = devices is None and dist.is_available() and dist.is_initialized()
    if not over_ranks and devices is None:
        devices = default_devices()
    if n_devices is None:
        n_devices = (dist.get_world_size() * len(rank_devices()) if over_ranks
                     else len(devices))
    sp = subint_ranks(int(shape[0]), n_devices)
    if sp == 1:
        return None
    if over_ranks:
        return make_mesh(n_devices=sp, dp=1, sp=sp, tp=1, group=dist.group.WORLD)
    return make_mesh(n_devices=sp, dp=1, sp=sp, tp=1, devices=devices)


def maybe_clean_sharded(D, w0, cfg, want_residual: bool, device="cuda"):
    """The automatic reroute (the JAX module's ``:158-204``): a
    ``CleanResult`` when the cube was cleaned over this process's devices
    (:func:`default_devices` of ``device``), None when the caller should
    run a one-device route — the chunked route where
    :func:`chunk_block_subints` says the cube does not fit.

    Declines, as the JAX package does, when the caller needs the residual
    (the sharded loop does not materialise it), under ``x64`` (the
    batched loop runs float32), and where the mesh would be one device (one
    card, or no ``sp`` that divides the subints); the chunked route then
    takes the cube.  The reroute is announced on stderr.  The result has
    no per-loop ``iterations`` and no ``history``: the loop runs on the
    devices, as the fused loop does."""
    import sys

    from iterative_cleaner_tpu_torch.core.cleaner import CleanResult
    from iterative_cleaner_tpu_torch.ops.fused_kernels import resolve_use_kernel
    from iterative_cleaner_tpu_torch.parallel.sharded import sharded_clean_single

    if want_residual or cfg.x64:
        return None
    devices = default_devices(device)
    use_kernel = resolve_use_kernel(cfg, int(D.shape[-1]), devices[0])
    nbytes = clean_working_set_bytes(D.shape, cfg, use_kernel)
    if not should_shard(D.shape, devices[0], len(devices), nbytes):
        return None
    mesh = single_archive_mesh(D.shape, devices=devices)
    if mesh is None:
        # No sp divides the subints: the chunked route announces the cube.
        return None
    kernel = "on" if use_kernel else "off"
    print(f"auto-sharding cube {tuple(D.shape)}: ~{nbytes / 1e9:.1f} GB working set "
          f"exceeds device memory; cleaning sharded over {len(mesh.devices)} devices "
          f"(sp={mesh.shape['sp']}; the fit/moments kernel {kernel} as its resolver says, "
          f"where the JAX package turns Pallas off; no per-loop progress; disable with "
          f"auto_shard=False)", file=sys.stderr)
    test, w_final, loops, done = sharded_clean_single(D, w0, cfg, mesh)
    return CleanResult(weights=w_final, test_results=test, loops=loops, converged=done)
