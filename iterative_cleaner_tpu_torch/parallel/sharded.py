"""Multi-archive execution: a leading archive axis on one device, or a
batch sharded over the devices of this process or the ranks of a process
group.

Port of ``iterative_cleaner_tpu/parallel/sharded.py:28-161``.  The JAX
package vmaps the single-archive loop over a leading archive axis and lays
the batch out on a ('dp', 'sp', 'tp') mesh.  On a one-device mesh
(``parallel/mesh.py``) the vmap becomes the archive axis written out:

- each iteration builds one dense template per archive
  (``ops/template.build_templates``), launches the fit/moments kernel once
  over all archives (the leading grid axis of ``csrc/fused_fit_moments.cu``)
  or runs the plain route, then the FFT diagnostic (each archive in its own
  pieces), the robust scalers (every median within its archive) and the zap
  rule — ``backends/torch_backend.step_from_template`` on batched tensors;
  a batch that repeats one archive on a stride-0 axis (the threshold
  sweep's pairs, before any pair's mask has moved) fits the cube and takes
  its four maps once, and only the scalers and the zap run per archive;
- the vmapped ``lax.while_loop`` runs until every archive has stopped or
  ``max_iter`` is reached.  An archive that stopped keeps its scores,
  weights, ``loops``, ``done`` and ``x`` frozen at its own stop and its
  history rows are not written again (JAX selects the old carry for it);
  here an ``active`` mask on the device and ``torch.where`` do the same.
  Each archive's result equals ``fused_clean`` on that archive alone with a
  dense template.

On a mesh over several devices the ``dp`` slices take the archives
``dp_index::dp`` and the ``sp`` devices (or ranks) of a slice take
contiguous subint blocks (``subint_bounds``); :func:`shard_batch` uploads
each device's part from the host once and never stacks the cube on one
device first.  A slice's step is the chunked route's block step with the
blocks on other devices (``parallel/collectives.py``): the template
continued along the ``sp`` devices in the oracle's order, the four maps of
each block (``parallel/chunked.block_maps``: the kernel route or the plain
one, from the same resolver as every route — the JAX sharded route turns
Pallas off only because GSPMD cannot partition a ``pallas_call``, and a
block is a plain contiguous cube), the maps gathered along subints, then
the scalers, the zap and the cycle test on the whole maps.  The scores are
the one-device batch's bit for bit.

- In one process (:func:`_local_clean`) the scalers run on each slice's
  first device, and the slices run in lockstep like the vmapped loop:
  each iteration issues every device's work, then makes one host read of
  every slice's stop flags, gathered on the mesh's first device.  A slice
  that has stopped is frozen by its ``active`` mask.  The results meet on
  the first device and come back in one fetch; ``want_history`` returns
  the histories, as JAX does on a mesh the process fully addresses.
- Over ranks and their devices (:func:`_rank_clean`) every rank calls
  :func:`sharded_clean` with the same batch and gets the whole host result
  back, as on the JAX package's process-spanning mesh.  A rank runs its
  slices as one process runs its mesh: whole slices inside the rank, or
  its blocks of a slice that spans ranks, where the template is continued
  from rank to rank and every rank of the slice runs the scalers on the
  gathered maps, so they stop together.  A rank's slices run in lockstep
  with one host read an iteration; the ranks loop on their own, and the
  results meet once, at the end; ``want_history`` returns no history
  there, as the JAX package does.

``tp`` stays declined (``parallel/mesh.py``).  The template is dense every
iteration: ``batched_fused_clean`` in the JAX package passes no
``incremental`` (a vmapped ``lax.cond`` would run both branches), and
neither does the port.

Archives are bucketed by *exact* shape.  Zero-weight padding is not
mask-transparent — padded profiles would still enter the mask-blind FFT
diagnostic's plain medians and change real archives' masks — so a batch is
never padded.  ``sharded_clean(want_history=True)`` also fetches the
per-archive iteration counts and the populated prefix of the mask
history: the serving daemon's convergence forensics.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from iterative_cleaner_tpu_torch.backends.torch_backend import (
    device_for,
    kernel_for,
    repeats_first_archive,
    step_from_template,
)
from iterative_cleaner_tpu_torch.config import CleanConfig
from iterative_cleaner_tpu_torch.obs import tracing
from iterative_cleaner_tpu_torch.ops.stats import scale_and_combine
from iterative_cleaner_tpu_torch.ops.template import build_templates
from iterative_cleaner_tpu_torch.parallel import collectives
from iterative_cleaner_tpu_torch.parallel.chunked import block_maps
from iterative_cleaner_tpu_torch.parallel.mesh import make_mesh, subint_bounds


def batched_clean_step(Db, w0b, validb, w_prevb, chanthresh, subintthresh, *,
                       pulse_region, use_kernel=False):
    """One iteration for a batch of archives, ``(a, nsub, nchan, nbin)``
    cubes: a dense template per archive from ``w_prevb``, then the step.
    Returns (test, new_w, resid); resid is None on the kernel route.

    Where all four inputs repeat their first archive (the sweep's first
    iteration: one cube, one mask, the pairs differing only in their
    thresholds), the step is shared: archive 0's template stands for the
    batch's, so :func:`step_from_template` fits the cube and takes its four
    maps once.  Counters ``clean_batch_steps`` (every call) and
    ``clean_batch_shared_steps`` (the shared ones)."""
    templates = build_templates(Db, w_prevb)
    tracing.count("clean_batch_steps")
    if repeats_first_archive(Db, w0b, validb, w_prevb):
        tracing.count("clean_batch_shared_steps")
        templates = templates[:1].expand(templates.shape)
    return step_from_template(
        Db, w0b, validb, templates, chanthresh, subintthresh,
        pulse_region=pulse_region, use_kernel=use_kernel)


def batched_fused_clean(Db, w0b, validb, chanthresh, subintthresh, *,
                        max_iter, pulse_region, use_kernel=False):
    """The whole convergence loop for a batch, on the device.

    ``chanthresh`` / ``subintthresh`` are floats, or ``(a,)`` tensors of one
    pair per archive: the threshold sweep (``models/sweep.py``) runs a grid
    as a batch of one cube broadcast over a pair axis (``D.expand``, no
    copy), so its first iteration is one shared step
    (:func:`batched_clean_step`).  Runs until every archive has stopped (its
    new mask repeated one in its history) or ``max_iter`` iterations.
    Nothing of (a, nsub, nchan) size goes to the host inside the loop; each
    iteration but the last reads the host once, for ``active.any()``.
    Returns device tensors
    ``(test, w_final, loops, done, x, None, history)`` in the JAX package's
    order: scores and final weights ``(a, nsub, nchan)``; ``loops``,
    ``done`` and the per-archive iteration count ``x`` as ``(a,)``; the
    residual slot (never carried); the mask history
    ``(a, max_iter + 1, nsub, nchan)`` with the pre-loop weights in row 0
    and rows ``0..x[j]`` of archive ``j`` populated.
    """
    def step(w_prev):
        return batched_clean_step(Db, w0b, validb, w_prev, chanthresh, subintthresh,
                                  pulse_region=pulse_region, use_kernel=use_kernel)[:2]

    return _converge(step, w0b, max_iter)


def _converge(step, w0b, max_iter):
    """The vmapped ``lax.while_loop`` written out over ``step(w_prev) ->
    (test, new_w)`` on ``(a, nsub, nchan)`` maps: :func:`batched_fused_clean`'s
    loop and return value."""
    return _converge_lockstep([step], [w0b], max_iter)[0]


class _Carry:
    """One batch's loop state on its device: the vmapped loop's carry."""

    def __init__(self, w0b, max_iter):
        narch, nsub, nchan = w0b.shape
        dev = w0b.device
        self.history = torch.zeros((narch, max_iter + 1, nsub, nchan), dtype=w0b.dtype,
                                   device=dev)
        self.history[:, 0] = w0b
        self.rows = torch.arange(max_iter + 1, device=dev)
        self.test = torch.zeros_like(w0b)
        self.w_prev = w0b
        self.loops = torch.full((narch,), max_iter, dtype=torch.int64, device=dev)
        self.done = torch.zeros(narch, dtype=torch.bool, device=dev)
        self.xs = torch.zeros(narch, dtype=torch.int64, device=dev)
        self.active = torch.ones(narch, dtype=torch.bool, device=dev)

    def advance(self, x, t_new, new_w) -> None:
        """Iteration ``x``'s scores and weights, kept where still active."""
        history = self.history
        # Rows 0..x-1 are populated for every archive still active.
        hit = ((self.rows < x)[None]
               & (new_w[:, None] == history).flatten(2).all(dim=2)).any(dim=1)
        live = self.active[:, None, None]
        # A stopped archive's row x stays unwritten, as under vmap.
        history[:, x] = torch.where(live, new_w, history[:, x])
        self.test = torch.where(live, t_new, self.test)
        self.w_prev = torch.where(live, new_w, self.w_prev)
        stop = self.active & hit
        self.loops = torch.where(stop, x, self.loops)
        self.done = self.done | stop
        self.xs = torch.where(self.active, x, self.xs)
        self.active = self.active & ~hit

    def result(self):
        return self.test, self.w_prev, self.loops, self.done, self.xs, None, self.history


def _converge_lockstep(steps, w0bs, max_iter):
    """:func:`_converge` over several batches, each ``steps[j]`` on
    ``w0bs[j]``'s device, advanced together: each iteration issues every
    batch's step, then reads the host once, for whether any archive of any
    batch is still active (the flags gathered on the first batch's
    device).  Returns each batch's :func:`_converge` value."""
    carries = [_Carry(w0b, max_iter) for w0b in w0bs]
    first = w0bs[0].device
    x = 0
    while x < max_iter:
        x += 1
        for carry, step in zip(carries, steps):
            carry.advance(x, *step(carry.w_prev))
        if x < max_iter:
            active = torch.cat(_meet([c.active for c in carries], first))
            if not bool(active.any()):   # the host read
                break
    return [c.result() for c in carries]


def local_clean_step(blocks, w0_blocks, valid_blocks, w0b, validb, w_prev, chanthresh,
                     subintthresh, bounds, *, pulse_region, use_kernel=False, mesh=None,
                     spans=None):
    """One iteration of this process's part of a ``dp`` slice: its blocks
    ``blocks[k] (a, rows_k, nchan, nbin)`` (subints ``bounds[k]``, in
    ``sp`` order, each on its device, with its rows of the original
    weights and valid mask) and the slice's whole ``(a, nsub, nchan)``
    maps on its first device, where (test, new_w) are made.  In one
    process the blocks are the whole slice.  With ``mesh``, a mesh over
    ranks whose slice spans ranks, they are this rank's part of it: the
    template is continued from the slice's rank before and passed on, and
    the rank's maps are gathered with the other ranks' (``spans``: each
    rank's subints); every rank of the slice returns the same (test,
    new_w)."""
    rows = collectives.scatter_rows(w_prev, bounds, [D.device for D in blocks])
    if mesh is None:
        templates = collectives.chain_template(blocks, rows)
    else:
        templates = collectives.continue_template(blocks, rows, mesh)
    maps = [block_maps(D, T, w0k, vk, pulse_region, use_kernel)
            for D, T, w0k, vk in zip(blocks, templates, w0_blocks, valid_blocks)]
    maps = collectives.gather_maps(maps, w0b.device)
    if mesh is not None:
        maps = collectives.all_gather_maps(maps, mesh, spans)
    d_std, d_mean, d_ptp, d_fft = maps
    test = scale_and_combine(d_std, d_mean, d_ptp, d_fft, validb, chanthresh, subintthresh)
    # Zap where test >= 1; NaN never flags.
    new_w = torch.where(test >= 1.0, torch.zeros((), dtype=w0b.dtype, device=w0b.device), w0b)
    return test, new_w


def _upload(cubes, weights, take, subints, weight_rows, device):
    """The archives ``take`` of a batch on ``device``: their subints
    ``[lo, hi)`` and their weights (those rows where ``weight_rows``, else
    whole), each archive copied into its slice of one preallocated
    tensor; the bytes copied count in ``clean_upload_bytes``."""
    lo, hi = subints
    wlo, whi = subints if weight_rows else (0, np.shape(weights[0])[0])
    shape = np.shape(cubes[0])
    out_D = torch.empty((len(take), hi - lo, *shape[1:]), dtype=torch.float32, device=device)
    out_w = torch.empty((len(take), whi - wlo, shape[1]), dtype=torch.float32, device=device)
    for j, src in enumerate(take):
        with warnings.catch_warnings():
            # A read-only host array is only read here (torch warns that
            # writing through the wrapping tensor would be undefined).  Only
            # that warning: the card's sync warnings must reach the route
            # contracts.
            warnings.filterwarnings("ignore", message="The given NumPy array is not writable",
                                    category=UserWarning)
            out_D[j].copy_(torch.from_numpy(np.ascontiguousarray(cubes[src][lo:hi], np.float32)))
            out_w[j].copy_(torch.from_numpy(
                np.ascontiguousarray(weights[src][wlo:whi], np.float32)))
    tracing.count("clean_upload_bytes", float(out_D.nbytes + out_w.nbytes))
    return out_D, out_w


def shard_batch(Db, w0b, mesh):
    """Upload a same-shape batch to this process's devices.  ``Db`` and
    ``w0b`` are stacked host arrays or sequences of per-archive arrays: each
    archive is copied into its slice of one preallocated device tensor, so
    the bucket is never stacked a second time on the host.

    On a one-device mesh, the whole batch.  On a mesh over this process's
    devices, two lists in the mesh's device order: device ``(i, k)`` holds
    the archives ``i::dp`` (none where the batch is shorter than ``dp``),
    their subints and weight rows of block ``k``.  On a mesh over ranks,
    only this rank's part, and of each cube only those subints are read (a
    memory-mapped cube is read in part): with one device, the archives
    ``dp_index::dp``, the subints of its ``sp`` block and those archives'
    whole weight maps (the scalers need every subint's); with several,
    two lists in the rank's device order as on a mesh over this process's
    devices, for the positions the rank holds.  A rank outside the mesh
    uploads nothing and gets ``(None, None)``.  The uploads run in the
    ``clean_upload`` phase."""
    cubes, weights = list(Db), list(w0b)
    if len(cubes) != len(weights):
        raise ValueError(f"{len(cubes)} cubes but {len(weights)} weight maps")
    if not cubes:
        raise ValueError("an empty batch")
    shape = tuple(np.shape(cubes[0]))
    for j, (D, w) in enumerate(zip(cubes, weights)):
        if tuple(np.shape(D)) != shape or tuple(np.shape(w)) != shape[:2]:
            raise ValueError(f"archive {j} has shape {np.shape(D)} / {np.shape(w)}; the "
                             f"batch is {shape}: bucket by exact shape, never pad")
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    if (mesh.is_local or mesh.spans_ranks) and sp > shape[0]:
        raise ValueError(f"sp={sp} devices for {shape[0]} subints: a device would hold none")
    bounds = subint_bounds(shape[0], sp)
    with tracing.phase("clean_upload"):
        if not mesh.spans_ranks and not mesh.is_local:
            return _upload(cubes, weights, range(len(cubes)), (0, shape[0]), False, mesh.device)
        if mesh.spans_ranks and mesh.coords is None:
            return None, None
        if mesh.spans_ranks and len(mesh.devices) == 1:
            dp_index, sp_index = mesh.coords
            return _upload(cubes, weights, range(dp_index, len(cubes), dp), bounds[sp_index], False,
                           mesh.device)
        places = (mesh.positions if mesh.spans_ranks
                  else [divmod(p, sp) for p in range(len(mesh.devices))])
        parts = [_upload(cubes, weights, range(i, len(cubes), dp), bounds[k], True, dev)
                 for (i, k), dev in zip(places, mesh.devices)]
        return [D for D, _ in parts], [w for _, w in parts]


def sharded_clean_single(D: np.ndarray, w0: np.ndarray, cfg: CleanConfig, mesh=None):
    """One archive through the batched route (on a mesh over ranks: its
    subints over the ``sp`` ranks).  Returns (test, weights, loops,
    converged)."""
    test, w, loops, done = sharded_clean([D], [w0], cfg, mesh)
    return test[0], w[0], int(loops[0]), bool(done[0])


def sharded_clean(Db, w0b, cfg: CleanConfig, mesh=None, want_history: bool = False):
    """Clean a same-shape batch of preprocessed cubes in one dispatch.

    ``Db`` (a, nsub, nchan, nbin) and ``w0b`` (a, nsub, nchan): stacked host
    arrays or sequences of per-archive arrays.  ``mesh`` defaults to
    ``make_mesh()``: the ranks of the default process group when one is
    initialized, else this process's cards (raises without a card).  The
    route is the kernel's wherever ``resolve_use_kernel`` puts a clean of
    this shape on the device.  Returns host arrays: (test (a,s,c), weights
    (a,s,c), loops (a,), converged (a,)), fetched together once at the end
    — plus, with ``want_history`` (the serving daemon's convergence
    forensics), the per-archive iteration counts (a,) and the mask
    histories (a, max(x) + 1, s, c), rows 0..x[j] of archive j populated
    (row 0 = w0).  Only the populated prefix is fetched, and only on
    request: it is extra host traffic the default path does not pay.

    On a mesh over ranks every rank of the mesh's group — those left out
    of the mesh too — calls this with the same batch and gets the whole
    result; ``want_history`` then gives ``None`` for both history slots:
    the fetch is asked for by per-process telemetry settings, and a
    collective that some ranks call and others do not hangs them all.
    """
    if mesh is None:
        mesh = make_mesh()
    if mesh.spans_ranks:
        out = _rank_clean(Db, w0b, cfg, mesh)
        return (*out, None, None) if want_history else out
    if mesh.is_local:
        return _local_clean(Db, w0b, cfg, mesh, want_history)
    dev = device_for(mesh.device)
    Dt, w0t = shard_batch(Db, w0b, mesh)
    narch, nsub, nchan, nbin = Dt.shape
    # No x64 handling, as in the JAX package (its compile_cache.py:52-62):
    # the batch runs float32 and routes as it does without x64.
    use_kernel = kernel_for(cfg.replace(x64=False), nbin, dev)
    with tracing.phase("clean_loop"):
        test, w_final, loops, done, _x, _r, _hist = batched_fused_clean(
            Dt, w0t, w0t != 0, float(cfg.chanthresh), float(cfg.subintthresh),
            max_iter=int(cfg.max_iter), pulse_region=tuple(cfg.pulse_region),
            use_kernel=use_kernel)
        del Dt
        # One fetch: loops, done and x are small integers, exact in float32.
        parts = [test.reshape(-1), w_final.reshape(-1), loops.to(test.dtype),
                 done.to(test.dtype)]
        if want_history:
            parts.append(_x.to(test.dtype))
        packed = torch.cat(parts).cpu().numpy()
    n = narch * nsub * nchan
    out = (packed[:n].reshape(narch, nsub, nchan),
           packed[n:2 * n].reshape(narch, nsub, nchan).copy(),
           packed[2 * n:2 * n + narch].astype(np.int64),
           packed[2 * n + narch:2 * n + 2 * narch].astype(bool))
    if not want_history:
        return out
    x = packed[2 * n + 2 * narch:].astype(np.int64)
    hist = _hist[:, : int(x.max()) + 1].cpu().numpy()
    return (*out, x, hist)


def _local_clean(Db, w0b, cfg: CleanConfig, mesh, want_history: bool):
    """:func:`sharded_clean` on a mesh over this process's devices: every
    ``dp`` slice that holds archives through :func:`local_clean_step`, the
    slices in lockstep (:func:`_converge_lockstep`), then every slice's
    results handed to the mesh's first device and fetched at once."""
    Ds, ws = shard_batch(Db, w0b, mesh)
    narch = len(Db)
    nsub, nchan, nbin = (int(d) for d in np.shape(Db[0]))
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    bounds = subint_bounds(nsub, sp)
    first = device_for(mesh.device)
    use_kernel = kernel_for(cfg.replace(x64=False), nbin, first)
    thresholds = (float(cfg.chanthresh), float(cfg.subintthresh))
    steps, w0s, order = [], [], []
    for i, row in enumerate(mesh.grid):
        blocks, w_blocks = Ds[i * sp:(i + 1) * sp], ws[i * sp:(i + 1) * sp]
        if blocks[0].shape[0] == 0:
            continue   # a batch shorter than dp: this slice holds no archive
        valid_blocks = [w != 0 for w in w_blocks]
        w0t = collectives.gather_maps([(w,) for w in w_blocks], row[0])[0]
        valid = w0t != 0

        def step(w_prev, blocks=blocks, w_blocks=w_blocks, valid_blocks=valid_blocks,
                 w0t=w0t, valid=valid):
            return local_clean_step(blocks, w_blocks, valid_blocks, w0t, valid, w_prev,
                                    *thresholds, bounds, pulse_region=tuple(cfg.pulse_region),
                                    use_kernel=use_kernel)

        steps.append(step)
        w0s.append(w0t)
        order.extend(range(i, narch, dp))
    del Ds
    n = nsub * nchan
    with tracing.phase("clean_loop"):
        outs = _converge_lockstep(steps, w0s, int(cfg.max_iter))
        # One fetch: per archive its scores, its weights, loops, converged
        # and iterations (small integers, exact in float32), in slice order.
        packs = [torch.cat((test.reshape(-1, n), w.reshape(-1, n),
                            loops[:, None].to(test.dtype), done[:, None].to(test.dtype),
                            xs[:, None].to(test.dtype)), dim=1)
                 for test, w, loops, done, xs, _r, _hist in outs]
        packed = torch.cat(_meet(packs, mesh.device)).cpu().numpy()
    rows = np.empty_like(packed)
    rows[order] = packed
    out = (rows[:, :n].reshape(narch, nsub, nchan), rows[:, n:2 * n].reshape(narch, nsub, nchan),
           rows[:, 2 * n].astype(np.int64), rows[:, 2 * n + 1].astype(bool))
    if not want_history:
        return out
    x = rows[:, 2 * n + 2].astype(np.int64)
    hist = np.empty((narch, int(x.max()) + 1, nsub, nchan), dtype=np.float32)
    hist[order] = torch.cat(_meet([h[:, :hist.shape[1]] for *_, h in outs],
                                  mesh.device)).cpu().numpy()
    return (*out, x, hist)


def _meet(parts, device):
    """Each batch's ``parts[j]`` on ``device``, where the first batch's
    already is (on a mesh, the first slice that holds archives is the
    mesh's first row)."""
    return [p if j == 0 else collectives.hand(p, device) for j, p in enumerate(parts)]


def _rank_slices(parts, mesh, nsub):
    """This rank's part of each ``dp`` slice it holds that has archives,
    from :func:`shard_batch`'s ``parts``: (dp index, its blocks, their rows
    of the original weights, the blocks' subint bounds, the slice's whole
    original weights on the first block's device, and the slice's ranks'
    subint spans where it spans ranks, else None).  With several devices
    the whole weights are gathered from the blocks, and across the slice's
    ranks where it spans them."""
    Ds, ws = parts
    if Ds is None:
        return []
    sp, k = mesh.shape["sp"], len(mesh.devices)
    bounds = subint_bounds(nsub, sp)
    spans = ([(bounds[r * k][0], bounds[r * k + k - 1][1]) for r in range(sp // k)]
             if sp > k else None)
    if k == 1:
        i, j = mesh.coords
        lo, hi = bounds[j]
        if Ds.shape[0] == 0:
            return []
        return [(i, [Ds], [ws[:, lo:hi].contiguous()], [bounds[j]], ws, spans)]
    held = {}
    for (i, j), D, w in zip(mesh.positions, Ds, ws):
        blocks, rows, mine = held.setdefault(i, ([], [], []))
        blocks.append(D)
        rows.append(w)
        mine.append(bounds[j])
    out = []
    for i, (blocks, rows, mine) in held.items():
        if blocks[0].shape[0] == 0:
            continue   # a batch shorter than dp: this slice holds no archive
        w0t = collectives.gather_maps([(w,) for w in rows], blocks[0].device)[0]
        if spans is not None:
            w0t = collectives.all_gather_maps((w0t,), mesh, spans)[0]
        out.append((i, blocks, rows, mine, w0t, spans))
    return out


def _rank_clean(Db, w0b, cfg: CleanConfig, mesh):
    """:func:`sharded_clean` on a mesh over ranks: this rank's ``dp``
    slices (whole slices inside the rank, or its part of one that spans
    ranks) through :func:`local_clean_step` in lockstep
    (:func:`_converge_lockstep`) until they have stopped, then every
    slice's results to every rank in one gather."""
    parts = shard_batch(Db, w0b, mesh)
    narch = len(Db)
    nsub, nchan, nbin = (int(d) for d in np.shape(Db[0]))
    dp, sp, k = mesh.shape["dp"], mesh.shape["sp"], len(mesh.devices)
    n = nsub * nchan
    # Per slice the rank holds, per archive: its scores, its weights, loops
    # and converged.
    rows = torch.zeros((max(1, k // sp), -(-narch // dp), 2 * n + 2), dtype=torch.float32,
                       device=device_for(mesh.device))
    slices = _rank_slices(parts, mesh, nsub)
    if slices:
        kw = dict(pulse_region=tuple(cfg.pulse_region),
                  use_kernel=kernel_for(cfg.replace(x64=False), nbin, slices[0][1][0].device),
                  mesh=mesh if sp > k else None)
        thresholds = (float(cfg.chanthresh), float(cfg.subintthresh))
        steps, w0s = [], []
        for _i, blocks, w_blocks, bounds, w0t, spans in slices:
            valid_blocks = [w != 0 for w in w_blocks]
            valid = w0t != 0

            def step(w_prev, blocks=blocks, w_blocks=w_blocks, valid_blocks=valid_blocks,
                     w0t=w0t, valid=valid, bounds=bounds, spans=spans):
                return local_clean_step(blocks, w_blocks, valid_blocks, w0t, valid, w_prev,
                                        *thresholds, bounds, spans=spans, **kw)

            steps.append(step)
            w0s.append(w0t)
        with tracing.phase("clean_loop"):
            outs = _converge_lockstep(steps, w0s, int(cfg.max_iter))
        for (i, *_), (test, w_final, loops, done, *_rest) in zip(slices, outs):
            a = test.shape[0]
            rows[i - mesh.coords[0], :a] = torch.cat(
                (test.reshape(a, n), w_final.reshape(a, n), loops[:, None].to(rows.dtype),
                 done[:, None].to(rows.dtype)), dim=1)
    got = collectives.gather_results(rows, mesh)     # (ranks of the group, *rows.shape)
    out = np.empty((narch, 2 * n + 2), dtype=np.float32)
    for i in range(dp):
        # Slice i's first position is i * sp: on group rank i * sp // k.
        g = i * sp // k
        out[i::dp] = got[g, i - g * k // sp, :len(range(i, narch, dp))]
    return (out[:, :n].reshape(narch, nsub, nchan),
            out[:, n:2 * n].reshape(narch, nsub, nchan),
            out[:, 2 * n].astype(np.int64), out[:, 2 * n + 1].astype(bool))
