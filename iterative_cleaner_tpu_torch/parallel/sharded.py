"""Multi-archive execution: a leading archive axis on one device.

Port of ``iterative_cleaner_tpu/parallel/sharded.py:28-161``.  The JAX
package vmaps the single-archive loop over a leading archive axis and lays
the batch out on a ('dp', 'sp', 'tp') mesh.  The port runs the batch on one
card (``parallel/mesh.py``), where the vmap becomes the archive axis
written out:

- each iteration builds one dense template per archive
  (``ops/template.build_templates``), launches the fit/moments kernel once
  over all archives (the leading grid axis of ``csrc/fused_fit_moments.cu``)
  or runs the plain route, then the FFT diagnostic (each archive in its own
  pieces), the robust scalers (every median within its archive) and the zap
  rule — ``backends/torch_backend.step_from_template`` on batched tensors;
- the vmapped ``lax.while_loop`` runs until every archive has stopped or
  ``max_iter`` is reached.  An archive that stopped keeps its scores,
  weights, ``loops``, ``done`` and ``x`` frozen at its own stop and its
  history rows are not written again (JAX selects the old carry for it);
  here an ``active`` mask on the device and ``torch.where`` do the same.
  Each archive's result equals ``fused_clean`` on that archive alone with a
  dense template.

The template is dense every iteration: ``batched_fused_clean`` in the JAX
package passes no ``incremental`` (a vmapped ``lax.cond`` would run both
branches), and neither does the port.

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
    step_from_template,
)
from iterative_cleaner_tpu_torch.config import CleanConfig
from iterative_cleaner_tpu_torch.ops.template import build_templates


def batched_clean_step(Db, w0b, validb, w_prevb, chanthresh, subintthresh, *,
                       pulse_region, use_kernel=False):
    """One iteration for a batch of archives, ``(a, nsub, nchan, nbin)``
    cubes: a dense template per archive from ``w_prevb``, then the step.
    Returns (test, new_w, resid); resid is None on the kernel route."""
    return step_from_template(
        Db, w0b, validb, build_templates(Db, w_prevb), chanthresh, subintthresh,
        pulse_region=pulse_region, use_kernel=use_kernel)


def batched_fused_clean(Db, w0b, validb, chanthresh, subintthresh, *,
                        max_iter, pulse_region, use_kernel=False):
    """The whole convergence loop for a batch, on the device.

    ``chanthresh`` / ``subintthresh`` are floats, or ``(a,)`` tensors of one
    pair per archive: the threshold sweep (``models/sweep.py``) runs a grid
    as a batch of one cube broadcast over a pair axis (``D.expand``, no
    copy).  Runs until every archive has stopped (its new mask repeated one in its
    history) or ``max_iter`` iterations.  Nothing of (a, nsub, nchan) size
    goes to the host inside the loop; each iteration but the last reads the
    host once, for ``active.any()``.  Returns device tensors
    ``(test, w_final, loops, done, x, None, history)`` in the JAX package's
    order: scores and final weights ``(a, nsub, nchan)``; ``loops``,
    ``done`` and the per-archive iteration count ``x`` as ``(a,)``; the
    residual slot (never carried); the mask history
    ``(a, max_iter + 1, nsub, nchan)`` with the pre-loop weights in row 0
    and rows ``0..x[j]`` of archive ``j`` populated.
    """
    narch, nsub, nchan = w0b.shape
    dev = w0b.device
    history = torch.zeros((narch, max_iter + 1, nsub, nchan), dtype=w0b.dtype, device=dev)
    history[:, 0] = w0b
    rows = torch.arange(max_iter + 1, device=dev)
    test = torch.zeros_like(w0b)
    w_prev = w0b
    loops = torch.full((narch,), max_iter, dtype=torch.int64, device=dev)
    done = torch.zeros(narch, dtype=torch.bool, device=dev)
    xs = torch.zeros(narch, dtype=torch.int64, device=dev)
    active = torch.ones(narch, dtype=torch.bool, device=dev)
    kw = dict(pulse_region=pulse_region, use_kernel=use_kernel)
    x = 0
    while x < max_iter:
        x += 1
        t_new, new_w, _ = batched_clean_step(
            Db, w0b, validb, w_prev, chanthresh, subintthresh, **kw)
        # Rows 0..x-1 are populated for every archive still active.
        hit = ((rows < x)[None] & (new_w[:, None] == history).flatten(2).all(dim=2)).any(dim=1)
        live = active[:, None, None]
        # A stopped archive's row x stays unwritten, as under vmap.
        history[:, x] = torch.where(live, new_w, history[:, x])
        test = torch.where(live, t_new, test)
        w_prev = torch.where(live, new_w, w_prev)
        stop = active & hit
        loops = torch.where(stop, x, loops)
        done = done | stop
        xs = torch.where(active, x, xs)
        active = active & ~hit
        if x < max_iter and not bool(active.any()):   # the host read
            break
    return test, w_prev, loops, done, xs, None, history


def shard_batch(Db, w0b, mesh):
    """Upload a same-shape batch to the mesh's device.  ``Db`` and ``w0b``
    are stacked host arrays or sequences of per-archive arrays: each archive
    is copied into its slice of one preallocated device tensor, so the
    bucket is never stacked a second time on the host.  There is no mesh
    layout: the mesh has one device."""
    dev = mesh.device
    cubes, weights = list(Db), list(w0b)
    if len(cubes) != len(weights):
        raise ValueError(f"{len(cubes)} cubes but {len(weights)} weight maps")
    if not cubes:
        raise ValueError("an empty batch")
    shape = tuple(np.shape(cubes[0]))
    out_D = torch.empty((len(cubes), *shape), dtype=torch.float32, device=dev)
    out_w = torch.empty((len(cubes), *shape[:2]), dtype=torch.float32, device=dev)
    for j, (D, w) in enumerate(zip(cubes, weights)):
        if tuple(np.shape(D)) != shape or tuple(np.shape(w)) != shape[:2]:
            raise ValueError(f"archive {j} has shape {np.shape(D)} / {np.shape(w)}; the "
                             f"batch is {shape}: bucket by exact shape, never pad")
        with warnings.catch_warnings():
            # A read-only host array is only read here (torch warns that
            # writing through the wrapping tensor would be undefined).
            warnings.simplefilter("ignore", UserWarning)
            out_D[j].copy_(torch.from_numpy(np.ascontiguousarray(D, np.float32)))
            out_w[j].copy_(torch.from_numpy(np.ascontiguousarray(w, np.float32)))
    return out_D, out_w


def sharded_clean_single(D: np.ndarray, w0: np.ndarray, cfg: CleanConfig, mesh=None):
    """One archive through the batched route.  Returns (test, weights,
    loops, converged)."""
    test, w, loops, done = sharded_clean([D], [w0], cfg, mesh)
    return test[0], w[0], int(loops[0]), bool(done[0])


def sharded_clean(Db, w0b, cfg: CleanConfig, mesh=None, want_history: bool = False):
    """Clean a same-shape batch of preprocessed cubes in one dispatch.

    ``Db`` (a, nsub, nchan, nbin) and ``w0b`` (a, nsub, nchan): stacked host
    arrays or sequences of per-archive arrays.  ``mesh`` defaults to the one
    CUDA device (``make_mesh()``; raises without a card).  The route is the
    kernel's wherever ``resolve_use_kernel`` puts a clean of this shape on
    the device.  Returns host arrays: (test (a,s,c), weights (a,s,c), loops
    (a,), converged (a,)), fetched together once at the end — plus, with
    ``want_history`` (the serving daemon's convergence forensics), the
    per-archive iteration counts (a,) and the mask histories
    (a, max(x) + 1, s, c), rows 0..x[j] of archive j populated (row 0 =
    w0).  Only the populated prefix is fetched, and only on request: it is
    extra host traffic the default path does not pay.
    """
    if mesh is None:
        from iterative_cleaner_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh()
    dev = device_for(mesh.device)
    Dt, w0t = shard_batch(Db, w0b, mesh)
    narch, nsub, nchan, nbin = Dt.shape
    test, w_final, loops, done, _x, _r, _hist = batched_fused_clean(
        Dt, w0t, w0t != 0, float(cfg.chanthresh), float(cfg.subintthresh),
        max_iter=int(cfg.max_iter), pulse_region=tuple(cfg.pulse_region),
        use_kernel=kernel_for(cfg, nbin, dev))
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
