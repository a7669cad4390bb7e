"""What crosses devices in the sharded clean: the one module that moves a
tensor from one device of a mesh to another.

No JAX counterpart: there GSPMD inserts the collectives from the input
shardings (``iterative_cleaner_tpu/parallel/sharded.py:1-13``).  A device
of a mesh (``parallel/mesh.py``) holds a contiguous subint block of its
``dp`` slice's archives, and each iteration a slice makes two exchanges:

- the template in the oracle's order: block ``k`` continues the running
  ``(a, nbin)`` sum of block ``k-1`` over its subints
  (``ops/template.build_template(..., init=)``, as the chunked route
  continues block after block), and the finished template goes to every
  block.  The hops are serial, so the chain's floor is paid once across
  the devices, as on one card; an all-reduce would sum in another order
  and drift the scores.  Along a process's devices :func:`chain_template`;
  over a slice that spans ranks :func:`continue_template`, which runs the
  chain along the rank's devices between a receive from the rank before
  and a send to the rank after, then a broadcast from the slice's last
  rank;
- the four ``(a, rows, nchan)`` maps gathered along subints in ``sp``
  order: :func:`gather_maps` concatenates a process's blocks on its first
  device of the slice, where the scalers run, and over ranks
  :func:`all_gather_maps` then gathers the ranks' spans to every rank of
  the slice; :func:`scatter_rows` hands each block its rows of the new
  weights.

At the end, over ranks, every rank of the mesh's group calls
:func:`gather_results`, which hands each ``dp`` slice's results to every
rank (the JAX package's ``_to_host``); in one process the slices' results
meet on the mesh's first device (:func:`hand`) for one fetch.

In one process a hop is ``Tensor.to`` the other device (a peer copy
between cards, ordered after both devices' streams, with no host
synchronisation); between logical devices that share a card it hands the
tensor over without a copy.  :data:`traffic` counts every hop's bytes in
``gathered_bytes`` either way (what distinct cards would move) and the
hops that copied in ``peer_copies``.  Nothing is staged through the host.

Between ranks, under ``gloo`` every collective takes host tensors: a
device operand is copied to the host and the result back, here and
nowhere else, and :data:`traffic` counts the copies (``staged_*``).
``gloo``'s support for CUDA tensors differs by operation and by torch
build, so it is never handed one.  Under ``nccl`` device tensors pass as
they are.  Host buffers are made from numpy arrays, so the route
contracts (``analysis/contracts.py``) see them as host data.  A rank's
collectives take tensors on its first device of the slice.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from iterative_cleaner_tpu_torch.ops.template import build_template


@dataclasses.dataclass
class Traffic:
    """This process's collective traffic since the last :meth:`reset`: the
    bytes its receives, broadcasts and gathers delivered to it, its own
    part of a gather included, or in one process the bytes its hops
    between devices delivered (``gathered_bytes``), the hops that copied
    between distinct devices (``peer_copies``), the copies staged through
    the host under gloo (``staged_reads`` device to host,
    ``staged_uploads`` host to device, ``staged_bytes`` both ways) and the
    host seconds spent in :func:`continue_template` (``chain_s``: the
    build, the waits on the ranks before and the hops)."""

    gathered_bytes: int = 0
    peer_copies: int = 0
    staged_reads: int = 0
    staged_uploads: int = 0
    staged_bytes: int = 0
    chain_s: float = 0.0

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, f.default)


traffic = Traffic()


def _stages(t: torch.Tensor, mesh) -> bool:
    return mesh.backend == "gloo" and t.device.type != "cpu"


def _host_array(shape, dtype: torch.dtype) -> np.ndarray:
    return np.empty(shape, dtype=np.dtype(str(dtype).removeprefix("torch.")))


def _operand(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` as the backend takes it: its host copy under gloo."""
    if not _stages(t, mesh):
        return t
    traffic.staged_reads += 1
    traffic.staged_bytes += t.nbytes
    return t.cpu()


def _buffer(like: torch.Tensor, shape, mesh):
    """An empty receive buffer of ``shape`` where the backend writes: a
    host array under gloo (the collective writes through :func:`_wire`),
    else a tensor beside ``like``."""
    if _stages(like, mesh):
        return _host_array(shape, like.dtype)
    return torch.empty(shape, dtype=like.dtype, device=like.device)


def _wire(buf) -> torch.Tensor:
    """The tensor a collective writes ``buf`` through."""
    return torch.from_numpy(buf) if isinstance(buf, np.ndarray) else buf


def _result(buf, like: torch.Tensor) -> torch.Tensor:
    """A received buffer on ``like``'s device: a host array is uploaded,
    through a fresh tensor over it (host data to the route contracts,
    whatever the collective did with the one it wrote through)."""
    if not isinstance(buf, np.ndarray):
        return buf
    traffic.staged_uploads += 1
    traffic.staged_bytes += buf.nbytes
    return torch.from_numpy(buf).to(like.device)


def continue_template(blocks, weights, mesh) -> list[torch.Tensor]:
    """The ``(a, nbin)`` templates of this rank's ``dp`` slice, from its
    blocks ``D_j (a, rows_j, nchan, nbin)`` under weights ``w_j (a,
    rows_j, nchan)`` (in ``sp`` order, each on its device; the first on
    the device the rank's collectives use): the running sum received from
    the slice's rank before, continued along the blocks, passed to the
    rank after.  Every rank of the group returns the finished templates on
    each block's device, bit for bit the one-card build over all
    subints."""
    t0 = time.perf_counter()
    peers = mesh.sp_ranks(mesh.coords[0])
    r = peers.index(dist.get_rank())
    home = blocks[0]
    shape = (home.shape[0], home.shape[-1])
    init = None
    if r > 0:
        buf = _buffer(home, shape, mesh)
        dist.recv(_wire(buf), src=peers[r - 1], group=mesh.sp_group)
        traffic.gathered_bytes += buf.nbytes
        init = _result(buf, home)
    T = _chain(blocks, weights, init)
    if len(blocks) > 1:
        T = hand(T, home.device)
    if r < len(peers) - 1:
        dist.send(_operand(T, mesh), dst=peers[r + 1], group=mesh.sp_group)
    if r == len(peers) - 1:
        dist.broadcast(_operand(T, mesh), src=peers[-1], group=mesh.sp_group)
    else:
        buf = _buffer(home, shape, mesh)
        dist.broadcast(_wire(buf), src=peers[-1], group=mesh.sp_group)
        traffic.gathered_bytes += buf.nbytes
        T = _result(buf, home)
    traffic.chain_s += time.perf_counter() - t0
    return [T] + [hand(T, D.device) for D in blocks[1:]]


def all_gather_maps(maps, mesh, bounds) -> tuple[torch.Tensor, ...]:
    """The ``(a, rows, nchan)`` maps of this rank's span of subints,
    gathered along subints in ``sp`` order to every rank of its ``dp``
    slice: ``(a, nsub, nchan)`` maps.  ``bounds`` are the slice's ranks'
    spans ``[lo, hi)`` (they may differ in length; each is padded to the
    longest for the gather and trimmed after)."""
    local = torch.stack(tuple(maps))                 # (4, a, rows, nchan)
    longest = max(hi - lo for lo, hi in bounds)
    rows = local.shape[2]
    if rows < longest:
        local = torch.cat((local, local.new_zeros(
            (*local.shape[:2], longest - rows, local.shape[3]))), dim=2)
    operand = _operand(local.contiguous(), mesh)
    parts = [_buffer(local, operand.shape, mesh) for _ in bounds]
    dist.all_gather([_wire(p) for p in parts], operand, group=mesh.sp_group)
    traffic.gathered_bytes += sum(p.nbytes for p in parts)
    trimmed = [p[:, :, :hi - lo] for p, (lo, hi) in zip(parts, bounds)]
    full = (np.concatenate(trimmed, axis=2) if _stages(local, mesh)
            else torch.cat(trimmed, dim=2))
    return tuple(_result(full, local).unbind(0))


def gather_results(rows: torch.Tensor, mesh) -> np.ndarray:
    """Every rank's ``rows`` — a tensor of one shape on every rank of the
    mesh's group — to the host of every rank, in group order:
    ``(world, *rows.shape)``.  One collective and one read of the device,
    the run's fetch: under gloo before the gather (not counted as
    staged, since the fetch is made either way), under nccl after it."""
    if mesh.backend != "gloo":
        parts = [torch.empty_like(rows) for _ in mesh.group_ranks]
        dist.all_gather(parts, rows.contiguous(), group=mesh.group)
        traffic.gathered_bytes += sum(p.nbytes for p in parts)
        return torch.stack(parts).cpu().numpy()
    operand = rows.contiguous().cpu()
    parts = [_host_array(operand.shape, operand.dtype) for _ in mesh.group_ranks]
    dist.all_gather([_wire(p) for p in parts], operand, group=mesh.group)
    traffic.gathered_bytes += sum(p.nbytes for p in parts)
    return np.stack(parts)


def hand(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` handed to ``device``, another position of an in-process mesh:
    its bytes counted; copied where ``device`` is not ``t``'s own (a
    logical device on the same card takes ``t`` as it is)."""
    traffic.gathered_bytes += t.nbytes
    if t.device == device:
        return t
    traffic.peer_copies += 1
    return t.to(device)


def _chain(blocks, weights, init=None) -> torch.Tensor:
    """The running ``(a, nbin)`` sum continued from ``init`` along the
    blocks in order, each continuing the one before, handed to its
    device; on the last block's device."""
    T = build_template(blocks[0], weights[0], init=init)
    for D, w in zip(blocks[1:], weights[1:]):
        T = build_template(D, w, init=hand(T, D.device))
    return T


def chain_template(blocks, weights) -> list[torch.Tensor]:
    """The ``(a, nbin)`` templates of a ``dp`` slice of an in-process mesh
    from its ``sp`` devices' blocks ``D_k (a, rows_k, nchan, nbin)`` under
    weights ``w_k (a, rows_k, nchan)``, in ``sp`` order: block ``k``
    continues block ``k-1``'s sum, handed to its device.  Returns the
    finished templates on each block's device, bit for bit the one-card
    build over all subints."""
    T = _chain(blocks, weights)
    last = len(blocks) - 1
    return [T if k == last else hand(T, D.device) for k, D in enumerate(blocks)]


def gather_maps(maps, device: torch.device) -> tuple[torch.Tensor, ...]:
    """The ``(a, rows_k, nchan)`` maps of each block of a process's part
    of a ``dp`` slice (``maps[k]``, in ``sp`` order) concatenated along
    subints on ``device``, the first block's: in one process the slice's
    whole ``(a, nsub, nchan)`` maps, over ranks this rank's span."""
    if len(maps) == 1:
        return tuple(maps[0])
    parts = [m if k == 0 else tuple(hand(x, device) for x in m) for k, m in enumerate(maps)]
    return tuple(torch.cat(ms, dim=1) for ms in zip(*parts))


def scatter_rows(w: torch.Tensor, bounds, devices) -> list[torch.Tensor]:
    """Each block's rows ``[lo, hi)`` of the ``(a, nsub, nchan)`` map ``w``
    (on the slice's first device), on that block's device."""
    return [w[:, lo:hi].contiguous() if k == 0 else hand(w[:, lo:hi].contiguous(), dev)
            for k, ((lo, hi), dev) in enumerate(zip(bounds, devices))]
