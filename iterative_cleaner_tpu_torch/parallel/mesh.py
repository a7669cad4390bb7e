"""Device mesh for the cleaner's parallel axes: the devices of this
process, or the ranks of a process group and their devices.

Port of ``iterative_cleaner_tpu/parallel/mesh.py:30-89``.  The JAX package
maps its parallelism onto a ('dp', 'sp', 'tp') mesh: archives over ``dp``,
subints over ``sp``, channels over ``tp``, with GSPMD inserting the
collectives.  The port has two kinds of mesh:

- without a process group (or with ``devices`` given and no ``group``), a
  mesh over devices of this process (``make_mesh``, JAX ``:45-78``): by
  default :func:`local_devices`, every card the process sees, as JAX's
  ``jax.local_devices()``; ``dp`` slices take archives round-robin and
  the ``sp`` devices of a slice take contiguous subint blocks, with
  ``parallel/collectives.py`` handing what crosses devices.  An explicit
  ``devices`` list may name a device more than once: logical devices, as
  the JAX tests' ``--xla_force_host_platform_device_count=8`` makes
  several CPU devices.  Such a mesh proves placement and order, not
  speed: its devices share one card's memory and one stream.  A mesh of
  one device runs the directory batch as a leading archive axis
  (``parallel/sharded.py``);
- over a group's ranks and their devices, as a JAX mesh spans the chips
  of several processes: every rank holds the same ``k`` devices
  (:func:`rank_devices`, by default a block of the host's cards), the
  mesh's positions are numbered ``group_rank * k + j`` and laid out
  ``dp``-major, as ``np.asarray(jax.devices()).reshape(dp, sp, tp)`` is.
  The ``dp`` slices take archives round-robin and the ``sp`` positions of
  a slice take contiguous subint blocks.  A slice lies inside one rank
  (``k % sp == 0``: it runs as on a mesh over this process's devices) or
  covers whole ranks (``sp % k == 0``: ``parallel/collectives.py``
  carries what crosses ranks); any other split raises.  Ranks may share
  one card under ``gloo`` (NCCL refuses two ranks on one device); the
  same code runs NCCL across distinct cards;
- ``tp`` (channels) raises on both: the template is one chain of
  dependent adds in the oracle's (subint, channel) order, which a channel
  split would cut into ``nsub * tp`` pieces on alternating devices.
  Summing the template in another order (a cuBLAS matrix-vector product)
  drifts the last scores 5.17e-5 from the oracle's at 256 x 1024 x 1024,
  beyond the 5e-5 bound.  Default extents take :func:`factor_mesh` as the
  JAX package does and fold its ``tp`` share into ``dp``: 8 devices give
  ``(4, 2, 1)``.

:func:`initialize_distributed` is the ranks' entry: it joins the group
from the ``env://`` variables ``torchrun`` sets and records this rank's
devices, which :func:`make_mesh`, ``parallel/autoshard.default_devices``
and ``parallel/multihost.local_mesh`` use.
"""

from __future__ import annotations

import atexit
import datetime
import os
import weakref
from dataclasses import dataclass

import torch
import torch.distributed as dist

AXES = ("dp", "sp", "tp")

#: Seconds a collective (and the group's start) may wait for the other
#: ranks before it raises: a rank that died fails its peers instead of
#: hanging them.
DEFAULT_GROUP_TIMEOUT_S = 300.0

#: This process's devices and its group's timeout, as
#: :func:`initialize_distributed` set them.
_rank_devices: tuple[torch.device, ...] | None = None
_group_timeout_s: float = DEFAULT_GROUP_TIMEOUT_S
_destroy_registered = False


def factor_mesh(n: int) -> tuple[int, int, int]:
    """Split n devices into (dp, sp, tp), favoring dp (archives scale
    embarrassingly), then sp (biggest axis: nsub), then tp."""
    out = [1, 1, 1]
    i = 0
    m = n
    # Peel smallest prime factors, assigning round-robin dp -> sp -> tp.
    while m > 1:
        p = next(p for p in range(2, m + 1) if m % p == 0)
        out[i % 3] *= p
        m //= p
        i += 1
    return tuple(out)


def subint_bounds(nsub: int, sp: int) -> list[tuple[int, int]]:
    """The contiguous ``[lo, hi)`` subint block of each ``sp`` index: the
    first ``nsub % sp`` blocks one subint longer."""
    base, extra = divmod(int(nsub), int(sp))
    out, lo = [], 0
    for k in range(int(sp)):
        hi = lo + base + (1 if k < extra else 0)
        out.append((lo, hi))
        lo = hi
    return out


def _weak(group) -> weakref.ref | None:
    return None if group is None else weakref.ref(group)


def _live(ref: weakref.ref | None):
    if ref is None:
        return None
    group = ref()
    if group is None:
        raise RuntimeError("the mesh's process group was destroyed (destroy_process_group); "
                           "make a new mesh in a new group")
    return group


@dataclass(frozen=True, init=False)
class Mesh:
    """The devices a batch runs on, with the JAX mesh's axis names and
    extents (``shape["dp"]`` etc.).

    A mesh over this process's devices holds them in ``devices``,
    ``dp``-major: the device at position ``i * sp + k`` has coordinates
    ``(i, k)`` (:attr:`grid`).

    A mesh over ranks also holds its process ``group`` and its
    ``backend``, the group's ranks (``group_ranks``, global ranks in group
    order) and this rank's devices (``devices``, the same count ``k`` on
    every rank).  Its positions are numbered ``group_index * k + j``, the
    mesh is the first ``dp*sp`` of them, ``dp``-major.  ``positions`` are
    the ``(dp, sp)`` coordinates of this rank's devices in the mesh, in
    device order (fewer than ``k`` on a rank the mesh's end cuts; none on
    a rank left out of the mesh: it does no device work and receives the
    result), ``coords`` the first of them, and ``sp_group`` the process
    group of the ranks of this rank's ``dp`` slice when that slice spans
    ranks (``sp > k``), else None.

    The mesh refers to its groups weakly: ``torch.distributed`` owns them
    until ``destroy_process_group``.  A group that a mesh kept alive past
    that call would be torn down while the interpreter exits, and gloo's
    teardown there aborts the process at random ("terminate called
    without an active exception").  Reading ``group`` or ``sp_group`` of a
    destroyed group raises."""

    devices: tuple[torch.device, ...]
    shape: dict
    backend: str = ""
    group_ranks: tuple[int, ...] = ()
    coords: tuple[int, int] | None = None
    positions: tuple[tuple[int, int], ...] = ()
    _group: weakref.ref | None = None
    _sp_group: weakref.ref | None = None

    def __init__(self, devices, shape, group=None, backend="", group_ranks=(), coords=None,
                 sp_group=None, positions=()):
        if coords is not None and not positions:
            positions = (tuple(coords),)
        for name, value in (("devices", devices), ("shape", shape), ("backend", backend),
                            ("group_ranks", group_ranks), ("coords", coords),
                            ("positions", positions), ("_group", _weak(group)),
                            ("_sp_group", _weak(sp_group))):
            object.__setattr__(self, name, value)

    @property
    def group(self):
        """The process group of a mesh over ranks, else None."""
        return _live(self._group)

    @property
    def sp_group(self):
        """The process group of this rank's ``dp`` slice when it spans
        ranks, else None."""
        return _live(self._sp_group)

    @property
    def device(self) -> torch.device:
        """This process's first device (where the results meet)."""
        return self.devices[0]

    @property
    def grid(self) -> tuple[tuple[torch.device, ...], ...]:
        """The devices of a mesh over this process's devices as ``dp``
        rows of ``sp``: ``grid[i][k]`` holds subint block ``k`` of ``dp``
        slice ``i``."""
        sp = self.shape["sp"]
        return tuple(self.devices[i * sp:(i + 1) * sp] for i in range(self.shape["dp"]))

    @property
    def is_local(self) -> bool:
        """Whether the mesh is over several devices of this process."""
        return self._group is None and len(self.devices) > 1

    @property
    def spans_ranks(self) -> bool:
        """Whether the mesh is over the ranks of a process group."""
        return self._group is not None

    @property
    def ranks(self) -> tuple[int, ...]:
        """The global ranks in the mesh, ``dp``-major."""
        return self.group_ranks[:-(-self.shape["dp"] * self.shape["sp"] // len(self.devices))]

    def sp_ranks(self, dp_index: int) -> tuple[int, ...]:
        """The global ranks of ``dp`` slice ``dp_index``, in ``sp`` order
        (one rank for a slice inside a rank)."""
        sp, k = self.shape["sp"], len(self.devices)
        return self.group_ranks[dp_index * sp // k:((dp_index + 1) * sp - 1) // k + 1]


def rank_devices() -> list[torch.device]:
    """This process's devices: those :func:`initialize_distributed`
    gave the rank, else ``[cuda]`` (raises without a card)."""
    if _rank_devices is not None:
        return list(_rank_devices)
    from iterative_cleaner_tpu_torch.backends.torch_backend import resolve_device

    return [resolve_device("cuda")]


def rank_device() -> torch.device:
    """This process's first device (:func:`rank_devices`)."""
    return rank_devices()[0]


def rank_cards(local_rank: int, local_world: int | None, n_cards: int) -> list[int]:
    """The indices of the cards a rank takes by default: the contiguous
    block ``[r*k, (r+1)*k)`` with ``r = local_rank`` and ``k = n_cards //
    local_world`` (``LOCAL_WORLD_SIZE`` ranks on the host share its
    ``n_cards`` cards; empty where there are fewer cards than ranks);
    without ``local_world``, card ``local_rank`` alone."""
    if local_world is None:
        return [int(local_rank)]
    if not 0 <= local_rank < local_world:
        raise ValueError(f"LOCAL_RANK {local_rank} not in [0, LOCAL_WORLD_SIZE {local_world})")
    k = int(n_cards) // int(local_world)
    return list(range(local_rank * k, (local_rank + 1) * k))


def local_devices() -> list[torch.device]:
    """This process's cards, ``cuda:0`` to ``cuda:{n-1}`` for the ``n``
    that ``torch.cuda.device_count()`` sees (``CUDA_VISIBLE_DEVICES``
    honoured), each once; raises without a card."""
    from iterative_cleaner_tpu_torch.backends.torch_backend import resolve_device
    from iterative_cleaner_tpu_torch.utils.device_probe import init_watchdog

    resolve_device("cuda")
    # The first device read of a caller that brings no devices (the batch,
    # the daemon, clean_cube's reroute): a wedged driver hangs it, and the
    # watchdog says so (the JAX package's make_mesh does the same).
    with init_watchdog("make_mesh device discovery"):
        n = torch.cuda.device_count()
    return [torch.device("cuda", i) for i in range(n)]


def _indexed(device) -> torch.device:
    """``device``, with ``cuda`` resolved to the current card's index, so
    that the mesh's positions compare with their tensors' devices."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    from iterative_cleaner_tpu_torch.backends.torch_backend import resolve_device

    resolve_device(dev)
    return torch.device("cuda", torch.cuda.current_device())  # ict: backend-init-ok(resolve_device found a card: the caller named it)


def _extents(n: int, dp, sp, tp) -> tuple[int, int, int]:
    if dp is None and sp is None and tp is None:
        dp, sp, tp = factor_mesh(n)
        # The port declines tp: the share factor_mesh gives it goes to dp.
        dp, tp = dp * tp, 1
    dp, sp, tp = dp or 1, sp or 1, tp or 1
    if dp * sp * tp != n:
        raise ValueError(f"dp*sp*tp = {dp * sp * tp} != n_devices = {n}")
    if tp > 1:
        raise NotImplementedError(
            f"tp={tp}: channel sharding would cut the template's chain of adds, in the "
            "oracle's (subint, channel) order, into nsub*tp pieces on alternating ranks; "
            "summed in another order the scores drift past the 5e-5 bound. Shard subints "
            "(sp) and archives (dp)")
    return dp, sp, tp


def make_mesh(n_devices: int | None = None, dp: int | None = None, sp: int | None = None,
              tp: int | None = None, devices=None, group=None) -> Mesh:
    """A ('dp', 'sp', 'tp') mesh over the first ``n_devices`` devices (all
    by default).  Extents default to :func:`factor_mesh` with its ``tp``
    share folded into ``dp``; ``dp*sp*tp`` must equal the device count,
    and ``tp`` must be 1.

    Over ranks when ``group`` is given, or when ``devices`` is not and a
    default process group is initialized: the first ``n_devices``
    positions of the group's ranks × their devices, this rank holding
    ``devices`` or :func:`rank_devices` (the same count on every rank; a
    slice inside one rank or over whole ranks).  Every rank of the group
    must call it, in the same order as its other group calls: it gathers
    the ranks' device counts and makes one ``sp`` group per ``dp`` slice
    that spans ranks.  Otherwise over ``devices`` of this process, by
    default :func:`local_devices` (``devices=["cpu"]`` for the CPU); all
    of one type, a device may be named more than once (logical
    devices)."""
    if group is None and devices is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is not None:
        return _rank_mesh(n_devices, dp, sp, tp, devices, group)
    devices = tuple(_indexed(d) for d in (local_devices() if devices is None else devices))
    n = len(devices) if n_devices is None else int(n_devices)
    if not 1 <= n <= len(devices):
        raise ValueError(f"n_devices = {n} with {len(devices)} devices given")
    devices = devices[:n]
    _one_type(devices)
    return Mesh(devices=devices, shape=dict(zip(AXES, _extents(n, dp, sp, tp))))


def _one_type(devices) -> None:
    if len({d.type for d in devices}) > 1:
        raise ValueError(f"a mesh's devices are of one type, not {[str(d) for d in devices]}")


def _rank_mesh(n_devices, dp, sp, tp, devices, group) -> Mesh:
    group_ranks = tuple(dist.get_process_group_ranks(group))
    devices = tuple(_indexed(d) for d in (rank_devices() if devices is None else devices))
    if not devices:
        raise ValueError("a rank of a mesh holds at least one device")
    _one_type(devices)
    backend = dist.get_backend(group)
    if backend == "nccl" and devices[0].type != "cuda":
        raise ValueError(f"an nccl group runs on CUDA devices, not {devices[0]}")
    k = len(devices)
    counts = [None] * len(group_ranks)
    dist.all_gather_object(counts, k, group=group)
    if len(set(counts)) > 1:
        raise ValueError(f"the group's ranks hold {counts} devices: a mesh over ranks needs "
                         "the same count on every rank")
    n = len(group_ranks) * k if n_devices is None else int(n_devices)
    if not 1 <= n <= len(group_ranks) * k:
        raise ValueError(f"n_devices = {n} with {len(group_ranks)} ranks of {k} device(s) "
                         "in the group")
    dp, sp, tp = _extents(n, dp, sp, tp)
    if k % sp and sp % k:
        raise ValueError(
            f"sp={sp} over ranks of {k} devices: a dp slice lies inside one rank (k % sp == "
            "0) or covers whole ranks (sp % k == 0); this split would give one rank part of "
            "two slices that span ranks, whose template chains and gathers would then "
            "interleave on its one process")
    me = group_ranks.index(dist.get_rank())
    positions = tuple((p // sp, p % sp) for p in range(me * k, min((me + 1) * k, n)))
    sp_group = None
    if sp > k:
        per = sp // k
        timeout = datetime.timedelta(seconds=_group_timeout_s)
        for i in range(dp):
            members = list(group_ranks[i * per:(i + 1) * per])
            g = dist.new_group(members, timeout=timeout, backend=backend)
            if dist.get_rank() in members:
                sp_group = g
    return Mesh(devices=devices, shape=dict(zip(AXES, (dp, sp, tp))), group=group,
                backend=backend, group_ranks=group_ranks,
                coords=positions[0] if positions else None, sp_group=sp_group,
                positions=positions)


def initialize_distributed(backend: str | None = None, device=None, devices=None,
                           timeout_s: float = DEFAULT_GROUP_TIMEOUT_S) -> torch.device:
    """Join the default process group from ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR`` and ``MASTER_PORT`` (``env://``, as ``torchrun`` sets
    them), with a timeout of ``timeout_s`` seconds on the group.  Call once
    per process before any device use.  Returns this rank's first device,
    and records its devices (:func:`rank_devices`) and the timeout for
    :func:`make_mesh` (its ``sp`` groups take the same timeout).  A group
    the process has not destroyed by its exit is destroyed then.

    The rank holds ``devices`` (a list; a card named more than once gives
    logical devices), or ``[device]``.  By default it takes the block of
    cards :func:`rank_cards` gives ``LOCAL_RANK`` (default ``RANK``) of
    ``LOCAL_WORLD_SIZE`` ranks on this host: one card per rank when the
    counts are equal, ``cuda:{LOCAL_RANK}`` without ``LOCAL_WORLD_SIZE``.
    A card that does not exist raises; nothing falls back to the CPU.
    Ranks that share one card say so with ``device="cuda:0"`` (under
    ``gloo``: NCCL refuses two ranks on one device).  ``backend`` defaults
    to ``nccl`` for CUDA devices and ``gloo`` for ``cpu``; it is never
    swapped for another."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"initialize_distributed reads {', '.join(missing)} from the "
                           "environment (env://, as torchrun sets them)")
    if device is not None and devices is not None:
        raise ValueError("pass device= or devices=, not both")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    named = [device] if device is not None else devices
    if named is not None:
        named = [torch.device(d) for d in named]
        if not named or len({d.type for d in named}) > 1:
            raise ValueError(f"a rank holds one or more devices of one type, not "
                             f"{[str(d) for d in named]}")
    if named is None or named[0].type == "cuda":
        from iterative_cleaner_tpu_torch.utils.device_probe import init_watchdog

        with init_watchdog("initialize_distributed"):
            n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if named is None:
                local = int(os.environ.get("LOCAL_RANK", rank))
                local_world = os.environ.get("LOCAL_WORLD_SIZE")
                cards = rank_cards(local, None if local_world is None else int(local_world),
                                   n_cards)
                if not cards:
                    raise RuntimeError(
                        f"rank {rank}: a card for each of LOCAL_WORLD_SIZE={local_world} "
                        f"ranks does not exist (this host has {n_cards} CUDA device(s)); "
                        "ranks that share a card pass device='cuda:0' explicitly")
                named = [torch.device("cuda", i) for i in cards]
            named = [torch.device("cuda", 0 if d.index is None else d.index) for d in named]
            for d in named:
                if d.index >= n_cards:
                    raise RuntimeError(
                        f"rank {rank}: {d} does not exist (this host has {n_cards} CUDA "
                        "device(s)); ranks that share a card pass device='cuda:0' explicitly")
            torch.cuda.set_device(named[0])
    backend = backend or ("nccl" if named[0].type == "cuda" else "gloo")
    if backend == "nccl" and named[0].type != "cuda":
        raise ValueError(f"nccl runs on CUDA devices, not {named[0]}")
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    global _rank_devices, _group_timeout_s, _destroy_registered
    _rank_devices, _group_timeout_s = tuple(named), float(timeout_s)
    if not _destroy_registered:
        atexit.register(_destroy_at_exit)
        _destroy_registered = True
    return named[0]


def _destroy_at_exit() -> None:
    """Destroy the default group, and the groups made in it, while the
    interpreter still runs (as ``jax.distributed`` shuts its client down
    at exit): a group torn down in the interpreter's own teardown can
    abort the process (:class:`Mesh`)."""
    if dist.is_initialized():
        dist.destroy_process_group()
