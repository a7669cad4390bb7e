"""Multi-process batch dispatch: each rank cleans its slice of the paths.

Port of ``iterative_cleaner_tpu/parallel/multihost.py:25-58``.  Archives
are embarrassingly parallel, so every process runs the same CLI over the
same directory and takes its round-robin slice of the path list
(``driver.run`` and ``driver.run_sweep`` with the torch backend); nothing
crosses processes but the job launch, and ``driver.write_report`` gives
each process's report a ``.p{rank}`` suffix.

Each process batches its slice over its own devices (:func:`local_mesh`,
the rank's devices under a process group: the JAX package's per-host
deployment).  For one cube too big for one host, a mesh over the ranks
and their devices (``parallel/mesh.make_mesh`` after
``initialize_distributed``) shards it over subints, and
``parallel/sharded.sharded_clean`` returns every rank the whole result
(``parallel/collectives.py`` carries the traffic).

The process group is the caller's: :func:`process_topology` only reads
it, as the JAX package's caller runs ``jax.distributed.initialize``
before partitioning.
"""

from __future__ import annotations

import torch.distributed as dist


def process_topology() -> tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) when none
    is initialized.  Initializes nothing."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def partition_paths(
    paths: list[str],
    process_index: int | None = None,
    process_count: int | None = None,
) -> list[str]:
    """This process's slice of a directory batch (round-robin, so ranks stay
    balanced when archives are listed in size order)."""
    if process_index is None or process_count is None:
        pi, pc = process_topology()
        process_index = pi if process_index is None else process_index
        process_count = pc if process_count is None else process_count
    if not 0 <= process_index < process_count:
        raise ValueError(
            f"process_index {process_index} not in [0, {process_count})")
    return paths[process_index::process_count]


def local_mesh(device="cuda", **kw):
    """A mesh over this process's devices (the JAX module's ``:50-58``):
    every local card for ``cuda`` (``parallel/autoshard.default_devices``),
    the one card of ``cuda:N``, or ``cpu``.  Under a process group, this
    rank's devices (``parallel/mesh.rank_devices``): the normal
    multi-process deployment, one in-process mesh per rank over its slice
    of the paths."""
    from iterative_cleaner_tpu_torch.parallel import autoshard
    from iterative_cleaner_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(devices=autoshard.default_devices(device), **kw)
