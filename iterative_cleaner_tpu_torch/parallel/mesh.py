"""Device mesh for the cleaner's parallel axes.

Port of ``iterative_cleaner_tpu/parallel/mesh.py:30-80``.  The JAX package
maps its parallelism onto a ('dp', 'sp', 'tp') mesh: archives over ``dp``,
subints over ``sp``, channels over ``tp``, with GSPMD inserting the
collectives.  The port runs the directory batch on one card, where the
batch is a leading archive axis and needs no mesh; :func:`factor_mesh` is
kept as it is, and :func:`make_mesh` builds the one-device mesh the batch
runs on.  A mesh over more than one device (``dp`` over several local
cards, ``sp``/``tp`` sharding with NCCL) is queued in ROADMAP.md (queue
A, several cards) and raises until it lands — it never quietly runs on one
card.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

AXES = ("dp", "sp", "tp")


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


@dataclass(frozen=True)
class Mesh:
    """The devices a batch runs on, with the JAX mesh's axis names and
    extents (``shape["dp"]`` etc.)."""

    devices: tuple[torch.device, ...]
    shape: dict

    @property
    def device(self) -> torch.device:
        """The one device of a one-device mesh."""
        return self.devices[0]


def make_mesh(n_devices: int | None = None, dp: int | None = None, sp: int | None = None,
              tp: int | None = None, devices=None) -> Mesh:
    """A ('dp', 'sp', 'tp') mesh over the first ``n_devices`` of
    ``devices``, by default the one CUDA device the caller runs on
    (``cuda``; ``devices=["cpu"]`` for the CPU).  Extents default to
    :func:`factor_mesh`; ``dp*sp*tp`` must equal the device count.  More
    than one device raises NotImplementedError: the multi-device batch is
    not ported yet."""
    if devices is None:
        from iterative_cleaner_tpu_torch.backends.torch_backend import resolve_device

        devices = [resolve_device("cuda")]
    devices = tuple(torch.device(d) for d in devices)
    if n_devices is None:
        n_devices = len(devices)
    if not 1 <= n_devices <= len(devices):
        raise ValueError(f"n_devices = {n_devices} with {len(devices)} devices given")
    devices = devices[:n_devices]
    if dp is None and sp is None and tp is None:
        dp, sp, tp = factor_mesh(n_devices)
    dp, sp, tp = dp or 1, sp or 1, tp or 1
    if dp * sp * tp != n_devices:
        raise ValueError(f"dp*sp*tp = {dp * sp * tp} != n_devices = {n_devices}")
    if n_devices > 1:
        raise NotImplementedError(
            f"a mesh over {n_devices} devices (dp={dp}, sp={sp}, tp={tp}) is not ported "
            "yet (ROADMAP.md queue A, several cards: dp over local cards, sp/tp sharding "
            "with NCCL); the port's batch runs on one device")
    return Mesh(devices=devices, shape=dict(zip(AXES, (dp, sp, tp))))
