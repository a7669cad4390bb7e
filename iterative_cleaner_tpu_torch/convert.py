"""Carry state across from the JAX package.

The cleaner has no model weights: its parameters are the configuration and
the (D, w0, template) state.  These two functions take the JAX package's
forms — ``dataclasses.asdict`` of its ``CleanConfig``, and numpy arrays —
and give the port's, so one input can drive both packages.  Nothing here
imports the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from iterative_cleaner_tpu_torch.backends.torch_backend import to_device
from iterative_cleaner_tpu_torch.config import CleanConfig


def config_from_jax(fields: dict) -> CleanConfig:
    """The port's CleanConfig for ``dataclasses.asdict`` of the JAX one:
    ``backend="jax"`` becomes ``"torch"``, ``pallas`` becomes ``kernel``;
    ``trace_dir`` keeps its directory, where the port writes a
    ``torch.profiler`` capture instead of a ``jax.profiler`` one.
    Options whose routes are not yet ported raise (in CleanConfig) when set;
    an unknown field raises here."""
    fields = dict(fields)
    if "pallas" in fields:
        fields["kernel"] = fields.pop("pallas")
    if fields.get("backend") == "jax":
        fields["backend"] = "torch"
    known = {f.name for f in dataclasses.fields(CleanConfig)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"fields with no counterpart in the port: {unknown}")
    if "pulse_region" in fields:
        fields["pulse_region"] = tuple(fields["pulse_region"])
    return CleanConfig(**fields)


def state_from_numpy(D, w0, template=None, *, device):
    """(D, w0[, template]) as numpy arrays → the port's device tensors
    (D, w0, valid, template): float32 and contiguous, ``valid = w0 != 0``,
    ``template`` None when not given."""
    dev = torch.device(device)
    D_t, w0_t = to_device(D, dev), to_device(w0, dev)
    return D_t, w0_t, w0_t != 0, None if template is None else to_device(template, dev)
