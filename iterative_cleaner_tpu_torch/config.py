"""Cleaning configuration of the PyTorch port.

A copy of ``iterative_cleaner_tpu/config.py:20-193`` (``CleanConfig``,
``pulse_region_active``, ``pulse_region_bin_scale``, ``warn_zero_threshold``)
with the port's differences:

- ``backend`` is one of ``numpy`` (the oracle) and ``torch``;
- the tri-state ``pallas`` becomes ``kernel``: None = auto (the hand-written
  CUDA fit/moments kernel wherever it can run, see
  ``ops/fused_kernels.resolve_use_kernel``), True = forced on, False = the
  plain PyTorch route.  It selects the fit/moments step only: the template
  is summed by ``ops/template.build_template`` in the oracle's order on
  every route (on the card its CUDA kernel ``csrc/ordered_template.cu``);
- ``trace_dir`` names a ``torch.profiler`` capture (``--trace``);
- ``sharded_batch`` (the directory batch on one card) requires the torch
  backend and may take the kernel: with no mesh to split the batch over,
  the JAX package's reason to keep its Pallas kernel off the batch does not
  apply;
- ``x64`` and ``print_zap`` keep their fields (so a JAX config maps across
  field for field) but are rejected when set: not yet ported.

Note on ``pulse_region``: the reference's help text claims the order is
``(pulse_start, pulse_end, scaling_factor)`` but the code reads
``[scale, start, end]``.  The code semantics are the ones replicated.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

#: Options whose routes exist only in the JAX package so far.
NOT_YET_PORTED = ("x64", "print_zap")


def pulse_region_active(pulse_region) -> bool:
    """The reference's disable gate: ``pulse_region != [0, 0, 1]``."""
    return tuple(float(v) for v in pulse_region) != (0.0, 0.0, 1.0)


def pulse_region_bin_scale(nbin: int, pulse_region, dtype="float32") -> np.ndarray:
    """Per-bin residual scale implementing the reference's
    ``err2[int(start):int(end)] *= scale`` with its true argument order
    [scale, start, end], built with a real Python slice so negative or
    out-of-range indices behave exactly like the reference."""
    scale, start, end = pulse_region
    bin_scale = np.ones(nbin, dtype=dtype)
    bin_scale[int(start):int(end)] = scale
    return bin_scale


def warn_zero_threshold(stacklevel: int = 2) -> None:
    """The reference accepts thresh=0 (every |scaled|/0 becomes inf/NaN), so
    the port does too, with a warning: 0/0 ties break differently between
    numpy.ma's mixed f32/f64 pipeline and a uniform f32 pipeline."""
    import warnings

    warnings.warn(
        "a threshold of exactly 0 divides every scaled diagnostic by zero; "
        "results are degenerate and mask parity vs the numpy oracle is not "
        "guaranteed", stacklevel=stacklevel + 1)


@dataclass(frozen=True)
class CleanConfig:
    # --- algorithm parameters (reference flags) ---
    chanthresh: float = 5.0        # -c
    subintthresh: float = 5.0      # -s
    max_iter: int = 5              # -m (must be >= 1)
    pulse_region: tuple[float, float, float] = (0.0, 0.0, 1.0)  # -r: (scale, start, end)
    bad_chan: float = 1.0          # --bad_chan
    bad_subint: float = 1.0        # --bad_subint

    # --- output / driver policy (reference flags) ---
    output: str = ""               # -o: '' = <orig>_cleaned, 'std' = NAME.FREQ.MJD
    pscrunch: bool = False         # -p
    memory: bool = False           # --memory (no-op: the input is never mutated)
    unload_res: bool = False       # -u
    print_zap: bool = False        # -z (not yet ported)
    quiet: bool = False            # -q
    no_log: bool = False           # -l

    # --- port extensions ---
    backend: str = "numpy"         # {'numpy', 'torch'}
    fused: bool = False            # torch: the whole loop on the device, one host read per iteration
    kernel: bool | None = None     # None = auto, True = forced, False = plain route
    x64: bool = False              # not yet ported
    sharded_batch: bool = False    # clean same-shape archives together, one launch per iteration
    auto_shard: bool = True        # stream a cube through the device when it exceeds device memory
    chunk_block: int = 0           # force the single-device streaming backend
                                   # with this subint block size (0 = automatic)
    incremental_template: bool = True  # carry the template across iterations
    stream: bool = False           # sharded_batch: dispatch buckets as loads complete
    resume: bool = False           # skip archives whose cleaned output exists
    dump_masks: bool = False       # save the mask history next to the output
    audit: bool = False            # compare the final mask with the numpy oracle
    trace_dir: str = ""            # torch.profiler capture directory (--trace)

    def __post_init__(self) -> None:
        if self.max_iter < 1:
            raise ValueError(f"max_iter must be >= 1, got {self.max_iter}")
        if self.chanthresh == 0 or self.subintthresh == 0:
            warn_zero_threshold(stacklevel=3)
        if self.backend not in ("numpy", "torch"):
            raise ValueError(f"unknown backend {self.backend!r}")
        for name in NOT_YET_PORTED:
            if getattr(self, name):
                raise ValueError(
                    f"{name} is not yet ported to the PyTorch package; use "
                    f"iterative_cleaner_tpu for it")
        if self.fused and self.backend != "torch":
            raise ValueError("fused=True requires backend='torch'")
        if self.chunk_block < 0:
            raise ValueError(f"chunk_block must be >= 0, got {self.chunk_block}")
        if self.chunk_block and self.backend != "torch":
            raise ValueError("chunk_block requires backend='torch'")
        if self.kernel and self.backend != "torch":
            raise ValueError("kernel=True requires backend='torch'")
        if self.sharded_batch and self.backend != "torch":
            raise ValueError("sharded_batch=True requires backend='torch'")
        if self.chunk_block and self.sharded_batch:
            # The batch never routes through the single-cube chunked
            # backend; rejecting beats silently ignoring the flag.
            raise ValueError("chunk_block is not supported with "
                             "sharded_batch=True; drop one of them")
        if self.stream and not self.sharded_batch:
            raise ValueError("stream=True only applies to sharded_batch=True")
        if self.kernel and self.unload_res:
            # The kernel never materialises the residual cube.
            raise ValueError("kernel=True cannot produce the residual "
                             "archive; drop --unload_res or --kernel")
        if len(self.pulse_region) != 3:
            raise ValueError("pulse_region must have exactly 3 elements")
        object.__setattr__(self, "pulse_region", tuple(float(v) for v in self.pulse_region))

    def replace(self, **kw) -> "CleanConfig":
        return dataclasses.replace(self, **kw)

    def namespace_repr(self, archives: list[str]) -> str:
        """An argparse.Namespace-style repr, for clean.log parity with the
        reference log format."""
        fields = [
            ("archive", archives),
            ("chanthresh", self.chanthresh),
            ("subintthresh", self.subintthresh),
            ("max_iter", self.max_iter),
            ("print_zap", self.print_zap),
            ("unload_res", self.unload_res),
            ("pscrunch", self.pscrunch),
            ("quiet", self.quiet),
            ("no_log", self.no_log),
            ("pulse_region", list(self.pulse_region)),
            ("output", self.output),
            ("memory", self.memory),
            ("bad_chan", self.bad_chan),
            ("bad_subint", self.bad_subint),
            ("backend", self.backend),
            ("fused", self.fused),
            ("kernel", self.kernel),
            ("x64", self.x64),
            ("sharded_batch", self.sharded_batch),
            ("chunk_block", self.chunk_block),
            ("incremental_template", self.incremental_template),
        ]
        inner = ", ".join(f"{k}={v!r}" for k, v in fields)
        return f"Namespace({inner})"
