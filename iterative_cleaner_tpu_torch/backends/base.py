"""Backend protocol: one cleaning iteration as an array function.

A copy of ``iterative_cleaner_tpu/backends/base.py``.  A backend owns the
static inputs (the preprocessed cube ``D`` and the frozen original weights
``w0``) and exposes ``step``: given the previous iteration's weights, which
shape the template and nothing else, produce the outlier scores and the next
weight matrix as host arrays.
"""

from __future__ import annotations

from typing import Protocol

import numpy as np

from iterative_cleaner_tpu_torch.config import CleanConfig


class CleanerBackend(Protocol):
    def step(self, w_prev: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """w_prev (nsub, nchan) → (test_results, new_weights), with
        ``new_weights = where(test_results >= 1, 0, w0)``; NaN never flags."""
        ...

    def residual(self) -> np.ndarray | None:
        """The last step's unweighted residual ``amp*template - D`` in the
        dedispersed frame, or None if no step has run (or the route does not
        materialise it)."""
        ...


def make_backend(D: np.ndarray, w0: np.ndarray, cfg: CleanConfig,
                 device="cuda") -> CleanerBackend:
    """The stepwise backend ``cfg.backend`` names; the torch backend runs on
    ``device`` (default the card; raises when there is none), the numpy
    oracle ignores it."""
    if cfg.backend == "numpy":
        from iterative_cleaner_tpu_torch.backends.numpy_backend import NumpyCleaner

        return NumpyCleaner(D, w0, cfg)
    from iterative_cleaner_tpu_torch.backends.torch_backend import TorchCleaner

    return TorchCleaner(D, w0, cfg, device=device)
