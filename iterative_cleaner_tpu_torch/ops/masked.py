"""Masked reductions — numpy.ma semantics as explicit value+validity.

Port of ``iterative_cleaner_tpu/ops/masked.py:70-179``:

- medians over only the valid entries, even-count averaging, NaN when a line
  has no valid entries;
- ``np.median``'s any-NaN-poisons-the-result rule for the plain (mask-blind)
  FFT diagnostic.

Every median picks exact elements of a sorted prefix.  The order is the one
``jnp.sort`` gives: every ±0.0 ties +0.0, all NaNs tie each other and sort
after +inf, and equal elements keep their index order.  The port reproduces
it with one lowering: a *stable* ``torch.sort`` of integer total-order keys
(int32 for float32, int64 for the ``--x64`` routes' float64), then a gather
of the original elements (NaN payloads and zero signs included).  ``torch.topk`` (tie order on CUDA not guaranteed) and
``torch.median`` (returns the lower middle, never averages) are not used.
"""

from __future__ import annotations

import torch


#: The integer type of a float type's keys, and the mask of its magnitude bits.
_KEY_TYPES = {torch.float32: (torch.int32, 0x7FFFFFFF),
              torch.float64: (torch.int64, 0x7FFFFFFFFFFFFFFF)}  # ict: f64-ok(explicit --x64 opt-in; integer sort keys only, no f64 math)


def _totalorder_keys(x: torch.Tensor) -> torch.Tensor:
    """Monotone integer keys (int32 for float32, int64 for float64)
    reproducing ``jnp.sort``'s float order: ±0.0 and every NaN
    canonicalised, then the sign-magnitude → two's-complement flip.  Equal
    keys ⇔ the sort comparator calls the elements equal."""
    if x.dtype not in _KEY_TYPES:
        raise TypeError(f"total-order keys are defined for float32 and float64, "
                        f"got {x.dtype}")
    ik, mask = _KEY_TYPES[x.dtype]
    xc = torch.where(x == 0, torch.zeros((), dtype=x.dtype, device=x.device), x)
    xc = torch.where(torch.isnan(x),
                     torch.full((), float("nan"), dtype=x.dtype, device=x.device), xc)
    i = xc.view(ik)
    return torch.where(i < 0, i ^ mask, i)


def sort_prefix(x: torch.Tensor, k: int) -> torch.Tensor:
    """``jnp.sort(x, axis=-1)[..., :k]``, bit for bit: a stable sort of the
    total-order keys leaves comparator-equal elements in index order, and
    the gather returns the original elements."""
    idx = torch.sort(_totalorder_keys(x), dim=-1, stable=True).indices[..., :k]
    return torch.gather(x, -1, idx)


def _pick(srt: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    return torch.gather(srt, -1, pos[..., None])[..., 0]


def masked_median(x: torch.Tensor, valid: torch.Tensor, axis: int):
    """Median over valid entries along ``axis`` (np.ma.median semantics).

    Returns (median, n_valid); median is NaN where n_valid == 0.  +inf fill
    at invalid entries, then count-based middle selection with even-count
    averaging; both positions sit in the first ``size//2 + 1`` elements.
    """
    x = torch.movedim(x, axis, -1)
    valid = torch.movedim(valid, axis, -1)
    size = x.shape[-1]
    filled = torch.where(valid, x, torch.full((), float("inf"), dtype=x.dtype, device=x.device))
    srt = sort_prefix(filled, size // 2 + 1)
    n = valid.sum(dim=-1)
    lo = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), 0, size - 1)
    hi = torch.clamp(torch.div(n, 2, rounding_mode="floor"), 0, size - 1)
    med = (_pick(srt, lo) + _pick(srt, hi)) * 0.5
    nan = torch.full((), float("nan"), dtype=x.dtype, device=x.device)
    return torch.where(n > 0, med, nan), n


def nan_propagating_median(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Plain np.median semantics: even-count averaging, NaN if any NaN."""
    x = torch.movedim(x, axis, -1)
    size = x.shape[-1]
    srt = sort_prefix(x, size // 2 + 1)
    med = (srt[..., (size - 1) // 2] + srt[..., size // 2]) * 0.5
    nan = torch.full((), float("nan"), dtype=x.dtype, device=x.device)
    return torch.where(torch.isnan(x).any(dim=-1), nan, med)


def median4_nonneg(x: torch.Tensor) -> torch.Tensor:
    """``nan_propagating_median(x, axis=0)`` for a 4-row stack of
    non-negative-or-NaN data, as a sort-free min/max network: the middle
    pair of (a,b)=minmax(x0,x1), (c,d)=minmax(x2,x3) is (max(a,c), min(b,d)).
    On that domain (no −0.0 after an abs; any NaN row overridden) it picks
    the same elements the sort would."""
    a = torch.minimum(x[0], x[1])
    b = torch.maximum(x[0], x[1])
    c = torch.minimum(x[2], x[3])
    d = torch.maximum(x[2], x[3])
    med = (torch.maximum(a, c) + torch.minimum(b, d)) * 0.5
    nan = torch.full((), float("nan"), dtype=x.dtype, device=x.device)
    return torch.where(torch.isnan(x).any(dim=0), nan, med)
