"""The comprehensive-stats pipeline: four diagnostics and the robust scalers.

Port of ``iterative_cleaner_tpu/ops/stats.py:50-340``.  The numpy.ma rules
are reproduced with explicit value+validity arithmetic:

masked diagnostics (std / mean / ptp — "type A" scaling):
  valid entry, MAD != 0 : |x − med| / MAD / thresh
  valid entry, MAD == 0 : |x − med|          (masked division leaves the
                                              numerator; /thresh skips it)
  masked entry          : |x|                (raw fill data: 0.0 for
                                              std/mean, 1e20 for ptp)
plain diagnostic (max |rfft| — "type B", mask-blind):
  IEEE throughout: (x − med)/MAD with MAD == 0 gives ±inf / NaN.

Downstream of the scalers the masks are gone: element-wise max of the
channel/subint scalings, then a NaN-propagating median across the four
diagnostics.  NaN >= 1 is False, so fully-masked profiles are never flagged.

Every division by a Python number goes through :func:`true_divide`: on the
card PyTorch turns ``tensor / python_float`` into a multiplication by the
reciprocal, which can differ from the division in the last bit — and a
last-bit change of a score at 1.0 changes a mask.  A threshold may also be
a tensor of one value per archive of a batch (the threshold sweep's pairs,
``models/sweep.py``): the division is then elementwise by that archive's
value, the same IEEE quotient as the float's.  The GSPMD partitioning
wrapper around the FFT (``stats.py:215-311``) has no counterpart here.
"""

from __future__ import annotations

import torch

from iterative_cleaner_tpu_torch.ops.masked import median4_nonneg, sort_prefix

# numpy.ma's default float fill value — the raw data np.ma.ptp leaves at
# fully-masked positions.
MA_FILL = 1e20


def true_divide(x: torch.Tensor, d) -> torch.Tensor:
    """``x / d`` as an IEEE division on every device (see module note).
    A float divisor is made on the device by a fill, not copied from the
    host, so the call never waits for the device.  An ``(a,)`` tensor
    divides the maps ``([k,] a, nsub, nchan)`` of archive ``j`` by
    ``d[j]``."""
    if isinstance(d, torch.Tensor):
        return x / d.to(x.dtype).reshape(-1, 1, 1)
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


#: Elements per cuFFT call of the FFT diagnostic (2^25 float32, 128 MiB).
#: The transform's complex output, its workspace and the magnitudes scale
#: with the batch; taken over a whole cube they cost ~2.5 cubes of device
#: memory at the peak, so a cube is transformed in subint pieces of at most
#: this many elements.  Under ``--x64`` a piece is half as many float64
#: elements: the same bytes, so the peak stays the same share of the cube.
FFT_PIECE_ELEMENTS = 1 << 25


def fft_diagnostic(centred: torch.Tensor) -> torch.Tensor:
    """max |rfft| over the bin axis of the centred residuals — the
    mask-blind diagnostic #4 — in pieces of leading-axis rows of at most
    FFT_PIECE_ELEMENTS float32 elements (their bytes in float64).  A batch ``(a, nsub, nchan, nbin)`` is cut
    as ``(a*nsub, nchan, nbin)`` rows, each archive into the pieces it
    would be cut into alone: no piece spans two archives, so the batch runs
    the single-archive route's cuFFT calls."""
    if centred.dim() > 3:
        rows = centred.reshape(-1, *centred.shape[-2:])
        nsub = centred.shape[-3]
        out = torch.empty(rows.shape[:-1], dtype=centred.dtype, device=centred.device)
        for lo in range(0, rows.shape[0], max(nsub, 1)):
            out[lo:lo + nsub] = fft_diagnostic(rows[lo:lo + nsub])
        return out.reshape(centred.shape[:-1])
    n = centred.shape[0] if centred.dim() > 1 else 1
    piece = FFT_PIECE_ELEMENTS * 4 // centred.element_size()
    step = max(1, piece // max(1, centred.numel() // max(n, 1)))
    if n <= step:
        return torch.fft.rfft(centred, dim=-1).abs().amax(dim=-1)
    out = torch.empty(centred.shape[:-1], dtype=centred.dtype, device=centred.device)
    for lo in range(0, n, step):
        out[lo:lo + step] = torch.fft.rfft(centred[lo:lo + step], dim=-1).abs().amax(dim=-1)
    return out


def fill_moments(mean, std, ptp, valid):
    """numpy.ma raw-data fills at fully-masked profiles: 0.0 for mean/std,
    1e20 for ptp.  Returns in argument order: (mean, std, ptp)."""
    zero = torch.zeros((), dtype=mean.dtype, device=mean.device)
    fill = torch.full((), MA_FILL, dtype=ptp.dtype, device=ptp.device)
    return (torch.where(valid, mean, zero), torch.where(valid, std, zero),
            torch.where(valid, ptp, fill))


def moments(weighted: torch.Tensor):
    """(centred, mean, std, ptp) of the weighted residuals along the bin
    axis: two-pass mean and variance, as the kernel computes them."""
    nbin = weighted.shape[-1]
    mean = true_divide(weighted.sum(dim=-1), nbin)
    centred = weighted - mean[..., None]
    std = torch.sqrt(true_divide((centred * centred).sum(dim=-1), nbin))
    ptp = weighted.amax(dim=-1) - weighted.amin(dim=-1)
    return centred, mean, std, ptp


def diagnostics(weighted: torch.Tensor, valid: torch.Tensor):
    """The four per-profile outlier diagnostics along the bin axis, in
    (std, mean, ptp, fft) order.  Profiles are entirely valid or entirely
    masked, so the masked reductions are plain reductions + a fill."""
    centred, mean, std, ptp = moments(weighted)
    fft_diag = fft_diagnostic(centred)
    d_mean, d_std, d_ptp = fill_moments(mean, std, ptp, valid)
    return d_std, d_mean, d_ptp, fft_diag


def _select_medians_via(filled: torch.Tensor, n: torch.Tensor, ax3: int):
    """Per-row medians of a (4, [a,] nsub, nchan) stack along ``ax3``, one
    sort; each line (and each archive of a batch) on its own.

    Rows 0-2 carry +inf at invalid positions and use count-based selection
    with even-count averaging (NaN when ``n`` is 0).  Row 3 carries raw
    values and uses np.median semantics: static middle pair, NaN if any NaN
    is in the line."""
    size = filled.shape[ax3]
    x = torch.movedim(filled, ax3, -1)             # (4, [a,] A, size)
    srt = sort_prefix(x, size // 2 + 1)
    lo = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), 0, size - 1)
    hi = torch.clamp(torch.div(n, 2, rounding_mode="floor"), 0, size - 1)
    idx = torch.stack((lo, hi), dim=-1)[None].expand(3, *lo.shape, 2)  # (3, [a,] A, 2)
    pair = torch.gather(srt[:3], -1, idx)
    nan = torch.full((), float("nan"), dtype=filled.dtype, device=filled.device)
    # The reference sums the pair as a reduction from +0.0, which turns a
    # (−0.0, −0.0) pair into +0.0; the explicit +0.0 keeps that bit.
    zero = torch.zeros((), dtype=filled.dtype, device=filled.device)
    med_masked = torch.where(n > 0, ((zero + pair[..., 0]) + pair[..., 1]) * 0.5, nan)
    mid = (srt[3, ..., (size - 1) // 2] + srt[3, ..., size // 2]) * 0.5
    med_plain = torch.where(torch.isnan(x[3]).any(dim=-1), nan, mid)
    return torch.cat((med_masked, med_plain[None]), dim=0)       # (4, A)


def _scale_axis(stack4: torch.Tensor, valid: torch.Tensor,
                axis: int, thresh) -> torch.Tensor:
    """All four diagnostics robust-scaled along ``axis`` of (nsub, nchan)
    (0: across subints, per channel; 1: across channels, per subint): two
    median selections over the (4, [a,] nsub, nchan) stack (values, then
    absolute deviations).  A leading archive axis is a batch: every median
    stays within its archive, and ``thresh`` may be one value per archive
    (:func:`true_divide`)."""
    ax3 = axis - 2          # the reduced axis, counted from the end
    n = valid.sum(dim=ax3)
    valid3 = valid[None]
    inf = torch.full((), float("inf"), dtype=stack4.dtype, device=stack4.device)
    filled = torch.cat((torch.where(valid3, stack4[:3], inf), stack4[3:]), dim=0)
    med = _select_medians_via(filled, n, ax3)
    r = stack4 - med.unsqueeze(ax3)
    abs_r = r.abs()
    filled_r = torch.cat((torch.where(valid3, abs_r[:3], inf), abs_r[3:]), dim=0)
    mad = _select_medians_via(filled_r, n, ax3)

    has = n > 0
    madA, madB = mad[:3], mad[3]
    mad_ok = has[None] & (madA != 0) & ~torch.isnan(madA)
    one = torch.ones((), dtype=stack4.dtype, device=stack4.device)
    madA_b = torch.where(mad_ok, madA, one).unsqueeze(ax3)
    # Two-division op order matches the reference: (r/MAD), abs, /thresh.
    scaled_ok = true_divide((r[:3] / madA_b).abs(), thresh)
    scaled_valid = torch.where(mad_ok.unsqueeze(ax3), scaled_ok, abs_r[:3])
    has_b = has[None].unsqueeze(ax3)
    type_a = torch.where(valid3 & has_b, scaled_valid, stack4[:3].abs())
    type_b = true_divide((r[3] / madB.unsqueeze(ax3)).abs(), thresh)
    return torch.cat((type_a, type_b[None]), dim=0)


def scale_and_combine(d_std, d_mean, d_ptp, d_fft, valid,
                      chanthresh, subintthresh) -> torch.Tensor:
    """Robust-scale the four diagnostics per channel (across subints,
    / chanthresh) and per subint (across channels, / subintthresh), take the
    element-wise max (the mask-drop), and median the four rows.  Maps of
    shape (a, nsub, nchan) are a batch, scaled archive by archive (the
    vmap of the JAX package's function); there the thresholds may be floats
    or ``(a,)`` tensors, one pair per archive."""
    stack4 = torch.stack((d_std, d_mean, d_ptp, d_fft), dim=0)
    per_chan = _scale_axis(stack4, valid, axis=0, thresh=chanthresh)
    per_subint = _scale_axis(stack4, valid, axis=1, thresh=subintthresh)
    combined = torch.maximum(per_chan, per_subint)
    return median4_nonneg(combined)
