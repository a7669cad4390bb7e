"""The plain reference of the iterative surgical cleaner, in PyTorch.

It follows bwmeyers/iterative_cleaner (``iterative_cleaner.py``) and the
numpy.ma rules its statistics inherit, written out on tensors and imported
from nothing of the program:

- preprocessing: total intensity, each channel rotated by its whole-bin
  dispersion delay, and each profile's mean over the circular window of
  least running mean (15 % of the bins, found on the weighted total
  profile) subtracted;
- one iteration: the template is the weighted sum of the profiles under the
  previous weights; each profile's amplitude is ``<t,p>/<t,t>`` (1 where
  ``<t,t>`` is 0 or not finite); the residual ``amp*t - p``, scaled in the
  pulse region, is weighted by the original weights; four diagnostics per
  profile (std, mean, peak-to-peak, max |rfft| of the centred residual);
  each is robust-scaled per channel (across subints, over ``chanthresh``)
  and per subint (across channels, over ``subintthresh``), ``|x - median| /
  MAD``, the larger of the two kept; the score is the median of the four;
  a profile scoring 1 or more gets weight 0, every other its original weight;
- numpy.ma's rules: the first three diagnostics are masked where the
  original weight is 0 (medians over the unmasked entries only; a masked
  entry keeps its fill, 0 for std and mean and 1e20 for peak-to-peak, not
  divided by the threshold; where the MAD is 0 the deviation is left
  undivided); the FFT diagnostic is mask-blind (IEEE division, a NaN
  poisons its median);
- convergence: the loop stops when the new weights equal any earlier
  weights, the pre-loop weights included, or after ``max_iter`` iterations.

The template is summed as the numpy oracle of the reference cleaner sums
it, ``np.einsum("sc,scb->b", w, D, dtype=float32)``: one float32
accumulator per bin, advanced profile by profile, on the host; that order
is part of what the cleaner promises (its masks are the oracle's), and over
millions of profiles it moves the scores by more than float32 rounding
elsewhere does.  ``precision`` selects the rest of the arithmetic:
``"float64"`` is the reference; ``"tf32"`` is the control, float32 with the
operands of every product sum (the template, the total profile, the
amplitude fit) rounded to TF32's 10 mantissa bits, as a float32 matrix
product with TF32 allowed computes them.  The cube is processed on the
device in blocks of subints, so that its float64 temporaries stay small.
"""

from __future__ import annotations

import numpy as np
import torch

DM_CONST = 1.0 / 2.41e-4
BASELINE_FRAC = 0.15
MA_FILL = 1e20
PRECISIONS = {"float64": torch.float64, "tf32": torch.float32}


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest TF32 value (ties away from zero)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _tf32_np(x: np.ndarray) -> np.ndarray:
    i = np.ascontiguousarray(x, np.float32).view(np.int32)
    return ((i + 0x1000) & -0x2000).view(np.float32)


class Arith:
    """The compute type and the rounding of product operands."""

    def __init__(self, precision: str) -> None:
        if precision not in PRECISIONS:
            raise ValueError(f"precision is one of {sorted(PRECISIONS)}, got {precision!r}")
        self.dtype = PRECISIONS[precision]
        tf32 = precision == "tf32"
        self.round = _tf32 if tf32 else (lambda x: x)
        self.round_np = _tf32_np if tf32 else (lambda x: np.asarray(x, np.float32))

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype)

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        return self.round(self.cast(x))


# ---------------------------------------------------------------- preprocess

def preprocess(arch: dict, device, precision: str = "float64") -> tuple[torch.Tensor, np.ndarray]:
    """Raw archive fields → the cube ``D (nsub, nchan, nbin)``, worked out in
    the compute type and stored as float32 (the cleaner's input type) on
    ``device``, and the original weights ``(nsub, nchan)`` float32 on the
    host."""
    ar = Arith(precision)
    data = torch.from_numpy(np.ascontiguousarray(arch["data"]))
    state = arch["state"]
    if data.shape[1] == 1 or state in ("Intensity", "Stokes"):
        cube = data[:, 0]
    elif state == "Coherence":
        cube = data[:, 0] + data[:, 1]
    else:
        raise ValueError(f"unknown polarization state {state!r}")
    nsub, nchan, nbin = cube.shape
    D = ar.cast(cube.to(device))
    freqs = np.asarray(arch["freqs"], np.float64)
    dm, period = float(arch["dm"]), float(arch["period"])
    if dm != 0.0 and period > 0:
        delay = DM_CONST * dm * (freqs ** -2 - float(arch["centre_frequency"]) ** -2)
        shifts = np.round(delay / period * nbin).astype(np.int64) % nbin
        idx = (np.arange(nbin)[None, :] + shifts[:, None]) % nbin
        D = torch.gather(D, -1, torch.from_numpy(idx).to(device).expand(nsub, nchan, nbin))
    w0 = torch.from_numpy(np.asarray(arch["weights"], np.float32)).to(device)
    total = torch.einsum("sc,scb->b", ar.operand(w0).double(), ar.operand(D).double())
    width = max(1, int(round(BASELINE_FRAC * nbin)))
    ext = torch.cat((total, total[:width]))
    csum = torch.cat((total.new_zeros(1), torch.cumsum(ext, 0)))
    start = int(torch.argmin((csum[width:width + nbin] - csum[:nbin]) / width))
    win = (start + torch.arange(width, device=D.device)) % nbin
    D = D - D.index_select(-1, win).mean(-1, keepdim=True)
    return D.float(), w0.cpu().numpy()


# ---------------------------------------------------------------- one step

def template_of(D_host: np.ndarray, w: np.ndarray, ar: Arith) -> np.ndarray:
    """The weighted sum of the profiles in the oracle's order (see the
    module note); ``D_host`` already holds the operands' rounding."""
    return np.einsum("sc,scb->b", ar.round_np(w), D_host, dtype=np.float32)


def diagnostics(D, w0, valid, t, pulse_region, ar: Arith, block: int):
    """(std, mean, ptp, fft) maps (nsub, nchan) in the compute type, with
    the masked fills at invalid profiles."""
    t_op = ar.operand(t)
    tt = torch.dot(t_op, t_op)
    fit = bool(tt != 0) and bool(torch.isfinite(tt))
    scale, start, end = (float(v) for v in pulse_region)
    active = (scale, start, end) != (0.0, 0.0, 1.0)
    maps = [torch.empty(D.shape[:2], dtype=ar.dtype, device=D.device) for _ in range(4)]
    for lo in range(0, D.shape[0], block):
        Db = ar.cast(D[lo:lo + block])
        if fit:
            amp = torch.einsum("scb,b->sc", ar.round(Db), t_op) / tt
        else:
            amp = torch.ones(Db.shape[:2], dtype=ar.dtype, device=D.device)
        resid = amp[..., None] * t - Db
        del Db
        if active:
            resid[..., int(start):int(end)] *= scale
        weighted = resid * ar.cast(w0[lo:lo + block])[..., None]
        del resid
        mean = weighted.mean(-1)
        centred = weighted - mean[..., None]
        maps[0][lo:lo + block] = torch.sqrt((centred * centred).mean(-1))
        maps[1][lo:lo + block] = mean
        maps[2][lo:lo + block] = weighted.amax(-1) - weighted.amin(-1)
        del weighted
        maps[3][lo:lo + block] = torch.fft.rfft(centred, dim=-1).abs().amax(-1)
        del centred
    zero = torch.zeros((), dtype=ar.dtype, device=D.device)
    fill = torch.full((), MA_FILL, dtype=ar.dtype, device=D.device)
    std, mean, ptp, fft = maps
    return (torch.where(valid, std, zero), torch.where(valid, mean, zero),
            torch.where(valid, ptp, fill), fft)


def _middle(x: torch.Tensor, n: torch.Tensor, dim: int) -> torch.Tensor:
    """Mean of the two middle values of the first ``n`` sorted entries along
    ``dim`` (entries beyond ``n`` sort last); NaN where ``n`` is 0."""
    srt = torch.sort(x, dim=dim).values
    lo = torch.clamp((n - 1) // 2, min=0).unsqueeze(dim)
    hi = torch.clamp(n // 2, min=0).unsqueeze(dim)
    med = (torch.gather(srt, dim, lo) + torch.gather(srt, dim, hi)).squeeze(dim) * 0.5
    return torch.where(n > 0, med, torch.full_like(med, float("nan")))


def masked_median(x, valid, dim):
    inf = torch.full_like(x, float("inf"))
    n = valid.sum(dim)
    return _middle(torch.where(valid, x, inf), n, dim), n


def plain_median(x, dim):
    n = torch.full_like(x.select(dim, 0), x.shape[dim], dtype=torch.int64)
    med = _middle(x, n, dim)
    return torch.where(torch.isnan(x).any(dim), torch.full_like(med, float("nan")), med)


def scale_masked(x, valid, dim, thresh):
    med, n = masked_median(x, valid, dim)
    dev = x - med.unsqueeze(dim)
    mad, _ = masked_median(dev.abs(), valid, dim)
    has = (n > 0).unsqueeze(dim)
    ok = has & (mad != 0).unsqueeze(dim) & ~torch.isnan(mad).unsqueeze(dim)
    safe = torch.where(ok, mad.unsqueeze(dim), torch.ones_like(dev))
    scaled = torch.where(ok, (dev / safe).abs() / thresh, dev.abs())
    return torch.where(valid & has, scaled, x.abs())


def scale_plain(x, dim, thresh):
    med = plain_median(x, dim)
    dev = x - med.unsqueeze(dim)
    mad = plain_median(dev.abs(), dim)
    return (dev / mad.unsqueeze(dim)).abs() / thresh


def scores_of(diags, valid, chanthresh, subintthresh) -> torch.Tensor:
    rows = []
    for k, x in enumerate(diags):
        if k < 3:
            per_chan = scale_masked(x, valid, 0, chanthresh)
            per_subint = scale_masked(x, valid, 1, subintthresh)
        else:
            per_chan = scale_plain(x, 0, chanthresh)
            per_subint = scale_plain(x, 1, subintthresh)
        rows.append(torch.maximum(per_chan, per_subint))
    return plain_median(torch.stack(rows), 0)


# ---------------------------------------------------------------- the loop

def clean(D: torch.Tensor, w0: np.ndarray, chanthresh: float, subintthresh: float,
          max_iter: int, pulse_region=(0.0, 0.0, 1.0), precision: str = "float64",
          block: int = 64, D_host: np.ndarray | None = None) -> dict:
    """The convergence loop on a float32 cube ``D`` on the device, with its
    host copy ``D_host`` for the template (made when not given).  Returns
    the final weights and the last iteration's scores as host arrays, and the
    loop count (the iteration at which the weights repeated, or
    ``max_iter``)."""
    ar = Arith(precision)
    D_host = D.cpu().numpy() if D_host is None else D_host
    D_host = ar.round_np(D_host)
    w0 = np.asarray(w0, np.float32)
    w0_dev = torch.from_numpy(w0).to(D.device)
    valid = w0_dev != 0
    history = [w0]
    w_prev, scores, loops = w0, None, int(max_iter)
    for x in range(1, int(max_iter) + 1):
        t = torch.from_numpy(template_of(D_host, w_prev, ar)).to(D.device, ar.dtype)
        diags = diagnostics(D, w0_dev, valid, t, pulse_region, ar, block)
        scores = scores_of(diags, valid, float(chanthresh), float(subintthresh))
        new_w = torch.where(scores >= 1, torch.zeros_like(w0_dev), w0_dev).cpu().numpy()
        stop = any(np.array_equal(new_w, old) for old in history)
        history.append(new_w)
        w_prev = new_w
        if stop:
            loops = x
            break
    return {"weights": w_prev, "scores": scores.cpu().numpy(), "loops": loops}
