"""Seeded inputs of the benchmark, made on a device from one ``torch.Generator``.

The same seed gives the same bytes on a given device type.  Two kinds:

- :func:`raw_archive`: a folded archive as a telescope writes it, dispersed,
  with raw weights: Gaussian noise, a Gaussian pulse under a smooth bandpass,
  delayed per channel by the cold-plasma dispersion law, and the injected RFI
  of the configuration's ``rfi`` group (impulsive spikes, DC profiles,
  persistent narrowband channels, broadband subints, pre-zapped profiles);
  with ``shuffle``, its subints (data and weights together) in an order drawn
  from that second seed, which leaves every profile, and so the cleaner's
  work, as it was;
- :func:`preprocessed_cube`: the same ingredients already dedispersed and
  with each profile's off-pulse mean removed, as the cleaner's preprocessing
  would leave them (the in-memory clean of a cube too large to synthesise on
  the host in the run's time).

Both are made on the device in a few large calls and copied to host memory,
which is what the program receives.  Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

#: The inverse dispersion constant PSRCHIVE uses: delay[s] = DM / 2.41e-4 * f^-2[MHz].
DM_CONST = 1.0 / 2.41e-4
#: Share of the bins in the off-pulse window whose mean each profile loses.
BASELINE_FRAC = 0.15


def pulse_profile(nbin: int, width_frac: float = 0.03, phase: float = 0.30) -> np.ndarray:
    """A Gaussian pulse in phase bins (circular distance to ``phase``)."""
    x = np.arange(nbin, dtype=np.float64) / nbin
    w = max(width_frac, 1.5 / nbin)
    d = x - phase
    d -= np.round(d)
    return np.exp(-0.5 * (d / w) ** 2)


def channel_freqs(cfg: dict) -> np.ndarray:
    nchan = int(cfg["nchan"])
    return cfg["centre_frequency"] + cfg["bandwidth"] * (np.arange(nchan) / nchan - 0.5)


def dispersion_shifts(freqs, dm, period, nbin, ref_freq) -> np.ndarray:
    """Whole-bin delay of each channel relative to ``ref_freq``, modulo nbin."""
    if dm == 0.0 or period <= 0:
        return np.zeros(len(freqs), dtype=np.int64)
    delay = DM_CONST * dm * (np.asarray(freqs, np.float64) ** -2 - float(ref_freq) ** -2)
    return np.round(delay / period * nbin).astype(np.int64) % nbin


def baseline_window(total: np.ndarray, frac: float = BASELINE_FRAC) -> tuple[int, int]:
    """(start, width) of the circular window of least running mean."""
    nbin = total.shape[-1]
    width = max(1, int(round(frac * nbin)))
    ext = np.concatenate([total, total[:width]])
    csum = np.concatenate([[0.0], np.cumsum(ext)])
    means = (csum[width:width + nbin] - csum[:nbin]) / width
    return int(np.argmin(means)), width


class _Draw:
    """Every random number of one input, from one generator on ``device``."""

    def __init__(self, seed: int, device) -> None:
        self.dev = torch.device(device)
        self.gen = torch.Generator(device=self.dev)
        self.gen.manual_seed(int(seed))

    def normal(self, *shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.dev)

    def uniform(self, *shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.gen, device=self.dev)

    def permutation(self, n: int) -> torch.Tensor:
        return torch.randperm(int(n), generator=self.gen, device=self.dev)

    def index(self, high: int, n: int) -> torch.Tensor:
        return torch.randint(int(high), (int(n),), generator=self.gen, device=self.dev)


def _pulse_rows(cfg: dict, dev, shifts: np.ndarray | None) -> torch.Tensor:
    """(nchan, nbin) float32: each channel's pulse, delayed by ``shifts``."""
    nchan, nbin = int(cfg["nchan"]), int(cfg["nbin"])
    prof = pulse_profile(nbin)
    gains = 1.0 + 0.3 * np.sin(np.linspace(0, 3.1, nchan))
    amp = cfg["snr"] / max(float(np.sqrt(prof.sum())), 1e-9)
    rows = np.broadcast_to(prof, (nchan, nbin))
    if shifts is not None:
        idx = (np.arange(nbin)[None, :] - shifts[:, None]) % nbin
        rows = np.take_along_axis(rows, idx, axis=1)
    return torch.from_numpy((rows * (amp * gains)[:, None]).astype(np.float32)).to(dev)


def _inject(cube: torch.Tensor, weights: torch.Tensor, rfi: dict, r: _Draw) -> None:
    """The RFI of ``rfi`` added in place to ``cube (nsub, npol, nchan, nbin)``;
    pre-zapped profiles get weight 0."""
    nsub, npol, nchan, nbin = cube.shape
    a = float(rfi["amplitude"])
    n = int(rfi["n_profile_spikes"])
    s, c, b = r.index(nsub, n), r.index(nchan, n), r.index(nbin, n)
    cube[s, :, c, b] += (a * (2.0 + r.uniform(n)))[:, None]
    n = int(rfi["n_dc_profiles"])
    s, c = r.index(nsub, n), r.index(nchan, n)
    cube[s, :, c, :] += 0.4 * a
    for c in r.index(nchan, int(rfi["n_bad_channels"])).tolist():
        cube[:, :, c, :] += 0.3 * a * r.normal(nsub, npol, nbin)
    for s in r.index(nsub, int(rfi["n_bad_subints"])).tolist():
        cube[s] += 0.3 * a * r.normal(npol, nchan, nbin)
    n = int(rfi["n_prezapped"])
    s, c = r.index(nsub, n), r.index(nchan, n)
    weights[s, c] = 0.0


def raw_archive(cfg: dict, seed: int, device, shuffle: int | None = None) -> dict:
    """A dispersed archive: ``data (nsub, npol, nchan, nbin)`` and ``weights
    (nsub, nchan)`` float32 on the host, with the fold's metadata; its
    subints permuted by a generator seeded with ``shuffle`` where given."""
    r = _Draw(seed, device)
    nsub, npol, nchan, nbin = (int(cfg[k]) for k in ("nsub", "npol", "nchan", "nbin"))
    freqs = channel_freqs(cfg)
    shifts = dispersion_shifts(freqs, cfg["dm"], cfg["period"], nbin, cfg["centre_frequency"])
    cube = r.normal(nsub, npol, nchan, nbin)
    cube += _pulse_rows(cfg, r.dev, shifts)
    weights = 0.8 + 0.4 * r.uniform(nsub, nchan)
    _inject(cube, weights, cfg["rfi"], r)
    if shuffle is not None:
        perm = _Draw(shuffle, device).permutation(nsub)
        cube, weights = cube[perm], weights[perm]
    out = {"data": cube.cpu().numpy(), "weights": weights.cpu().numpy(), "freqs": freqs,
           "centre_frequency": float(cfg["centre_frequency"]), "dm": float(cfg["dm"]),
           "period": float(cfg["period"]), "state": cfg["state"]}
    del cube
    return out


def preprocessed_cube(cfg: dict, seed: int, device, block: int = 64) -> dict:
    """A dedispersed, baseline-removed ``D (nsub, nchan, nbin)`` and its
    weights ``w0 (nsub, nchan)``, float32 on the host."""
    r = _Draw(seed, device)
    nsub, nchan, nbin = (int(cfg[k]) for k in ("nsub", "nchan", "nbin"))
    D = r.normal(nsub, 1, nchan, nbin)
    D += _pulse_rows(cfg, r.dev, None)
    w0 = 0.8 + 0.4 * r.uniform(nsub, nchan)
    _inject(D, w0, cfg["rfi"], r)
    D = D[:, 0]
    total = torch.zeros(nbin, dtype=torch.float64, device=r.dev)
    for lo in range(0, nsub, block):
        total += (w0[lo:lo + block, :, None].double() * D[lo:lo + block].double()).sum((0, 1))
    start, width = baseline_window(total.cpu().numpy())
    idx = (start + torch.arange(width, device=r.dev)) % nbin
    for lo in range(0, nsub, block):
        blk = D[lo:lo + block]
        blk -= blk.index_select(-1, idx).double().mean(-1, keepdim=True).float()
    out = {"D": D.cpu().numpy(), "w0": w0.cpu().numpy()}
    del D
    return out
