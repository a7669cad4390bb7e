"""Seeded synthetic pulsar archives with injected RFI.

A copy of ``iterative_cleaner_tpu/io/synthetic.py`` (``RFISpec``,
``pulse_profile``, ``make_archive``).  Data synthesis stays numpy-seeded, so
one seed gives the same bytes in both packages (pinned by
``tests/test_torch_clean.py``).

:func:`make_preprocessed_cube` is the port's own: an already preprocessed
cube made on a device from a ``torch.Generator``, for sizes where
``make_archive``'s float64 host synthesis and per-channel Python loop would
take too long (the 1024 x 4096 x 1024 cube of BASELINE.json config #5).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from iterative_cleaner_tpu_torch.io.base import (
    Archive,
    STATE_COHERENCE,
    STATE_INTENSITY,
    STATE_STOKES,
)
from iterative_cleaner_tpu_torch.ops.preprocess import (
    BASELINE_FRAC,
    baseline_window,
    dispersion_shifts,
)


@dataclass(frozen=True)
class RFISpec:
    """Which RFI morphologies to inject and how hard."""

    n_profile_spikes: int = 4       # isolated (subint, chan) impulse RFI
    n_dc_profiles: int = 3          # isolated profiles with a DC offset
    n_bad_channels: int = 1         # persistent narrowband channels
    n_bad_subints: int = 1          # broadband bursts across a whole subint
    n_prezapped: int = 2            # profiles with weight already 0 on load
    amplitude: float = 40.0         # RFI strength in units of noise sigma


_DEFAULT_RFI = RFISpec()


def pulse_profile(nbin: int, width_frac: float = 0.03, phase: float = 0.30) -> np.ndarray:
    """A Gaussian pulse template in phase bins."""
    x = np.arange(nbin, dtype=np.float64) / nbin
    w = max(width_frac, 1.5 / nbin)
    d = x - phase
    d -= np.round(d)  # circular distance
    return np.exp(-0.5 * (d / w) ** 2)


def make_archive(
    nsub: int = 8,
    nchan: int = 64,
    nbin: int = 256,
    npol: int = 1,
    seed: int = 0,
    snr: float = 25.0,
    rfi: RFISpec | None = _DEFAULT_RFI,
    dm: float = 12.455,
    period: float = 0.714,
    centre_frequency: float = 149.0,
    bandwidth: float = 78.125,
    dispersed: bool = True,
    noise_sigma: float = 1.0,
    state: str | None = None,
) -> Archive:
    """Build a seeded synthetic archive: Gaussian noise, a dispersed pulse
    with a smooth bandpass, and the injected RFI of ``rfi``.  ``state``
    defaults by npol: 1 → Intensity, 2 → Coherence, 4 → Stokes."""
    if state is None:
        state = {1: STATE_INTENSITY, 2: STATE_COHERENCE}.get(npol, STATE_STOKES)
    rng = np.random.default_rng(seed)
    freqs = centre_frequency + bandwidth * (np.arange(nchan) / nchan - 0.5)

    prof = pulse_profile(nbin)
    gains = 1.0 + 0.3 * np.sin(np.linspace(0, 3.1, nchan))  # smooth bandpass
    amp = snr * noise_sigma / max(np.sqrt(prof.sum()), 1e-9)

    cube = rng.normal(0.0, noise_sigma, size=(nsub, npol, nchan, nbin))
    shifts = dispersion_shifts(freqs, dm, period, nbin, centre_frequency) if dispersed else np.zeros(nchan, int)
    for c in range(nchan):
        # Disperse = inverse of the dedispersion roll.
        chan_prof = np.roll(prof, int(shifts[c])) * amp * gains[c]
        cube[:, :, c, :] += chan_prof

    weights = np.ones((nsub, nchan), dtype=np.float32)
    # Mild weight variation: data is multiplied by raw (not boolean) weights.
    weights *= (0.8 + 0.4 * rng.random((nsub, nchan))).astype(np.float32)

    if rfi is not None:
        a = rfi.amplitude * noise_sigma
        for _ in range(rfi.n_profile_spikes):
            s, c, b = rng.integers(nsub), rng.integers(nchan), rng.integers(nbin)
            cube[s, :, c, b] += a * (2.0 + rng.random())
        for _ in range(rfi.n_dc_profiles):
            s, c = rng.integers(nsub), rng.integers(nchan)
            cube[s, :, c, :] += a * 0.4
        for _ in range(rfi.n_bad_channels):
            c = rng.integers(nchan)
            cube[:, :, c, :] += rng.normal(0, a * 0.3, size=(nsub, npol, 1, nbin))[:, :, 0, :]
        for _ in range(rfi.n_bad_subints):
            s = rng.integers(nsub)
            cube[s, :, :, :] += rng.normal(0, a * 0.3, size=(npol, nchan, nbin))
        for _ in range(rfi.n_prezapped):
            s, c = rng.integers(nsub), rng.integers(nchan)
            weights[s, c] = 0.0

    return Archive(
        data=cube.astype(np.float32),
        weights=weights,
        freqs=freqs,
        centre_frequency=float(centre_frequency),
        dm=float(dm) if dispersed else 0.0,
        period=float(period),
        source="J0000+0000",
        mjd_start=60500.0,
        mjd_end=60500.0 + nsub * 10.0 / 86400.0,
        state=state,
        dedispersed=not dispersed,
        filename=f"synthetic_seed{seed}",
    )


def make_preprocessed_cube(nsub: int, nchan: int, nbin: int, seed: int = 0,
                           snr: float = 25.0, rfi: RFISpec | None = _DEFAULT_RFI,
                           device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """A seeded (D, w0) pair on ``device``, as ``preprocess`` would leave
    it: float32 Gaussian noise plus the pulse of :func:`pulse_profile`
    (already dedispersed, so in phase across channels) under a smooth
    bandpass, the injections of ``rfi`` (spikes, DC profiles, bad channels,
    bad subints, pre-zapped profiles), and each profile's off-pulse mean
    removed with the window ``preprocess`` uses.  Everything is drawn from
    one ``torch.Generator`` seeded with ``seed``; one seed gives one cube
    on a given device type."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def randint(high, n):
        return torch.randint(int(high), (int(n),), generator=gen, device=dev)

    D = torch.randn((nsub, nchan, nbin), generator=gen, device=dev)
    prof = torch.from_numpy(pulse_profile(nbin)).to(dev, torch.float32)
    gains = 1.0 + 0.3 * torch.sin(torch.linspace(0, 3.1, nchan, device=dev))
    amp = snr / max(float(np.sqrt(pulse_profile(nbin).sum())), 1e-9)
    D += (amp * gains)[:, None] * prof[None, :]
    w0 = 0.8 + 0.4 * rand(nsub, nchan)
    if rfi is not None:
        a = rfi.amplitude
        n = rfi.n_profile_spikes
        s, c, b = randint(nsub, n), randint(nchan, n), randint(nbin, n)
        D[s, c, b] += a * (2.0 + rand(n))
        s, c = randint(nsub, rfi.n_dc_profiles), randint(nchan, rfi.n_dc_profiles)
        D[s, c] += 0.4 * a
        for c in randint(nchan, rfi.n_bad_channels).tolist():
            D[:, c] += 0.3 * a * torch.randn((nsub, nbin), generator=gen, device=dev)
        for s in randint(nsub, rfi.n_bad_subints).tolist():
            D[s] += 0.3 * a * torch.randn((nchan, nbin), generator=gen, device=dev)
        s, c = randint(nsub, rfi.n_prezapped), randint(nchan, rfi.n_prezapped)
        w0[s, c] = 0.0
    total = torch.matmul(w0.reshape(-1), D.reshape(-1, nbin))
    start, width = baseline_window(total.double().cpu().numpy(), BASELINE_FRAC)
    idx = (start + torch.arange(width, device=dev)) % nbin
    D -= D.index_select(-1, idx).mean(dim=-1, keepdim=True)
    return D, w0
