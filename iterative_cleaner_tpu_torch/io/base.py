"""Archive data model + I/O protocol.

A copy of ``iterative_cleaner_tpu/io/base.py`` (``Archive``, the
``ArchiveIO`` protocol, extension routing): ``.npz`` and ``.ictb`` (the
native C++ runtime's format, :mod:`.ictb`).  PSRCHIVE ``.ar`` paths raise a
"not yet ported" error.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol

import numpy as np

# PSRCHIVE polarization states distinguished for pscrunch semantics.
STATE_INTENSITY = "Intensity"   # npol == 1, already total intensity
STATE_STOKES = "Stokes"         # I,Q,U,V — total intensity is pol 0
STATE_COHERENCE = "Coherence"   # AA,BB(,CR,CI) — total intensity is AA+BB


@dataclass
class Archive:
    """In-memory pulsar archive: the 4-D cube + weights + fold metadata."""

    data: np.ndarray            # (nsub, npol, nchan, nbin) float32
    weights: np.ndarray         # (nsub, nchan) float32
    freqs: np.ndarray           # (nchan,) channel centre frequencies, MHz
    centre_frequency: float     # MHz
    dm: float                   # pc cm^-3
    period: float               # folding period, seconds
    source: str = "SYNTH"
    mjd_start: float = 60000.0
    mjd_end: float = 60000.0
    state: str = STATE_INTENSITY
    dedispersed: bool = False   # True once inter-channel delays are removed
    filename: str = "archive"

    def __post_init__(self) -> None:
        if self.data.ndim != 4:
            raise ValueError(f"data must be 4-D (nsub,npol,nchan,nbin), got {self.data.shape}")
        nsub, _npol, nchan, _nbin = self.data.shape
        if self.weights.shape != (nsub, nchan):
            raise ValueError(
                f"weights shape {self.weights.shape} != (nsub, nchan) = {(nsub, nchan)}")
        if self.freqs.shape != (nchan,):
            raise ValueError(f"freqs shape {self.freqs.shape} != ({nchan},)")

    @property
    def nsub(self) -> int:
        return self.data.shape[0]

    @property
    def npol(self) -> int:
        return self.data.shape[1]

    @property
    def nchan(self) -> int:
        return self.data.shape[2]

    @property
    def nbin(self) -> int:
        return self.data.shape[3]

    @property
    def mjd_mid(self) -> float:
        # Reference 'std' naming uses the mid-MJD.
        return 0.5 * (self.mjd_start + self.mjd_end)


class ArchiveIO(Protocol):
    def load(self, path: str) -> Archive: ...

    def save(self, archive: Archive, path: str) -> None: ...


class NotPortedIO:
    """Stands in for a format whose reader is not yet ported."""

    def __init__(self, what: str) -> None:
        self.what = what

    def _fail(self, path: str):
        raise NotImplementedError(
            f"{path}: {self.what} is not yet ported to the PyTorch package; "
            "convert the archive to .npz or use iterative_cleaner_tpu")

    def load(self, path: str) -> Archive:
        self._fail(path)

    def save(self, archive: Archive, path: str) -> None:
        self._fail(path)


def _npz_io():
    from iterative_cleaner_tpu_torch.io.npz import NpzIO

    return NpzIO()


def _ictb_io():
    from iterative_cleaner_tpu_torch.io.ictb import IctbIO

    return IctbIO()


# Extension routing; anything unlisted is a PSRCHIVE .ar path.
EXTENSION_IO = {
    ".npz": _npz_io,
    ".ictb": _ictb_io,
}
DEFAULT_EXT = ".ar"


def known_extension(path: str) -> str:
    for ext in EXTENSION_IO:
        if path.endswith(ext):
            return ext
    return DEFAULT_EXT


def get_io(path: str) -> "ArchiveIO":
    """Pick an I/O backend from the file extension."""
    ext = known_extension(path)
    if ext in EXTENSION_IO:
        return EXTENSION_IO[ext]()
    return NotPortedIO("PSRCHIVE archive I/O")
