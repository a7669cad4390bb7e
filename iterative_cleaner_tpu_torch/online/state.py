"""Per-session resident cleaning state of the online subsystem.

A copy of ``iterative_cleaner_tpu/online/state.py`` on the port's own
preprocessing (``ops/preprocess.py``).  A streaming session never knows its
final subint count, so the cube lives in capacity-doubling host slabs
(amortized O(1) per appended row) instead of a reallocation per block:

- the **raw** slab ``(cap, npol, nchan, nbin)`` — the authoritative record;
  end-of-stream assembles it into a plain :class:`..io.base.Archive` and the
  canonical pipeline runs on that, which keeps the final mask identical to
  the oracle's by construction;
- the **pscrunched + dedispersed** slab ``(cap, nchan, nbin)`` — the two
  per-subint-independent preprocessing steps applied at ingest, so a
  provisional pass never redoes them over the whole history (the dispersion
  shifts depend only on session metadata, fixed at open).

Baseline removal is the one preprocessing step that is not per subint (its
off-pulse window comes from the weighted total profile), so provisional
passes recompute it over the accumulated slab each block, while the
finalize path re-derives everything from the raw slab canonically.  The
slabs stay on the host; a provisional pass streams them through the card.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field

import numpy as np

from iterative_cleaner_tpu_torch.io.base import STATE_INTENSITY, Archive
from iterative_cleaner_tpu_torch.ops.preprocess import (
    dispersion_shifts,
    pscrunch,
    remove_baseline,
    roll_cube,
)


@dataclass
class SessionMeta:
    """The archive-level metadata a session is opened with — everything an
    :class:`Archive` needs except the still-arriving cube and weights.
    JSON-roundtrippable (``to_dict`` / ``from_dict``), in the JAX package's
    field layout, so a session spooled by either package opens in both."""

    nchan: int
    nbin: int
    npol: int = 1
    freqs: list[float] = field(default_factory=list)
    centre_frequency: float = 0.0
    dm: float = 0.0
    period: float = 1.0
    source: str = "STREAM"
    mjd_start: float = 60000.0
    mjd_end: float = 60000.0
    state: str = STATE_INTENSITY
    dedispersed: bool = False

    def __post_init__(self) -> None:
        if self.nchan < 1 or self.nbin < 1 or self.npol < 1:
            raise ValueError(
                f"bad session dims nchan={self.nchan} nbin={self.nbin} "
                f"npol={self.npol}")
        if not self.freqs:
            # A client that only knows the band centre still gets a valid
            # archive; DM=0 sessions never read per-channel frequencies.
            self.freqs = [float(self.centre_frequency)] * int(self.nchan)
        if len(self.freqs) != self.nchan:
            raise ValueError(
                f"freqs has {len(self.freqs)} entries, expected {self.nchan}")
        if self.dm != 0.0 and not self.dedispersed:
            # Dedispersion divides by f^2 and by the reference frequency
            # squared: a zero/negative frequency (the centre-fill above
            # when no centre was given) would rotate the cube by garbage.
            if self.centre_frequency <= 0 or any(
                    f <= 0 for f in self.freqs):
                raise ValueError(
                    "dm != 0 on a dispersed session requires positive "
                    "centre_frequency and per-channel freqs (got centre="
                    f"{self.centre_frequency!r})")

    @classmethod
    def from_archive(cls, archive: Archive) -> "SessionMeta":
        return cls(
            nchan=archive.nchan,
            nbin=archive.nbin,
            npol=archive.npol,
            freqs=[float(f) for f in archive.freqs],
            centre_frequency=float(archive.centre_frequency),
            dm=float(archive.dm),
            period=float(archive.period),
            source=archive.source,
            mjd_start=float(archive.mjd_start),
            mjd_end=float(archive.mjd_end),
            state=archive.state,
            dedispersed=bool(archive.dedispersed),
        )

    @classmethod
    def from_dict(cls, d: dict) -> "SessionMeta":
        known = set(cls.__dataclass_fields__)
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown session meta fields {sorted(unknown)}")
        missing = {"nchan", "nbin"} - set(d)
        if missing:
            raise ValueError(f"session meta missing {sorted(missing)}")
        return cls(**d)

    def to_dict(self) -> dict:
        return asdict(self)


class CleanState:
    """The resident per-session state: growing host slabs and the
    provisional mask.  ``append_block`` is the only mutator; the views the
    properties return are slices of the live slabs (copy before keeping
    them)."""

    def __init__(self, meta: SessionMeta) -> None:
        self.meta = meta
        self.nsub = 0
        self._cap = 0
        self._raw: np.ndarray | None = None    # (cap, npol, nchan, nbin)
        self._w: np.ndarray | None = None      # (cap, nchan)
        self._psc: np.ndarray | None = None    # (cap, nchan, nbin)
        # Dedispersion rotation is fixed by the session metadata (the same
        # integer-bin shifts preprocess() derives), computed once.
        if meta.dedispersed:
            self._shifts = np.zeros(meta.nchan, dtype=np.int64)
        else:
            self._shifts = dispersion_shifts(
                np.asarray(meta.freqs, np.float64), meta.dm, meta.period,
                meta.nbin, meta.centre_frequency)
        # Provisional mask over the arrived subints — advisory: the
        # authoritative mask only exists at finalize.
        self.prov_w = np.zeros((0, meta.nchan), dtype=np.float32)

    def _grow_to(self, need: int) -> None:
        if need <= self._cap:
            return
        m = self.meta
        new_cap = max(4, self._cap)
        while new_cap < need:
            new_cap *= 2
        raw = np.zeros((new_cap, m.npol, m.nchan, m.nbin), np.float32)
        w = np.zeros((new_cap, m.nchan), np.float32)
        psc = np.zeros((new_cap, m.nchan, m.nbin), np.float32)
        if self.nsub:
            raw[: self.nsub] = self._raw[: self.nsub]
            w[: self.nsub] = self._w[: self.nsub]
            psc[: self.nsub] = self._psc[: self.nsub]
        self._raw, self._w, self._psc = raw, w, psc
        self._cap = new_cap

    @property
    def capacity(self) -> int:
        return self._cap

    def append_block(self, data: np.ndarray, weights: np.ndarray) -> int:
        """Validate and append one subint block; returns the block's first
        subint index.  ``data`` is (bsub, npol, nchan, nbin) (a 3-D block is
        taken as npol=1), ``weights`` (bsub, nchan)."""
        m = self.meta
        data = np.asarray(data, dtype=np.float32)
        if data.ndim == 3:
            data = data[:, None]
        if data.ndim != 4 or data.shape[1:] != (m.npol, m.nchan, m.nbin):
            raise ValueError(
                f"block data shape {data.shape} does not match the session "
                f"(bsub, {m.npol}, {m.nchan}, {m.nbin})")
        bsub = data.shape[0]
        if bsub < 1:
            raise ValueError("empty block")
        weights = np.asarray(weights, dtype=np.float32)
        if weights.shape != (bsub, m.nchan):
            raise ValueError(
                f"block weights shape {weights.shape} != ({bsub}, {m.nchan})")
        lo = self.nsub
        self._grow_to(lo + bsub)
        self._raw[lo: lo + bsub] = data
        self._w[lo: lo + bsub] = weights
        # Incremental pscrunch + dedisperse — per-subint independent, so the
        # block's rows are final the moment they land.
        self._psc[lo: lo + bsub] = roll_cube(
            pscrunch(data, m.state), self._shifts)
        self.nsub += bsub
        return lo

    @property
    def raw(self) -> np.ndarray:
        return self._raw[: self.nsub]

    @property
    def weights(self) -> np.ndarray:
        return self._w[: self.nsub]

    @property
    def pscrunched(self) -> np.ndarray:
        return self._psc[: self.nsub]

    def provisional_inputs(self) -> tuple[np.ndarray, np.ndarray]:
        """(D, w0) for a provisional pass over everything arrived so far:
        the incremental pscrunched/dedispersed slab with the baseline
        re-removed against the current accumulated total-profile window."""
        if self.nsub == 0:
            raise ValueError("no blocks ingested yet")
        D = remove_baseline(self.pscrunched, self.weights)
        return np.ascontiguousarray(D, np.float32), self.weights.copy()

    def assemble_archive(self) -> Archive:
        """The completed stream as a plain Archive — the canonical-finalize
        input (for a session fed from a file tail, identical to the file's
        own content)."""
        m = self.meta
        return Archive(
            data=self.raw.copy(),
            weights=self.weights.copy(),
            freqs=np.asarray(m.freqs, np.float64),
            centre_frequency=m.centre_frequency,
            dm=m.dm,
            period=m.period,
            source=m.source,
            mjd_start=m.mjd_start,
            mjd_end=m.mjd_end,
            state=m.state,
            dedispersed=m.dedispersed,
            filename=f"stream_{m.source}",
        )
