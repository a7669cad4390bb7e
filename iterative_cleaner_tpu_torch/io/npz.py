"""NPZ archive backend — the canonical, hermetic file format.

A copy of ``iterative_cleaner_tpu/io/npz.py``: stores exactly the fields of
:class:`..io.base.Archive`, so files written by either package load in both.
"""

from __future__ import annotations

import numpy as np

from iterative_cleaner_tpu_torch.io.base import Archive


class NpzIO:
    def load(self, path: str) -> Archive:
        with np.load(path, allow_pickle=False) as z:
            return Archive(
                data=np.asarray(z["data"], dtype=np.float32),
                weights=np.asarray(z["weights"], dtype=np.float32),
                freqs=np.asarray(z["freqs"], dtype=np.float64),
                centre_frequency=float(z["centre_frequency"]),
                dm=float(z["dm"]),
                period=float(z["period"]),
                source=str(z["source"]),
                mjd_start=float(z["mjd_start"]),
                mjd_end=float(z["mjd_end"]),
                state=str(z["state"]),
                dedispersed=bool(z["dedispersed"]),
                filename=path,
            )

    def save(self, archive: Archive, path: str) -> None:
        # Through a file object: np.savez with a str path appends .npz to
        # unfamiliar suffixes, which breaks write-to-temp-then-rename.
        with open(path, "wb") as fh:
            np.savez_compressed(
                fh,
                data=archive.data.astype(np.float32),
                weights=archive.weights.astype(np.float32),
                freqs=np.asarray(archive.freqs, dtype=np.float64),
                centre_frequency=np.float64(archive.centre_frequency),
                dm=np.float64(archive.dm),
                period=np.float64(archive.period),
                source=np.str_(archive.source),
                mjd_start=np.float64(archive.mjd_start),
                mjd_end=np.float64(archive.mjd_end),
                state=np.str_(archive.state),
                dedispersed=np.bool_(archive.dedispersed),
            )
