"""End-of-stream finalization: the canonical clean on the completed cube.

Port of ``iterative_cleaner_tpu/online/finalize.py``.  Deliberately not an
incremental algorithm: the provisional passes exist for alert latency; the
authoritative mask comes from running the ordinary offline pipeline
(:class:`..models.surgical.SurgicalCleaner` — preprocess, clean_cube,
bad-parts sweep, output policy) on the assembled archive, on the session's
device, so the online subsystem inherits the core invariant — final masks
identical to the numpy oracle — by construction.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from iterative_cleaner_tpu_torch.io.base import Archive
from iterative_cleaner_tpu_torch.models.surgical import SurgicalCleaner, SurgicalOutput


@dataclass
class FinalizedSession:
    archive: Archive               # the assembled completed cube
    output: SurgicalOutput         # canonical pipeline output
    n_provisional_zaps: int        # advisory mask's zap count at end of stream
    n_final_zaps: int              # authoritative mask's zap count
    provisional_mismatches: int    # profiles where the two disagree

    @property
    def result(self):
        return self.output.result

    def to_dict(self) -> dict:
        res = self.output.result
        return {
            "loops": int(res.loops),
            "converged": bool(res.converged),
            "rfi_frac": float(res.rfi_frac),
            "nsub": int(self.archive.nsub),
            "n_provisional_zaps": int(self.n_provisional_zaps),
            "n_final_zaps": int(self.n_final_zaps),
            "provisional_mismatches": int(self.provisional_mismatches),
        }


def finalize_session(session, archive: Archive | None = None,
                     progress=None) -> FinalizedSession:
    """Run the canonical pipeline over the session's completed cube on the
    session's device.  ``archive`` overrides the assembled slab: the
    ``--follow`` tail passes the final on-disk archive, so the clean sees
    exactly what an offline rerun of the same file would."""
    if session.state.nsub == 0:
        raise ValueError("cannot finalize a session with no blocks")
    if archive is None:
        archive = session.state.assemble_archive()
    out = SurgicalCleaner(session.cfg, device=session.device).clean(
        archive, progress=progress)

    # How good the advisory mask was when the stream ended (reported, never
    # load-bearing), against the pre-sweep iterative mask: the provisional
    # pass never runs the bad-parts sweep.
    prov = session.state.prov_w
    final_w = np.asarray(out.result.weights)
    mismatches = (
        int(np.sum((prov == 0) != (final_w == 0)))
        if prov.shape == final_w.shape else -1)
    return FinalizedSession(
        archive=archive,
        output=out,
        n_provisional_zaps=int((prov == 0).sum()),
        n_final_zaps=int((final_w == 0).sum()),
        provisional_mismatches=mismatches,
    )
