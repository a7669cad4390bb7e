"""The surgical RFI cleaner: archive in, cleaned archive out.

Port of ``iterative_cleaner_tpu/models/surgical.py:24-134``: preprocessing,
the iterative loop, the bad-parts sweep, the output policy and the residual
archive.  While the host preprocesses, a warm-up thread
(``backends/torch_backend.start_precompile``) loads the kernel library and
runs one dummy step of the route on a zero cube of the real shape.
``--audit`` replays the same preprocessed inputs through the port's copy of
the numpy oracle and compares the final masks and the scores
(``obs/audit.run_audit``); a divergence writes a repro bundle under
``obs.audit.default_repro_dir()``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from iterative_cleaner_tpu_torch.config import CleanConfig
from iterative_cleaner_tpu_torch.core.cleaner import (
    CleanResult,
    ProgressFn,
    clean_cube,
    find_bad_parts,
)
from iterative_cleaner_tpu_torch.io.base import STATE_INTENSITY, Archive
from iterative_cleaner_tpu_torch.ops.preprocess import preprocess, pscrunch, redisperse_cube

@dataclass
class SurgicalOutput:
    cleaned: Archive               # original data, cleaned weights
    result: CleanResult
    residual: Archive | None       # reference --unload_res payload
    n_bad_subints: int = 0
    n_bad_channels: int = 0
    audit: dict | None = None      # --audit record


def apply_output_policy(archive: Archive, weights: np.ndarray, cfg: CleanConfig) -> Archive:
    """Cleaned output archive: original amplitudes + new weights; full-pol
    unless -p.  The input archive is never mutated."""
    if cfg.pscrunch and archive.npol > 1:
        out_data = pscrunch(archive.data, archive.state)[:, None]
        out_state = STATE_INTENSITY
    else:
        out_data = archive.data
        out_state = archive.state
    return replace(
        archive,
        data=out_data,
        weights=np.asarray(weights, dtype=np.float32),
        state=out_state,
    )


def finalize_weights(weights: np.ndarray, cfg: CleanConfig):
    """The bad-parts sweep, run only when a flag differs from 1 (as the
    reference does).  Returns (weights, n_bad_subints, n_bad_channels)."""
    if cfg.bad_chan != 1 or cfg.bad_subint != 1:
        return find_bad_parts(weights, cfg)
    return weights, 0, 0


class SurgicalCleaner:
    """Configured cleaner; ``clean(archive)`` runs the full pipeline on
    ``device`` (default the card; the numpy oracle ignores it)."""

    def __init__(self, cfg: CleanConfig | None = None, device="cuda") -> None:
        self.cfg = cfg or CleanConfig()
        self.device = device

    def clean(self, archive: Archive, progress: ProgressFn | None = None) -> SurgicalOutput:
        cfg = self.cfg
        # The preprocessed cube's shape is known from the header alone, so
        # the card's set-up overlaps the host preprocessing.
        from iterative_cleaner_tpu_torch.backends.torch_backend import start_precompile

        shape = (archive.data.shape[0], archive.data.shape[2], archive.data.shape[3])
        warm = start_precompile(shape, cfg, want_residual=cfg.unload_res,
                                device=self.device)
        D, w0 = preprocess(archive)
        if warm is not None:
            # A warm-up still running must not race the real call.
            warm.join()
        result = clean_cube(D, w0, cfg, progress=progress,
                            want_residual=cfg.unload_res, device=self.device)
        final_w, n_bs, n_bc = finalize_weights(result.weights, cfg)
        cleaned = apply_output_policy(archive, final_w, cfg)

        residual = None
        if cfg.unload_res and result.residual is not None:
            # The residual archive lives in the original dispersed frame
            # with the original weights.
            res_cube = redisperse_cube(archive, result.residual)
            residual = replace(
                archive,
                data=np.asarray(res_cube, np.float32)[:, None],
                weights=w0.copy(),
                state=STATE_INTENSITY,
                dedispersed=archive.dedispersed,
            )

        audit_rec = None
        if cfg.audit and cfg.backend != "numpy":
            # The audit never alters the outputs already computed above.
            from iterative_cleaner_tpu_torch.obs import audit as obs_audit

            route = ("fused" if cfg.fused else
                     "chunked" if cfg.chunk_block else "stepwise")
            audit_rec, oracle_w = obs_audit.run_audit(
                D, w0, cfg, final_w, scores_served=result.test_results,
                route=route)
            if not audit_rec["mask_identical"]:
                audit_rec["bundle"] = obs_audit.write_repro_bundle(
                    obs_audit.default_repro_dir(), D=D, w0=w0, cfg=cfg,
                    reason=f"--audit divergence on the {route} route",
                    weights_served=final_w, weights_oracle=oracle_w,
                    scores_served=result.test_results, route=route,
                    record=audit_rec)
        elif cfg.audit:
            audit_rec = {"skipped": "backend is the numpy oracle"}

        return SurgicalOutput(
            cleaned=cleaned,
            result=result,
            residual=residual,
            n_bad_subints=n_bs,
            n_bad_channels=n_bc,
            audit=audit_rec,
        )
