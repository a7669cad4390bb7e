"""Single-device cleaning of cubes beyond the card's memory: stream subint
blocks.

Port of ``iterative_cleaner_tpu/parallel/chunked.py:76-386``
(``ChunkedJaxCleaner`` as :class:`ChunkedTorchCleaner`).  The cube stays in
host memory and ``(block, nchan, nbin)`` subint slabs stream through the
card inside each iteration, in two passes built from the same functions as
the in-memory route, so the semantics cannot drift:

1. **template pass** — the weighted scrunch
   (:func:`..ops.template.build_template`) continued block by block in
   block order: each block's sum starts from the running template, so the
   streamed sum is the whole-cube sum in the oracle's order, bit for bit
   (the JAX package adds per-block sums, which reorders the f32 sum).
2. **stats pass** — per block the CUDA fit/moments kernel plus the FFT
   diagnostic, or the plain route (fit, subtract, weight, the four
   diagnostics): per-profile math, identical to the in-memory route.  Only
   the (nsub, nchan) maps stay on the device; the robust scalers run once
   on the assembled maps.

Under ``--x64`` the host cube, the running template, the maps and the
residual are float64; the template is still continued block by block in
the oracle's order, so the streamed float64 sum is the in-memory one bit for
bit (the JAX package's reordered per-block sums are not).

Both passes run through the port's double-buffered uploader
(:mod:`..ingest.pipeline`): block k+1 uploads on a copy stream while block
k computes, with ``depth`` (default two) device slabs live.  From
iteration 2 the template pass drops out when few enough profiles flipped
(``cfg.incremental_template``): the carried template is advanced by a host
gather of at most ``INCREMENTAL_TEMPLATE_BUDGET`` profiles; an over-budget
flip count or a non-finite profile or candidate falls back to the dense
streamed pass.  A stepwise backend, so per-loop progress, the mask history
and the residual archive keep working.
"""

from __future__ import annotations

import numpy as np
import torch

from iterative_cleaner_tpu_torch.backends.torch_backend import (
    INCREMENTAL_TEMPLATE_BUDGET,
    compute_dtype,
    device_for,
    kernel_for,
    note_sparse_step,
    to_device,
    upload,
)
from iterative_cleaner_tpu_torch.config import CleanConfig
from iterative_cleaner_tpu_torch.ingest.pipeline import SlabUploader, stream_depth
from iterative_cleaner_tpu_torch.ops.fused_kernels import fused_fit_moments
from iterative_cleaner_tpu_torch.ops.stats import diagnostics, fft_diagnostic, scale_and_combine
from iterative_cleaner_tpu_torch.ops.template import build_template, fit_and_subtract


def block_maps(Dblk, template, w0blk, validblk, pulse_region, use_kernel):
    """The (std, mean, ptp, fft) maps of one block of subints (a batch's
    block, ``(a, rows, nchan, nbin)`` with ``(a, nbin)`` templates, too:
    the rank-sharded route's)."""
    if use_kernel:
        centred, d_mean, d_std, d_ptp = fused_fit_moments(
            Dblk, template, w0blk, validblk, pulse_region=pulse_region)
        return d_std, d_mean, d_ptp, fft_diagnostic(centred)
    _amp, resid = fit_and_subtract(Dblk, template, pulse_region)
    return diagnostics(resid * w0blk[..., None], validblk)


class ChunkedTorchCleaner:
    """CleanerBackend streaming subint blocks through one device.

    ``block`` is the subint slab size (from
    :func:`..parallel.autoshard.chunk_block_subints` when routed
    automatically).  ``keep_residual`` enables ``residual()``: the last
    step's residual cube, assembled in host memory, computed lazily on the
    first call by re-running the two passes for the last step's weights.
    ``template_passes`` counts the full streamed template passes.
    """

    def __init__(self, D: np.ndarray, w0: np.ndarray, cfg: CleanConfig, block: int,
                 keep_residual: bool = False, ingest_depth: int | None = None,
                 device="cuda") -> None:
        self.device = device_for(device)
        self.cfg = cfg
        self.block = int(block)
        if self.block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        self._dtype = compute_dtype(cfg)
        # Host-resident by design: the whole cube never goes to the device.
        self._D = np.ascontiguousarray(D, dtype=np.float64 if cfg.x64 else np.float32)  # ict: f64-ok(explicit --x64 opt-in)
        self._w0 = upload(self.device, self._dtype, w0)[0]
        self._valid = self._w0 != 0
        self._use_kernel = kernel_for(cfg, self._D.shape[-1], self.device)
        self._depth = stream_depth() if ingest_depth is None else max(1, int(ingest_depth))
        self.uploader = SlabUploader(self._D, self.block, self.device, self._depth)
        self._pr = tuple(cfg.pulse_region)
        self._keep_residual = keep_residual
        self._resid_w_prev: np.ndarray | None = None  # last step's weights
        self._residual: np.ndarray | None = None      # lazily-filled cache
        self._tmpl: torch.Tensor | None = None        # carried template …
        self._tmpl_w: np.ndarray | None = None        # … and its weights
        self._tmpl_dense = False                      # built by the streamed pass
        self.template_passes = 0

    def _blocks(self):
        nsub = self._D.shape[0]
        return [(lo, min(lo + self.block, nsub)) for lo in range(0, nsub, self.block)]

    def _stream(self, compute) -> list:
        return self.uploader.stream(self._blocks(), compute, self._depth)

    def _template(self, w_prev: torch.Tensor) -> torch.Tensor:
        """Pass 1: the template continued over the streamed blocks, in
        block order (the same values as the in-memory build)."""
        self.template_passes += 1
        acc = [torch.zeros(self._D.shape[-1], dtype=self._dtype, device=self.device)]

        def accumulate(lo, hi, Dblk):
            acc[0] = build_template(Dblk, w_prev[lo:hi], init=acc[0])

        self._stream(accumulate)
        return acc[0]

    def _template_for(self, w_host: np.ndarray) -> torch.Tensor:
        """Template for these weights: from iteration 2 the carried template
        plus ``sum (Δw)·profile`` over at most the budget of flipped profiles
        (a host gather); the dense streamed pass when there is no carry, too
        many flipped, a gathered profile is not finite, or the candidate is
        not finite."""
        tmpl = None
        dense = False  # provenance of the value carried on
        if self.cfg.incremental_template and self._tmpl_w is not None:
            flat = (w_host - self._tmpl_w).reshape(-1)
            idx = np.nonzero(flat)[0]
            budget = min(INCREMENTAL_TEMPLATE_BUDGET, flat.size)
            if idx.size == 0:
                tmpl, dense = self._tmpl, self._tmpl_dense
            elif idx.size <= budget:
                s, c = np.unravel_index(idx, w_host.shape)
                profs = self._D[s, c, :]
                if np.isfinite(profs).all():
                    pad = budget - idx.size
                    dvals = to_device(np.pad(flat[idx], (0, pad)), self.device, self._dtype)
                    profs = to_device(np.pad(profs, ((0, pad), (0, 0))), self.device,
                                      self._dtype)
                    cand = self._tmpl + torch.matmul(dvals, profs)
                    if bool(torch.isfinite(cand).all()):
                        tmpl = cand
                        note_sparse_step()
        if tmpl is None:
            tmpl = self._template(to_device(w_host, self.device, self._dtype))
            dense = True
        self._tmpl, self._tmpl_w, self._tmpl_dense = tmpl, w_host.copy(), dense
        return tmpl

    def step(self, w_prev: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        w_host = np.asarray(w_prev, dtype=self._D.dtype)
        if self._keep_residual:
            # residual() recomputes from these weights on demand.
            self._resid_w_prev = w_host
            self._residual = None
        template = self._template_for(w_host)

        def block_stats(lo, hi, Dblk):
            return block_maps(Dblk, template, self._w0[lo:hi], self._valid[lo:hi],
                              self._pr, self._use_kernel)

        maps = self._stream(block_stats)
        d_std, d_mean, d_ptp, d_fft = (torch.cat([m[k] for m in maps]) for k in range(4))
        test = scale_and_combine(d_std, d_mean, d_ptp, d_fft, self._valid,
                                 float(self.cfg.chanthresh), float(self.cfg.subintthresh))
        # Zap where test >= 1; NaN never flags.
        new_w = torch.where(test >= 1.0, torch.zeros((), dtype=test.dtype,
                                                     device=self.device), self._w0)
        return test.cpu().numpy(), new_w.cpu().numpy()

    def residual(self) -> np.ndarray | None:
        """The last step's residual, recomputed lazily from a dense template
        (a sparse-updated carry is never reused: the residual archive stays
        bit-exact with the in-memory route)."""
        if not self._keep_residual or self._resid_w_prev is None:
            return None
        if self._residual is None:
            if (self._tmpl is not None and self._tmpl_dense
                    and np.array_equal(self._resid_w_prev, self._tmpl_w)):
                template = self._tmpl  # current and dense-built: reusable
            else:
                template = self._template(to_device(self._resid_w_prev, self.device,
                                                    self._dtype))
            self._residual = np.empty(self._D.shape, self._D.dtype)

            def fetch_block(lo, hi, Dblk):
                _amp, resid = fit_and_subtract(Dblk, template, self._pr)
                self._residual[lo:hi] = resid.cpu().numpy()

            self._stream(fetch_block)
        return self._residual
