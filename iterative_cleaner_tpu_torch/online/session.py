"""One online cleaning session: blocks in, provisional zap alerts out.

Port of ``iterative_cleaner_tpu/online/session.py``.  After every ingested
block the session runs a bounded provisional clean pass over everything
that has arrived (``alert_iters`` iterations, default 2) and reports which
(subint, channel) profiles it would newly zap — the operator's RFI alarm.
The pass is the canonical loop (:class:`..core.cleaner.LoopState`),
warm-started from the previous block's provisional mask, over:

- the torch backend: :class:`..parallel.chunked.ChunkedTorchCleaner` on
  ``device`` with a fixed subint slab (``pass_block``, the power-of-two
  ceiling of the first block), so the fit/moments kernel sees the same slab
  shapes the JAX package's chunked pass gives its Pallas kernel, and the
  alerts match;
- the numpy backend: the oracle.

Provisional masks are advisory, never authoritative: a session only
produces its real mask at :meth:`finalize`, which runs the canonical
pipeline on the completed cube — the normal offline path on the assembled
archive, identical to the numpy oracle by the repo's core invariant.

Each ingest is timed into the ``online_block`` phase (and its pass into
``online_pass``), counts ``online_blocks_ingested`` and
``online_zap_alerts``, and emits an ``online_block`` event, as the JAX
session does.  The JAX session's compile-budget accounting has no
counterpart (PyTorch does not compile per shape).
"""

from __future__ import annotations

import time
from dataclasses import asdict, dataclass, field

import numpy as np

from iterative_cleaner_tpu_torch.config import CleanConfig
from iterative_cleaner_tpu_torch.core.cleaner import LoopState
from iterative_cleaner_tpu_torch.obs import events, tracing
from iterative_cleaner_tpu_torch.online.state import CleanState, SessionMeta

#: Alert payloads list at most this many newly-zapped (subint, channel)
#: pairs; beyond it only the count is reported (``truncated: true``).
MAX_ALERT_PAIRS = 256

#: Default bounded-pass iteration count: iteration 1 reacts to the new block
#: through the carried template, iteration 2 settles the template it
#: perturbed; the canonical fixed point is finalize's job.
DEFAULT_ALERT_ITERS = 2


@dataclass
class ZapAlert:
    """One block's provisional verdict."""

    block_index: int               # 0-based arrival number
    subint_lo: int                 # the block's first subint
    subint_hi: int                 # one past its last subint
    nsub_total: int                # session subints after this block
    n_new_zaps: int                # profiles newly zapped by this pass
    new_zaps: list[list[int]] = field(default_factory=list)
    truncated: bool = False        # new_zaps capped at MAX_ALERT_PAIRS
    provisional_rfi_frac: float = 0.0
    pass_iterations: int = 0
    pass_converged: bool = False
    latency_s: float = 0.0         # ingest + pass wall-clock for this block

    def to_dict(self) -> dict:
        return asdict(self)


class OnlineSession:
    """Accepts subint blocks incrementally; see the module docstring.
    ``device`` is where the torch backend's passes and the finalize run
    (default the card; raises when there is none)."""

    def __init__(
        self,
        meta: SessionMeta,
        cfg: CleanConfig | None = None,
        alert_iters: int = DEFAULT_ALERT_ITERS,
        device="cuda",
    ) -> None:
        self.meta = meta
        self.cfg = cfg or CleanConfig(backend="torch")
        if alert_iters < 1:
            raise ValueError(f"alert_iters must be >= 1, got {alert_iters}")
        self.alert_iters = int(alert_iters)
        # Fixed chunked-pass slab size, set by the first block.
        self._pass_block = 0
        self.device = device
        self.state = CleanState(meta)
        self.blocks_ingested = 0
        self.alerts: list[ZapAlert] = []
        self.finalized = False

    def _append(self, data: np.ndarray, weights: np.ndarray) -> int:
        lo = self.state.append_block(data, weights)
        if not self._pass_block:
            # Pow2 ceiling of the first block: most passes then run on
            # whole slabs of this one shape.
            self._pass_block = 1 << max(0, (self.state.nsub - lo) - 1
                                        ).bit_length()
        return lo

    def ingest(self, data: np.ndarray, weights: np.ndarray) -> ZapAlert:
        """Append one block, run the bounded provisional pass, return the
        alert.  Raises ValueError on shape mismatches and on a finalized
        session.  A pass that dies rolls the append back, so the session
        never diverges from what the caller believes was accepted — the
        block can simply be resubmitted."""
        if self.finalized:
            raise ValueError("session already finalized")
        with tracing.phase("online_block"):
            t0 = time.perf_counter()
            lo = self._append(data, weights)
            hi = self.state.nsub
            try:
                with tracing.phase("online_pass"):
                    alert = self._provisional_pass(lo, hi)
            except Exception:
                # Rows beyond nsub are inert; the capacity stays for the
                # retry.  prov_w was not touched: _provisional_pass assigns
                # it only on success.
                self.state.nsub = lo
                raise
            alert.latency_s = time.perf_counter() - t0
        tracing.count("online_blocks_ingested")
        tracing.count("online_zap_alerts", alert.n_new_zaps)
        if events.active():
            # Inherits the trace context of the caller (the --follow driver
            # runs under the CLI's).
            events.emit("online_block", block_index=alert.block_index,
                        subint_lo=alert.subint_lo, subint_hi=alert.subint_hi,
                        n_new_zaps=alert.n_new_zaps,
                        provisional_rfi_frac=round(alert.provisional_rfi_frac, 6),
                        pass_converged=alert.pass_converged,
                        latency_s=round(alert.latency_s, 6))
        self.blocks_ingested += 1
        self.alerts.append(alert)
        return alert

    def replay_block(self, data: np.ndarray, weights: np.ndarray) -> None:
        """Spool replay (restart resume): append without the provisional
        pass.  The first live ingest after a replay seeds its pass from the
        original weights (prov_w is empty), like a fresh session's first
        pass over the accumulated cube."""
        if self.finalized:
            raise ValueError("session already finalized")
        self._append(data, weights)
        self.blocks_ingested += 1

    def _backend(self, D: np.ndarray, w0: np.ndarray):
        if self.cfg.backend != "torch":
            from iterative_cleaner_tpu_torch.backends.numpy_backend import NumpyCleaner

            return NumpyCleaner(D, w0, self.cfg)
        from iterative_cleaner_tpu_torch.parallel.chunked import ChunkedTorchCleaner

        return ChunkedTorchCleaner(D, w0, self.cfg, block=min(self._pass_block, D.shape[0]),
                                   device=self.device)

    def _provisional_pass(self, lo: int, hi: int) -> ZapAlert:
        D, w0 = self.state.provisional_inputs()
        # Warm-start seed: the previous provisional mask, extended with the
        # new block's own original weights.  The seed only shapes the first
        # template (stats run against the frozen w0), so a bad earlier
        # provisional can always be un-flagged by a later pass.
        seed = (np.concatenate([self.state.prov_w, w0[lo:]], axis=0)
                if self.state.prov_w.size else w0.copy())
        loop = LoopState.start(seed)
        loop.run(self._backend(D, w0), self.alert_iters, timed=False)
        new_prov = loop.history[-1]

        newly = np.argwhere((new_prov == 0) & (seed != 0))
        alert = ZapAlert(
            block_index=self.blocks_ingested,
            subint_lo=lo,
            subint_hi=hi,
            nsub_total=hi,
            n_new_zaps=int(len(newly)),
            new_zaps=newly[:MAX_ALERT_PAIRS].tolist(),
            truncated=len(newly) > MAX_ALERT_PAIRS,
            provisional_rfi_frac=float((new_prov == 0).mean()),
            pass_iterations=len(loop.infos),
            pass_converged=loop.converged,
        )
        self.state.prov_w = new_prov
        return alert

    def finalize(self, progress=None):
        """Canonical end-of-stream clean (``online/finalize.py``); marks the
        session closed.  Returns the FinalizedSession."""
        from iterative_cleaner_tpu_torch.online.finalize import finalize_session

        out = finalize_session(self, progress=progress)
        self.finalized = True
        return out
