"""CLI ``--follow``: the online subsystem over a growing archive file.

Port of ``iterative_cleaner_tpu/online/follow.py``.
``ict-clean-torch --follow obs.npz`` tails the file (``io/tail.py``), feeds
each newly-landed subint range through an :class:`OnlineSession`
(provisional zap alerts within one poll of a block landing), and at
end-of-stream — the ``obs.npz.eos`` sentinel, or no growth for
``--follow_timeout`` — runs the canonical finalize on the completed file and
emits the standard outputs (cleaned archive, clean.log, residual,
``--dump_masks``, the ``--report`` entry) exactly as an offline run of the
finished file would.  The final mask is the oracle's on the completed cube;
the alerts along the way are advisory.

Not to be confused with ``--stream``, the bounded-host-residency batch
loader for directories of complete archives.
"""

from __future__ import annotations

import sys

from iterative_cleaner_tpu_torch.config import CleanConfig
from iterative_cleaner_tpu_torch.io.base import get_io
from iterative_cleaner_tpu_torch.io.tail import tail_blocks
from iterative_cleaner_tpu_torch.online.session import (
    DEFAULT_ALERT_ITERS,
    OnlineSession,
    ZapAlert,
)
from iterative_cleaner_tpu_torch.online.state import SessionMeta


def _print_alert(path: str, alert: ZapAlert) -> None:
    pairs = ", ".join(f"({s},{c})" for s, c in alert.new_zaps[:8])
    more = alert.n_new_zaps - min(len(alert.new_zaps), 8)
    print(
        f"follow {path}: block {alert.block_index} "
        f"(subints {alert.subint_lo}:{alert.subint_hi}) -> "
        f"{alert.n_new_zaps} provisional zap(s)"
        + (f" [{pairs}{f', +{more} more' if more > 0 else ''}]"
           if alert.n_new_zaps else "")
        + f", rfi_frac={alert.provisional_rfi_frac:.4f}, "
          f"{alert.latency_s * 1e3:.0f} ms",
        file=sys.stderr)


def follow_archive(
    path: str,
    cfg: CleanConfig,
    poll_s: float = 1.0,
    idle_timeout_s: float = 30.0,
    alert_iters: int = DEFAULT_ALERT_ITERS,
    log_dir: str = ".",
    all_paths: list[str] | None = None,
    sleep=None,
    device="cuda",
):
    """Tail one growing archive to completion on ``device``; returns the
    ArchiveReport.  Per-archive errors are the caller's to isolate
    (``driver.run_follow``)."""
    from iterative_cleaner_tpu_torch.driver import emit_outputs, residual_name
    from iterative_cleaner_tpu_torch.online.finalize import finalize_session

    session = None
    final_archive = None
    for archive, lo, hi in tail_blocks(
            path, poll_s=poll_s, idle_timeout_s=idle_timeout_s, sleep=sleep):
        if session is None:
            session = OnlineSession(SessionMeta.from_archive(archive), cfg,
                                    alert_iters=alert_iters, device=device)
            if not cfg.quiet:
                print(f"follow {path}: session open "
                      f"(nchan={archive.nchan}, nbin={archive.nbin})",
                      file=sys.stderr)
        alert = session.ingest(archive.data[lo:hi], archive.weights[lo:hi])
        if not cfg.quiet:
            _print_alert(path, alert)
        final_archive = archive

    if session is None:
        raise ValueError(f"{path}: stream ended with no subints")
    # Finalize against the last on-disk content, not the assembled slab:
    # exactly what an offline rerun of the finished file sees.
    fin = finalize_session(session, archive=final_archive)
    session.finalized = True
    out = fin.output
    res = out.result
    if not cfg.quiet:
        print(f"follow {path}: end of stream after "
              f"{session.blocks_ingested} block(s), "
              f"{final_archive.nsub} subints; running the canonical clean "
              f"(provisional mask disagreed on "
              f"{fin.provisional_mismatches} profile(s))", file=sys.stderr)

    io = get_io(path)
    if cfg.unload_res and out.residual is not None:
        io.save(out.residual, residual_name(path, res.loops))
    return emit_outputs(
        io,
        final_archive,
        path,
        out.cleaned,
        res.test_results,
        res.loops,
        res.converged,
        res.rfi_frac,
        cfg,
        log_dir,
        all_paths if all_paths is not None else [path],
        history=res.history,
        iteration_s=[i.duration_s for i in res.iterations] if res.timed
        else None,
    )
