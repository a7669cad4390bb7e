"""Per-archive driver: load → clean → side outputs → save.

Port of ``iterative_cleaner_tpu/driver.py:23-288`` and ``:529-577``: output
naming, the residual archive, the mask dump, the append-only clean.log, the
reference's console strings (docs/PARITY.md), per-archive failure isolation
and a one-archive read-ahead for sequential batches.  Sweep, follow, the
sharded batch and streaming are not yet ported.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from iterative_cleaner_tpu_torch.config import CleanConfig
from iterative_cleaner_tpu_torch.io.base import Archive, get_io, known_extension as _ext
from iterative_cleaner_tpu_torch.models.surgical import SurgicalCleaner, SurgicalOutput


def output_name(cfg: CleanConfig, archive: Archive | None, path: str) -> str:
    """Reference naming modes: ``<original name>_cleaned<ext>`` by default,
    ``NAME.FREQ.MJD<ext>`` for ``-o std``, else ``-o`` verbatim."""
    if cfg.output == "":
        return f"{path}_cleaned{_ext(path)}"
    if cfg.output == "std":
        return "%s.%.3f.%f%s" % (
            archive.source,
            archive.centre_frequency,
            archive.mjd_mid,
            _ext(path),
        )
    return cfg.output


def residual_name(path: str, loops: int) -> str:
    return f"{path}_residual_{loops}{_ext(path)}"


@dataclass
class ArchiveReport:
    path: str
    out_path: str | None
    loops: int = 0
    rfi_frac: float = 0.0
    converged: bool = False
    error: str | None = None
    # Host wall-clock per iteration (stepwise routes; the fused loop has no
    # per-iteration laps, so it leaves this empty rather than reporting zeros).
    iteration_s: list[float] = field(default_factory=list)
    audit: dict | None = None      # --audit record


def atomic_save(io, archive: Archive, o_name: str) -> None:
    """Write-then-rename, so a crash mid-save never leaves a truncated file
    under the final name."""
    tmp = f"{o_name}.part"
    io.save(archive, tmp)
    os.replace(tmp, o_name)


def dump_masks(o_name: str, history, test_results, loops: int, converged: bool) -> None:
    """Mask audit dump beside the cleaned archive: per-iteration masks
    (pre-loop weights first), last scores, loops, converged."""
    payload = dict(test_results=test_results, loops=loops, converged=converged)
    if history:
        payload["history"] = np.stack(history)
    np.savez_compressed(f"{o_name}_masks.npz", **payload)


def emit_outputs(io, archive: Archive, path: str, cleaned: Archive, test_results,
                 loops: int, converged: bool, rfi_frac: float, cfg: CleanConfig,
                 log_dir: str, all_paths: list[str], history=None,
                 iteration_s: list[float] | None = None) -> ArchiveReport:
    """Save, mask dump, clean.log line, report."""
    o_name = output_name(cfg, archive, path)
    atomic_save(io, cleaned, o_name)

    if cfg.dump_masks:
        dump_masks(o_name, history, test_results, loops, converged)

    if not cfg.no_log:
        # Reference log line format.
        with open(os.path.join(log_dir, "clean.log"), "a") as fh:
            fh.write(
                "\n %s: Cleaned %s with %s, required loops=%s"
                % (datetime.datetime.now(), path, cfg.namespace_repr(all_paths), loops)
            )

    if not cfg.quiet:
        print("Cleaned archive: %s" % o_name)
    return ArchiveReport(path=path, out_path=o_name, loops=loops, rfi_frac=rfi_frac,
                         converged=converged, iteration_s=iteration_s or [])


def process_archive(path: str, cfg: CleanConfig, log_dir: str = ".",
                    all_paths: list[str] | None = None,
                    archive: Archive | None = None, device="cuda") -> ArchiveReport:
    """Clean one archive.  ``all_paths`` is the full invocation (the
    reference logs it in every log line); ``archive`` skips the load."""
    io = get_io(path)
    if archive is None:
        archive = io.load(path)

    def progress(info):
        if not cfg.quiet:
            print(f"Loop: {info.index}")
            print(
                "Differences to previous weights: %s  RFI fraction: %s"
                % (info.diff_weights, info.rfi_frac)
            )

    if not cfg.quiet:
        print("Total number of profiles: %s" % archive.weights.size)
    out: SurgicalOutput = SurgicalCleaner(cfg, device=device).clean(archive, progress=progress)
    res = out.result

    if not cfg.quiet:
        if res.converged:
            print("RFI removal stops after %s loops." % res.loops)
        else:
            print("Cleaning was interrupted after the maximum amount of loops (%s)"
                  % cfg.max_iter)
        if out.n_bad_subints + out.n_bad_channels != 0:
            print("Removed %s bad subintegrations and %s bad channels."
                  % (out.n_bad_subints, out.n_bad_channels))

    if cfg.unload_res and out.residual is not None:
        io.save(out.residual, residual_name(path, res.loops))

    report = emit_outputs(
        io, archive, path, out.cleaned, res.test_results, res.loops, res.converged,
        res.rfi_frac, cfg, log_dir, all_paths if all_paths is not None else [path],
        history=res.history,
        iteration_s=[i.duration_s for i in res.iterations] if res.timed else None,
    )
    if out.audit is not None:
        report.audit = out.audit
        if not out.audit.get("mask_identical", True):
            # A parity break is never silenced (-q gates chatter only).
            print(f"AUDIT DIVERGENCE {path}: {out.audit.get('n_mask_diffs')} mask "
                  f"bit(s) differ from the numpy oracle", file=sys.stderr)
        elif not cfg.quiet and "skipped" not in out.audit:
            print("Audit: mask identical to the numpy oracle (max score drift "
                  f"{out.audit.get('max_score_drift', 0) or 0:.2e})")
    return report


def write_report(reports: list[ArchiveReport], path: str) -> None:
    """Machine-readable batch summary (--report), written atomically."""
    tmp = f"{path}.part"
    with open(tmp, "w") as fh:
        json.dump([dataclasses.asdict(r) for r in reports], fh, indent=2)
        fh.write("\n")
    os.replace(tmp, path)


def run(paths: list[str], cfg: CleanConfig, log_dir: str = ".",
        device="cuda") -> list[ArchiveReport]:
    """Sequential batch with per-archive failure isolation and one-archive
    read-ahead: a loader thread decodes archive k+1 while archive k cleans."""
    invocation = list(paths)

    def load(path: str):
        try:
            return get_io(path).load(path), None
        except Exception as exc:  # noqa: BLE001 — isolate, report, continue
            return None, str(exc)

    reports = []
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(load, paths[0]) if paths else None
        for k, path in enumerate(paths):
            archive, err = fut.result()
            fut = pool.submit(load, paths[k + 1]) if k + 1 < len(paths) else None
            if err is None:
                try:
                    reports.append(process_archive(
                        path, cfg, log_dir=log_dir, all_paths=invocation,
                        archive=archive, device=device))
                    continue
                except Exception as exc:  # noqa: BLE001
                    err = str(exc)
            reports.append(ArchiveReport(path=path, out_path=None, error=err))
            # Failures are never silenced — -q only gates progress chatter.
            print(f"ERROR cleaning {path}: {err}", file=sys.stderr)
    return reports
