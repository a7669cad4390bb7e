"""Per-archive driver: load → clean → side outputs → save.

Port of ``iterative_cleaner_tpu/driver.py:23-420`` and ``:529-577``: output
naming, the residual archive, the mask dump, the append-only clean.log, the
reference's console strings (docs/PARITY.md), per-archive failure isolation,
a one-archive read-ahead for sequential batches, ``--resume``, the
directory batch (``--sharded_batch``, ``--stream``, on one card) with its
automatic switch to the streaming dispatcher above a host-memory threshold,
the online ``--follow`` tail (``run_follow``, ``:423-451``) and the
threshold sweep (``run_sweep``, ``:483-526``), with the JAX package's
telemetry: the ``job_submitted`` event and the ``clean_archive`` span per
archive, and the ``--trace`` capture (``obs/profiling.profile_trace``)
around each clean, the batch and each sweep.  The multi-host split
(``partition_paths``) is not yet ported: on one process it is the identity.
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
from iterative_cleaner_tpu_torch.obs import events, quality
from iterative_cleaner_tpu_torch.obs.profiling import profile_trace


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
    skipped: bool = False          # --resume: output already existed
    # Host wall-clock per iteration (stepwise routes; the fused loop and the
    # batch have no per-iteration laps, so they leave this empty rather than
    # reporting zeros).
    iteration_s: list[float] = field(default_factory=list)
    audit: dict | None = None      # --audit record (obs/audit.run_audit)
    quality: dict | None = None    # obs/quality.quality_summary of the saved mask


def split_resumable(paths: list[str], cfg: CleanConfig):
    """--resume: only the archives whose cleaned output is not on disk yet
    are processed.  Returns (todo_paths, skipped) with ``skipped`` keyed by
    the archive's index in the original list, so reports come back in
    invocation order.  Only the default naming mode has a path-derivable
    output name; with ``-o`` everything runs (and a warning says so)."""
    if not cfg.resume:
        return paths, {}
    if cfg.output != "":
        print("warning: --resume only skips archives in the default naming "
              "mode (-o was given); cleaning everything", file=sys.stderr)
        return paths, {}
    todo, skipped = [], {}
    for k, path in enumerate(paths):
        o_name = output_name(cfg, None, path)
        if os.path.exists(o_name):
            skipped[k] = ArchiveReport(path=path, out_path=o_name, skipped=True)
            if not cfg.quiet:
                print(f"Resume: {o_name} exists, skipping {path}")
        else:
            todo.append(path)
    return todo, skipped


def _merge_reports(n: int, skipped: dict[int, ArchiveReport],
                   done: list[ArchiveReport]) -> list[ArchiveReport]:
    """Reports in invocation order: skipped ones back at their original
    indices, processed ones filling the gaps in sequence."""
    it = iter(done)
    return [skipped[k] if k in skipped else next(it) for k in range(n)]


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
    if events.active():
        # job_submitted carries the shape bucket (NSUBxNCHANxNBIN; pol is
        # not a bucketing axis) and the config salt wherever work enters.
        from iterative_cleaner_tpu_torch.ingest import cas
        from iterative_cleaner_tpu_torch.obs.tracing import shape_bucket_label

        s = archive.data.shape
        shape_hint = [int(s[0]), int(s[2]), int(s[3])]
        events.emit("job_submitted", path=path, entry="cli",
                    replica_id="", job_id="", tenant="", idem_key="",
                    cache_salt=cas.cache_salt(cfg), shape=shape_hint,
                    bucket=shape_bucket_label(shape_hint))
    with profile_trace(cfg.trace_dir, device=device), \
            events.span("clean_archive", path=path, shape=list(archive.data.shape)):
        out: SurgicalOutput = SurgicalCleaner(cfg, device=device).clean(
            archive, progress=progress)
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
    report.quality = quality.quality_summary(out.cleaned.weights,
                                             termination=res.termination)
    if out.audit is not None:
        report.audit = out.audit
        if not out.audit.get("mask_identical", True):
            # A parity break is never silenced (-q gates chatter only).
            print(f"AUDIT DIVERGENCE {path}: {out.audit.get('n_mask_diffs')} mask "
                  f"bit(s) differ from the numpy oracle"
                  + (f"; repro bundle at {out.audit['bundle']}"
                     if out.audit.get("bundle") else ""), file=sys.stderr)
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


#: Fraction of host RAM the all-at-once batch loader may plausibly fill
#: before the driver switches to the streaming dispatcher by itself.  The
#: estimate is the batch's on-disk size — compressed NPZ underestimates the
#: decoded cubes, so the fraction is conservative.
STREAM_RAM_FRACTION = 0.25


def _host_ram_bytes() -> int:
    try:
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    except (ValueError, OSError):
        return 0


def _stream_threshold_bytes() -> int:
    """On-disk batch size above which --sharded_batch streams by default;
    0 disables the switch.  ICT_STREAM_THRESHOLD_BYTES overrides."""
    env = os.environ.get("ICT_STREAM_THRESHOLD_BYTES")
    if env is not None:
        try:
            return int(float(env))
        except ValueError:
            print(f"warning: ignoring unparseable ICT_STREAM_THRESHOLD_BYTES"
                  f"={env!r} (want a byte count); using the host-RAM default",
                  file=sys.stderr)
    return int(_host_ram_bytes() * STREAM_RAM_FRACTION)


def _auto_stream(paths: list[str], cfg: CleanConfig) -> bool:
    """Whether this batch takes the streaming route even without --stream:
    the all-at-once loader holds every decoded cube on the host while it
    buckets, which a directory above the threshold cannot afford (masks are
    identical either way; only emission order and host residency differ)."""
    if cfg.stream:
        return True
    threshold = _stream_threshold_bytes()
    if threshold <= 0:
        return False
    total = 0
    for p in paths:
        try:
            total += os.path.getsize(p)
        except OSError:
            continue  # missing files fail per-archive later, as always
    if total > threshold:
        if not cfg.quiet:
            print(f"note: batch on-disk size ({total / 1e9:.1f} GB) exceeds the "
                  f"host-memory threshold ({threshold / 1e9:.1f} GB); using the "
                  "streaming dispatcher (bounded host residency — pass --stream "
                  "to silence this note)", file=sys.stderr)
        return True
    return False


def run_sharded_batch(paths: list[str], cfg: CleanConfig, log_dir: str = ".",
                      all_paths: list[str] | None = None,
                      device="cuda") -> list[ArchiveReport]:
    """Same-shape archives cleaned together on one card (one batched
    dispatch per bucket, or per ``archives_per_dispatch`` archives of it).
    No residual archives (the batch does not carry them) and no mask
    history.  With streaming, each archive's outputs are emitted (and its
    host arrays released) as its dispatch returns, so host residency stays
    bounded by the read-ahead window; the all-at-once route emits after the
    whole batch."""
    from iterative_cleaner_tpu_torch.backends.torch_backend import resolve_device
    from iterative_cleaner_tpu_torch.models.surgical import apply_output_policy
    from iterative_cleaner_tpu_torch.parallel.batch import (
        clean_directory_batch,
        clean_directory_streaming,
    )
    from iterative_cleaner_tpu_torch.parallel.mesh import make_mesh

    if cfg.unload_res:
        print("warning: --unload_res is not supported with --sharded_batch; "
              "residuals will not be written", file=sys.stderr)
    if cfg.dump_masks:
        print("warning: --sharded_batch tracks no per-iteration mask history; "
              "--dump_masks will write the NPZ without the 'history' key",
              file=sys.stderr)
    mesh = make_mesh(devices=[resolve_device(device)])
    invocation = all_paths if all_paths is not None else paths
    reports: dict[int, ArchiveReport] = {}

    def emit_item(i, item) -> None:
        if item.error is None:
            try:
                cleaned = apply_output_policy(item.archive, item.weights, cfg)
                reports[i] = emit_outputs(
                    get_io(item.path), item.archive, item.path, cleaned,
                    item.test_results, item.loops, item.converged, item.rfi_frac,
                    cfg, log_dir, invocation)
                # Release the decoded archive and masks: this is what makes
                # the streaming route's host-memory bound real.
                item.archive = item.weights = item.test_results = None
                return
            except Exception as exc:  # noqa: BLE001 — isolate, report, continue
                item.error = str(exc)
        print(f"ERROR cleaning {item.path}: {item.error}", file=sys.stderr)
        reports[i] = ArchiveReport(path=item.path, out_path=None, error=item.error)

    with profile_trace(cfg.trace_dir, device=device):
        if _auto_stream(paths, cfg):
            items = clean_directory_streaming(paths, cfg, mesh=mesh, on_item=emit_item)
        else:
            items = clean_directory_batch(paths, cfg, mesh=mesh)
    for i, item in enumerate(items):
        if i not in reports:  # the all-at-once route, and failed loads when streaming
            emit_item(i, item)
    return [reports[i] for i in range(len(items))]


def run_follow(paths: list[str], cfg: CleanConfig, poll_s: float = 1.0,
               idle_timeout_s: float = 30.0, alert_iters: int = 2, log_dir: str = ".",
               sleep=None, device="cuda") -> list[ArchiveReport]:
    """--follow: tail each growing archive through the online subsystem
    (``online/follow.py``) on ``device``, one after another, with per-archive
    failure isolation — a dead stream must not kill its siblings.
    ``sleep`` is the tail loop's injectable wait (tests drive growth through
    it)."""
    from iterative_cleaner_tpu_torch.online.follow import follow_archive

    invocation = list(paths)
    reports = []
    for path in paths:
        try:
            reports.append(follow_archive(
                path, cfg, poll_s=poll_s, idle_timeout_s=idle_timeout_s,
                alert_iters=alert_iters, log_dir=log_dir, all_paths=invocation,
                sleep=sleep, device=device))
        except Exception as exc:  # noqa: BLE001 — isolate, report, continue
            reports.append(ArchiveReport(path=path, out_path=None, error=str(exc)))
            print(f"ERROR following {path}: {exc}", file=sys.stderr)
    return reports


def run_sweep(paths: list[str], cfg: CleanConfig, pairs: list[tuple[float, float]],
              device="cuda") -> list[ArchiveReport]:
    """--sweep: per archive, the whole threshold grid on ``device``
    (``models/sweep.py``), the table printed, ``<path>_sweep.npz`` saved.
    Exploratory: no cleaned archives, no clean.log."""
    from iterative_cleaner_tpu_torch.config import warn_zero_threshold
    from iterative_cleaner_tpu_torch.models.sweep import (
        format_table,
        save_sweep,
        sweep_thresholds,
    )
    from iterative_cleaner_tpu_torch.ops.preprocess import preprocess

    if any(c == 0 or s == 0 for c, s in pairs):
        # Sweep thresholds never pass through a CleanConfig, so the
        # degenerate-threshold check fires here.
        warn_zero_threshold()
    if cfg.backend != "torch":
        print("error: --sweep requires --backend=torch", file=sys.stderr)
        return [ArchiveReport(path=p, out_path=None, error="--sweep requires backend='torch'")
                for p in paths]
    reports = []
    for path in paths:
        try:
            D, w0 = preprocess(get_io(path).load(path))
            with profile_trace(cfg.trace_dir, device=device):
                points = sweep_thresholds(D, w0, cfg, pairs, device=device)
            print(f"Sweep {path} ({len(points)} threshold pairs):")
            print(format_table(points))
            out = f"{path}_sweep.npz"
            save_sweep(points, out)
            reports.append(ArchiveReport(path=path, out_path=out))
        except Exception as exc:  # noqa: BLE001 — isolate, report, continue
            reports.append(ArchiveReport(path=path, out_path=None, error=str(exc)))
            print(f"ERROR sweeping {path}: {exc}", file=sys.stderr)
    return reports


def run(paths: list[str], cfg: CleanConfig, log_dir: str = ".",
        device="cuda") -> list[ArchiveReport]:
    """Sequential batch with per-archive failure isolation and one-archive
    read-ahead: a loader thread decodes archive k+1 while archive k cleans.
    ``cfg.resume`` skips archives already cleaned; ``cfg.sharded_batch``
    hands the rest to :func:`run_sharded_batch`."""
    # clean.log records the full invocation even when --resume trims it.
    invocation = list(paths)
    n_total = len(paths)
    paths, skipped = split_resumable(paths, cfg)
    if cfg.sharded_batch:
        return _merge_reports(n_total, skipped, run_sharded_batch(
            paths, cfg, log_dir=log_dir, all_paths=invocation, device=device))

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
    return _merge_reports(n_total, skipped, reports)
