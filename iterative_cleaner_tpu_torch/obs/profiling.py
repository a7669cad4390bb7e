"""On-demand ``torch.profiler`` captures.

The port of ``iterative_cleaner_tpu/obs/profiling.py`` (which drives
``jax.profiler``).  Two shapes of capture, with the JAX package's
semantics:

- :func:`profile_trace` — the CLI's ``--trace DIR`` (``config.trace_dir``):
  one run wrapped in one capture;
- :func:`start` / :func:`stop` / :func:`maybe_capture` — a *bounded*
  capture around whatever runs now, stopped by :func:`stop` or at its
  deadline (``duration_s``, clamped to :func:`max_capture_s`,
  ``ICT_PROFILE_MAX_S``, default 60 s); :func:`list_profiles` lists the
  artifact directories.

Each capture records the host (CPU) activity and, when the device is the
card, the CUDA activity (kernels and copies, through CUPTI), and writes a
Chrome trace JSON, ``<host>_<pid>.<unix ns>.pt.trace.json``, into its
directory (open it in Perfetto or ``chrome://tracing``).  The kernel
launched through ctypes appears twice: as the host span
``fused_fit_moments`` (``ops/fused_kernels.py`` wraps its launch in a
``record_function``) and as the device kernel ``fused_fit_moments_kernel``.

``torch.profiler`` is process-global, like the TSL profiler, so one lock
serialises every capture in the process: a second capture while one is
active is refused (RuntimeError), and :func:`maybe_capture` skips rather
than fail the work it wraps.  A profiler must be stopped on the thread
that started it, so a bounded capture runs on a thread of its own, which
starts the profiler, waits for :func:`stop` or the deadline, stops it and
writes the trace; it records every thread's host activity where this
torch offers that (``profile_all_threads``), and the device activity of
the whole process in any case.  :func:`profile_trace` runs on the caller's
thread.
"""

from __future__ import annotations

import contextlib
import os
import socket
import threading
import time

from iterative_cleaner_tpu_torch.obs import flight

DEFAULT_MAX_CAPTURE_S = 60.0

#: Seconds :func:`stop` waits for a capture's thread to stop the profiler
#: and write its trace.
STOP_WAIT_S = 120.0

TRACE_SUFFIX = ".pt.trace.json"

_lock = threading.Lock()          # held only to mutate _active
_active: dict | None = None       # {"dir", "started_s", "until_s", "capture"}  # guarded by _lock


def max_capture_s() -> float:
    try:
        v = float(os.environ.get("ICT_PROFILE_MAX_S", DEFAULT_MAX_CAPTURE_S))
    except ValueError:
        return DEFAULT_MAX_CAPTURE_S
    return v if v > 0 else DEFAULT_MAX_CAPTURE_S


def active() -> dict | None:
    """The in-flight capture (dir / started_s / until_s), or None."""
    with _lock:
        if _active is None:
            return None
        return {k: _active[k] for k in ("dir", "started_s", "until_s")}


def _profiler(device, all_threads: bool):
    """A ``torch.profiler.profile`` of the host, plus CUDA on the card."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda" and torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    kw = {}
    if all_threads:
        try:
            kw["experimental_config"] = torch.profiler._ExperimentalConfig(
                profile_all_threads=True)
        except (AttributeError, TypeError):
            pass    # this torch records the starting thread's host ops only
    return torch.profiler.profile(activities=acts, **kw)


def _export(prof, out_dir: str) -> str:
    path = os.path.join(out_dir, f"{socket.gethostname()}_{os.getpid()}."
                                 f"{time.time_ns()}{TRACE_SUFFIX}")
    prof.export_chrome_trace(path)
    return path


def _claim(out_dir: str, until_s: float | None, capture) -> None:
    """Make this capture the process's one active capture (caller holds
    ``_lock``); RuntimeError when another is running."""
    global _active
    if _active is not None:
        raise RuntimeError(
            f"a profiler capture is already running ({_active['dir']}); "
            "stop it or wait for its deadline")
    _active = {"dir": out_dir, "started_s": time.time(), "until_s": until_s,
               "capture": capture}


def _release(capture) -> bool:
    """Clear the active capture if it is ``capture``; True when it was."""
    global _active
    with _lock:
        if _active is not None and _active["capture"] is capture:
            _active = None
            return True
        return False


class _Capture(threading.Thread):
    """One bounded capture on its own thread: start, wait for the stop
    request or the deadline, stop, write the trace."""

    def __init__(self, out_dir: str, duration_s: float, device) -> None:
        super().__init__(daemon=True, name="ict-profile")
        self.out_dir = out_dir
        self.duration_s = duration_s
        self.device = device
        self.started = threading.Event()
        self.stop_requested = threading.Event()
        self.done = threading.Event()
        self.error: BaseException | None = None
        self.path: str | None = None

    def run(self) -> None:
        import torch

        # On the card this thread makes the CUDA context current and drains
        # the queue before and after the profiler starts, so the capture
        # begins with the device idle and recording.
        sync = (torch.device(self.device).type == "cuda"
                and torch.cuda.is_initialized())
        try:
            prof = _profiler(self.device, all_threads=True)
            if sync:
                torch.cuda.synchronize(self.device)
            prof.start()
            if sync:
                torch.cuda.synchronize(self.device)
        except BaseException as exc:  # noqa: BLE001 — handed to start()
            self.error = exc
            self.started.set()
            self.done.set()
            return
        self.started.set()
        self.stop_requested.wait(self.duration_s)
        try:
            prof.stop()
            self.path = _export(prof, self.out_dir)
        except Exception as exc:  # noqa: BLE001 — reported by stop()
            self.error = exc
        finally:
            self.done.set()
        if _release(self):   # the deadline ended it, not stop()
            flight.note("profile_stop", dir=self.out_dir,
                        duration_s=round(self.duration_s, 3), deadline=True)


def start(root: str, duration_s: float = 5.0, tag: str = "capture",
          device="cuda") -> dict:
    """Begin a bounded capture into a fresh directory under ``root``; it
    ends after ``duration_s`` (clamped to :func:`max_capture_s`) unless
    :func:`stop` is called first.  Raises RuntimeError when a capture is
    already running — the profiler is process-global."""
    global _active
    duration_s = min(max(float(duration_s), 0.1), max_capture_s())
    out_dir = os.path.join(root, f"{int(time.time() * 1000):013d}-{tag}")
    with _lock:
        cap = _Capture(out_dir, duration_s, device)
        _claim(out_dir, time.time() + duration_s, cap)
        try:
            os.makedirs(out_dir, exist_ok=True)
            cap.start()
            cap.started.wait()
            if cap.error is not None:
                raise cap.error
        except BaseException:
            _active = None
            raise
    flight.note("profile_start", dir=out_dir, duration_s=duration_s)
    return {"dir": out_dir, "duration_s": duration_s}


def stop(expected_dir: str | None = None) -> dict | None:
    """End the running bounded capture and wait for its trace; returns its
    record ({"dir", "duration_s", "trace"}, or "error") or None when idle.

    ``expected_dir`` makes the stop an ownership-checked one: a caller
    whose capture may already have ended at its deadline passes the dir it
    started, and a mismatch no-ops — a late stop never truncates a capture
    someone else started meanwhile."""
    global _active
    with _lock:
        if _active is None or not isinstance(_active["capture"], _Capture):
            return None
        if expected_dir is not None and _active["dir"] != expected_dir:
            return None
        rec = _active
        _active = None
    cap = rec["capture"]
    cap.stop_requested.set()
    cap.done.wait(STOP_WAIT_S)
    duration = round(time.time() - rec["started_s"], 3)
    if cap.error is not None or not cap.done.is_set():
        err = repr(cap.error) if cap.error is not None else "the capture did not stop"
        flight.note("profile_stop_failed", dir=rec["dir"], error=err)
        return {"dir": rec["dir"], "error": err}
    flight.note("profile_stop", dir=rec["dir"], duration_s=duration)
    return {"dir": rec["dir"], "duration_s": duration, "trace": cap.path}


@contextlib.contextmanager
def maybe_capture(root: str, tag: str, want: bool = True, device="cuda"):
    """Per-run capture around a block: yields the artifact directory, or
    None when not wanted / the profiler is busy (skipped, never queued)."""
    if not want:
        yield None
        return
    try:
        rec = start(root, duration_s=max_capture_s(), tag=tag, device=device)
    except RuntimeError:
        flight.note("profile_skipped_busy", tag=tag)
        yield None
        return
    except Exception as exc:  # noqa: BLE001 — profiling is best-effort
        flight.note("profile_start_failed", tag=tag, error=repr(exc))
        yield None
        return
    try:
        yield rec["dir"]
    finally:
        stop(expected_dir=rec["dir"])


def list_profiles(root: str) -> list[dict]:
    """Artifact directories under ``root`` (newest first): name, total
    bytes, file count, mtime."""
    out = []
    try:
        names = sorted(os.listdir(root), reverse=True)
    except OSError:
        return out
    for name in names:
        path = os.path.join(root, name)
        if not os.path.isdir(path):
            continue
        nbytes = nfiles = 0
        mtime = 0.0
        for dirpath, _dirs, files in os.walk(path):
            for f in files:
                try:
                    st = os.stat(os.path.join(dirpath, f))
                except OSError:
                    continue
                nbytes += st.st_size
                nfiles += 1
                mtime = max(mtime, st.st_mtime)
        out.append({"name": name, "bytes": nbytes, "files": nfiles,
                    "mtime": round(mtime, 3)})
    return out


@contextlib.contextmanager
def profile_trace(trace_dir: str | None, device="cuda"):
    """The one-shot capture (config.trace_dir / CLI ``--trace``): a
    ``torch.profiler`` capture of the block on the caller's thread when
    ``trace_dir`` is set, its Chrome trace written into ``trace_dir``;
    no-op otherwise.  Refused (RuntimeError) while another capture runs."""
    if not trace_dir:
        yield
        return
    prof = _profiler(device, all_threads=False)
    with _lock:
        _claim(trace_dir, None, prof)
    try:
        os.makedirs(trace_dir, exist_ok=True)
        prof.start()
        try:
            yield
        finally:
            prof.stop()
            path = _export(prof, trace_dir)
            flight.note("profile_trace", dir=trace_dir, trace=path)
    finally:
        _release(prof)
