"""Killable probing of CUDA's first initialisation, and its watchdog.

The port of ``iterative_cleaner_tpu/utils/device_probe.py``.  A card whose
driver is wedged can make the first in-process CUDA call
(``torch.cuda.init()``, or the first tensor moved to the card) block with
no exception and no timeout.  Two tools, as in the JAX package:

- :func:`ensure_responsive_backend` is the *prevention*: it probes
  ``import torch; torch.cuda.init()`` in a subprocess that can be killed,
  so a hang becomes a timeout the caller can act on;
- :func:`init_watchdog` is the *diagnosis* for every path that still
  reaches the first initialisation in-process: after ``ICT_INIT_TIMEOUT_S``
  (default 120 s) without CUDA becoming live it prints one structured
  warning (JSON on stderr), adds a flight-recorder event and counts
  ``backend_init_watchdog_fired``.

Liveness is ``torch.cuda.is_initialized()``.  Unlike the JAX package, the
port never demotes itself to the CPU: its entry points run where the
caller asked, so a probe that hangs is reported, not worked around.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import threading
import time

#: Default seconds before the watchdog speaks up (``ICT_INIT_TIMEOUT_S``
#: overrides; <= 0 disables).
DEFAULT_INIT_TIMEOUT_S = 120.0

PROBE_CODE = "import torch; torch.cuda.init()"


def _backend_liveness() -> str:
    """"live" once CUDA is initialised in this process, else "not_live".
    Reads ``sys.modules`` instead of importing: a process that never
    imported torch cannot have CUDA up, and the check must not import (it
    runs on the watchdog's thread)."""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        return "live"
    return "not_live"


def probe_default_backend(timeout_s: float) -> str:
    """Probe CUDA's first initialisation in a killable subprocess: "ok",
    "error" (a fast failure — the real call surfaces the message
    in-process), or "hang" (killed at the timeout)."""
    try:
        out = subprocess.run([sys.executable, "-c", PROBE_CODE],
                             capture_output=True, timeout=timeout_s)
        return "ok" if out.returncode == 0 else "error"
    except subprocess.TimeoutExpired:
        return "hang"


def ensure_responsive_backend(timeout_s: float | None = None) -> str:
    """Probe before the first in-process CUDA call.  Returns "skipped"
    (``ICT_NO_DEVICE_PROBE=1``, a timeout <= 0, or CUDA already live),
    "ok", "error", or "hang" — the probe hung through two windows (a cold
    first initialisation may legitimately be slow once); then a warning
    says that the next CUDA call may hang."""
    if timeout_s is None:
        timeout_s = float(os.environ.get("ICT_DEVICE_PROBE_S", 120))
    if (os.environ.get("ICT_NO_DEVICE_PROBE") == "1" or timeout_s <= 0
            or _backend_liveness() == "live"):
        return "skipped"
    for _ in range(2):
        verdict = probe_default_backend(timeout_s)
        if verdict != "hang":
            return verdict
    print(f"warning: CUDA initialisation hung through two {timeout_s:.0f}s "
          "probes (a wedged driver?); the next CUDA call in this process may "
          "hang too — pass --device cpu to run on the CPU", file=sys.stderr)
    return "hang"


@contextlib.contextmanager
def init_watchdog(label: str = "cuda init", timeout_s: float | None = None):
    """Diagnose — don't prevent — a first CUDA initialisation that hangs.

    A daemon thread watches the wrapped block: if CUDA is still not live
    after ``timeout_s`` (``ICT_INIT_TIMEOUT_S``, default 120), it prints ONE
    structured warning (JSON on stderr), drops a flight-recorder event and
    counts ``backend_init_watchdog_fired``.  It stays silent once CUDA is
    up (so wrapping a long clean is safe — liveness, not wall-clock, is the
    trigger); leaving the block retires the thread."""
    if timeout_s is None:
        try:
            timeout_s = float(os.environ.get("ICT_INIT_TIMEOUT_S",
                                             DEFAULT_INIT_TIMEOUT_S))
        except ValueError:
            timeout_s = DEFAULT_INIT_TIMEOUT_S
    if timeout_s <= 0 or _backend_liveness() == "live":
        yield
        return
    done = threading.Event()

    def _watch() -> None:
        deadline = time.monotonic() + timeout_s
        while not done.wait(min(timeout_s / 10, 1.0)):
            if _backend_liveness() == "live":
                return
            if time.monotonic() >= deadline:
                break
        else:
            return
        if done.is_set() or _backend_liveness() == "live":
            return
        warning = {
            "event": "backend_init_watchdog",
            "label": label,
            "timeout_s": timeout_s,
            "hint": "the first CUDA call has been blocking longer than "
                    "ICT_INIT_TIMEOUT_S — a wedged driver hangs the first "
                    "initialisation process-wide; pass --device cpu to run "
                    "on the CPU",
        }
        print(f"warning: {json.dumps(warning)}", file=sys.stderr)
        try:
            from iterative_cleaner_tpu_torch.obs import flight, tracing

            flight.note("backend_init_watchdog", label=label,
                        timeout_s=timeout_s)
            tracing.count("backend_init_watchdog_fired")
        except Exception:  # noqa: BLE001 — the stderr line already landed
            pass

    th = threading.Thread(target=_watch, daemon=True,
                          name="ict-init-watchdog")
    th.start()
    try:
        yield
    finally:
        done.set()
