"""Tail a growing archive file: yield new subint blocks as they land.

A copy of ``iterative_cleaner_tpu/io/tail.py``.  Archive containers (.npz)
are not appendable, so an observatory-side writer "grows" an archive by
atomically rewriting it with more subints (the write-then-rename idiom of
``driver.atomic_save``).  The tail reader polls the file's (mtime, size)
signature, reloads when it changes, and yields only the subints beyond what
it already delivered; end-of-stream is either an explicit sentinel file
(``<path>.eos``, the writer's "observation over" marker) or
``idle_timeout_s`` with no growth.

A reload that fails or shrinks is treated as a torn mid-rewrite read (a
non-atomic writer) and retried on the next poll rather than raised — only
the load once the sentinel exists is allowed to fail loudly.  The NPZ
reader raises on a half-written file, which is what makes the retry work.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Iterator

from iterative_cleaner_tpu_torch.io.base import Archive, get_io


def eos_sentinel(path: str) -> str:
    return f"{path}.eos"


def _signature(path: str) -> tuple | None:
    try:
        st = os.stat(path)
        return (st.st_mtime_ns, st.st_size)
    except OSError:
        return None


def tail_blocks(
    path: str,
    poll_s: float = 1.0,
    idle_timeout_s: float = 30.0,
    sleep: Callable[[float], None] | None = None,
) -> Iterator[tuple[Archive, int, int]]:
    """Yield ``(archive, lo, hi)`` for each newly-appeared subint range; the
    archive is the current full on-disk content (the last yield's archive is
    therefore the completed cube).  ``sleep`` is injectable so tests drive
    the loop deterministically.  Raises TimeoutError if the file never
    yields a single readable archive before the idle timeout."""
    if sleep is None:
        sleep = time.sleep
    io = get_io(path)
    known = 0
    last_sig: tuple | None = None
    last_growth = time.monotonic()
    while True:
        eos = os.path.exists(eos_sentinel(path))
        sig = _signature(path)
        if sig is not None and sig != last_sig:
            try:
                archive = io.load(path)
            except Exception:  # noqa: BLE001 — torn mid-rewrite read
                archive = None
                if eos:
                    raise  # the writer said done; a broken file is final
            if archive is not None:
                last_sig = sig
                if archive.nsub > known:
                    yield archive, known, archive.nsub
                    known = archive.nsub
                    last_growth = time.monotonic()
        if eos:
            return
        if time.monotonic() - last_growth >= idle_timeout_s:
            if known == 0:
                raise TimeoutError(
                    f"no readable archive at {path!r} within "
                    f"{idle_timeout_s:.1f}s")
            return
        sleep(poll_s)
