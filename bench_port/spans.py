"""The program's own spans in a capture, for the per-layer readers.

The port times each layer boundary of a clean in ``obs/tracing.phase``,
which also opens a ``torch.profiler.record_function`` span of the phase's
name (``clean_preprocess``, ``clean_upload``, ``clean_loop``, ...).  The
capture records the main thread's spans only, so a span of the warm-up
thread (``clean_warmup``) is never read here.  A program that lacks a span
leaves its readers nothing to read: they return None.
"""

from __future__ import annotations


def spans(trace, name: str) -> list:
    """The main thread's ``name`` spans within the traced window."""
    return [e for e in trace.events if e.cat == "user_annotation" and e.name == name
            and e.tid == trace.main_tid and e.start >= trace.t0 and e.end <= trace.t1]


def mean_per_input(trace, name: str) -> float | None:
    """The seconds of the ``name`` spans over the window's inputs (its
    ``bench.input`` spans), or None where the window holds none."""
    found = spans(trace, name)
    if not found:
        return None
    return sum(e.dur for e in found) / len(trace.inputs)


def busy_within(trace, start: float, end: float) -> float:
    """Seconds of [start, end] in which a kernel, copy or memset ran."""
    return sum(max(0.0, min(b, end) - max(a, start)) for a, b in trace.busy_intervals())
