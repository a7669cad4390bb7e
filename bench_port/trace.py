"""A ``torch.profiler`` capture of part of the window, read back as events.

The capture records the host (the harness's spans, the program's
``record_function`` spans and, with the Python tracer, every Python
function call) and the card through CUPTI (kernels, copies, memsets).  It is
written as a Chrome trace into a temporary directory under ``TMPDIR``, read
back and deleted.  Times are in seconds, on the one clock the trace aligns
host and device events to.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field

#: The harness's span around each input it submits.
INPUT_SPAN = "bench.input"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PACKAGE = "iterative_cleaner_tpu_torch/"


@dataclass
class Event:
    cat: str
    name: str
    start: float
    dur: float
    tid: object = None
    args: dict = field(default_factory=dict)

    @property
    def end(self) -> float:
        return self.start + self.dur


def profiler(device):
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts, with_stack=True)


def export(prof) -> list[Event]:
    """The capture's events, through a Chrome trace file that is deleted."""
    with tempfile.TemporaryDirectory(prefix="bench_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f)
    out = []
    for e in raw.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        out.append(Event(str(e.get("cat", "")), str(e.get("name", "")),
                         float(e["ts"]) * 1e-6, float(e["dur"]) * 1e-6,
                         e.get("tid"), e.get("args") or {}))
    return out


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


class Trace:
    """The events of one capture and the window they are read over: from
    the start of the first input span to the end of the last."""

    def __init__(self, events: list[Event]) -> None:
        self.events = events
        spans = [e for e in events if e.cat == "user_annotation" and e.name == INPUT_SPAN]
        if not spans:
            raise ValueError(f"the capture holds no {INPUT_SPAN!r} span")
        self.inputs = sorted(spans, key=lambda e: e.start)
        self.main_tid = self.inputs[0].tid
        self.t0 = self.inputs[0].start
        self.t1 = max(e.end for e in spans)
        self.device = [e for e in events if e.cat in DEVICE_CATS
                       and e.end > self.t0 and e.start < self.t1]

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self):
        return _union((max(e.start, self.t0), min(e.end, self.t1)) for e in self.device)

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def kernels(self, name: str) -> list[Event]:
        return [e for e in self.device if e.cat == "kernel" and name in e.name]

    def copies(self, kind: str) -> list[Event]:
        return [e for e in self.device if e.cat == "gpu_memcpy" and kind in e.name]

    def python_calls(self, file: str, func: str) -> list[Event]:
        """The Python tracer's calls of ``func`` defined in ``file`` (a path
        ending), within the window."""
        return [e for e in self.events if e.cat == "python_function"
                and e.start >= self.t0 and e.end <= self.t1
                and f"{file}(" in e.name and e.name.endswith(f": {func}")]

    def host_label(self, t: float) -> str:
        """What the main thread was doing at ``t``: the innermost of the
        program's Python functions running then, within the innermost
        span."""
        def innermost(cands):
            cands = [e for e in cands if e.start <= t <= e.end]
            return min(cands, key=lambda e: e.dur) if cands else None

        func = innermost(e for e in self.events if e.cat == "python_function"
                         and e.tid == self.main_tid and PACKAGE in e.name)
        span = innermost(e for e in self.events if e.cat == "user_annotation")
        where = span.name if span is not None else "host"
        if func is None:
            return where
        return f"{func.name.split(PACKAGE, 1)[-1]} in {where}"

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict[str, float] = {}
        for e in self.device:
            key = e.name[:160]
            by_name[key] = by_name.get(key, 0.0) + e.dur
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy_intervals()
        edges = [self.t0] + [x for a, b in busy for x in (a, b)] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[self.host_label((a + b) / 2), b - a] for a, b in gaps]}
