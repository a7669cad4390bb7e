"""One run of one cell: set-up, the measured window, the check.

Everything is found by name from ``BENCHMARK.json``: the cell names a
configuration (its ``file``) and a traffic mix
(``bench_port/traffic/<traffic>.json``), whose ``entry`` names the entry
point ``bench_port/entries/<entry>.py`` (a class ``Entry``, see
``entry_base.py``); each per-layer metric is read by
``bench_port/metrics/<name>.py``.  A run:

1. set-up: makes the traffic's distinct inputs on the device, from
   ``seed``, ``seed + 1``, ... or from its ``pool`` shuffled by ``seed``
   (``entry_base.Base.sources``), and serves the first once (the
   program's kernel libraries are built or loaded, its plans and allocator
   warmed); ``setup_s`` ends here;
2. with ``trace`` 0, the window: a closed loop that serves the inputs in
   turn, the next when the last returns, until the first completion at or
   after ``seconds``; with ``trace`` 1, the traffic's ``trace_inputs``
   inputs under ``torch.profiler``, read by the cell's per-layer metrics;
3. the check: every answer against the plain reference of its input, by
   ``compare.py`` and its limits, computed once the window has closed, the
   peak memory has been read and the program's device memory is released.

A traffic file's keys: ``entry``; ``inputs`` (distinct inputs a run
cycles through) and ``trace_inputs``; optional ``pool`` (the base seeds of
raw archives, as many as ``inputs``); optional ``clean`` (cleaning options
over the configuration's), ``rfi`` (injections over the configuration's),
``pairs`` (the sweep's thresholds) and ``reference_block`` (subints a block
of the reference).  Other keys document the mix.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from bench_port import compare, trace as tr

BENCH = "bench_port"
REPO = Path(__file__).resolve().parent.parent
#: Top-level modules that may not be loaded in a run (compared whole).
FORBIDDEN = ("jax", "jaxlib", "flax", "iterative_cleaner_tpu")


def load_spec(root: Path = REPO) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def find_cell(spec: dict, name: str, root: Path = REPO) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic) of the workload ``name``."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((Path(root) / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((Path(root) / BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, config, traffic


def metrics_of(spec: dict, name: str) -> tuple[list[dict], list[dict]]:
    """(end-to-end, per-layer) metric entries that the cell ``name`` reports."""
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return e2e, layer


def _load(kind: str, name: str, root: Path):
    path = Path(root) / BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: Path = REPO):
    """The ``read(ctx)`` function of ``bench_port/metrics/<name>.py``."""
    return _load("metrics", name, root).read


def entry_class(name: str, root: Path = REPO):
    """The class ``Entry`` of ``bench_port/entries/<name>.py``."""
    return _load("entries", name, root).Entry


def make_entry(config: dict, traffic: dict, device, root: Path = REPO):
    return entry_class(traffic["entry"], root)(config, traffic, device)


class Context:
    """What a per-layer reader reads: the trace, the launches one call of
    the cell's entry makes, and the entry itself (its cleaning options,
    shape and device)."""

    def __init__(self, trace: tr.Trace, entry) -> None:
        self.trace, self.entry = trace, entry
        self.kernels = entry.kernels()


END_TO_END = {
    "archives_per_s": lambda w: w["completed"] / w["window_s"],
    "archive_s_p90": lambda w: float(np.percentile(w["times"], 90)),
    "peak_device_GB": lambda w: w["peak_bytes"] / 1e9,
    "setup_s": lambda w: w["setup_s"],
}


def forbidden_modules() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def _power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def _same(a: list[dict], b: list[dict]) -> bool:
    return len(a) == len(b) and all(
        x["loops"] == y["loops"] and np.array_equal(x["weights"], y["weights"])
        and np.array_equal(np.asarray(x["scores"]), np.asarray(y["scores"]), equal_nan=True)
        for x, y in zip(a, b))


class Answers:
    """Every distinct answer per input: a repeat equal to one already kept
    is counted, not stored, so the check sees every answer that differs."""

    def __init__(self) -> None:
        self.by_input: dict[int, list[list[dict]]] = {}
        self.failed = 0
        self.errors: list[str] = []

    def keep(self, i: int, ans: list[dict]) -> None:
        ans = [{"weights": np.array(p["weights"], copy=True),
                "scores": None if p["scores"] is None else np.array(p["scores"], copy=True),
                "loops": int(p["loops"])} for p in ans]
        kept = self.by_input.setdefault(i, [])
        if not any(_same(k, ans) for k in kept):
            kept.append(ans)


def _serve(entry, inputs, k: int, answers: Answers) -> float:
    i = k % len(inputs)
    t0 = time.perf_counter()
    with torch.profiler.record_function(tr.INPUT_SPAN):
        try:
            ans = entry.serve(inputs[i])
        except Exception:  # noqa: BLE001 — a failed call is a missing answer
            ans = None
            answers.failed += 1
            answers.errors.append(traceback.format_exc(limit=4))
    dt = time.perf_counter() - t0
    if ans is not None:
        answers.keep(i, ans)
    return dt


def run(workload: str, seed: int, seconds: float, trace: bool, *, device="cuda",
        root: Path = REPO, t_start: float | None = None, spec: dict | None = None) -> dict:
    """One run; returns the result line as a dict (``checks`` last) and the
    lines for standard error under ``"_stderr"``."""
    t_start = time.time() if t_start is None else t_start
    spec = spec or load_spec(root)
    cell, config, traffic = find_cell(spec, workload, root)
    e2e, layer = metrics_of(spec, workload)
    entry = make_entry(config, traffic, device, root)
    cuda = torch.device(device).type == "cuda"
    power = _power_limit() if cuda else None

    inputs = [entry.make(src) for src in entry.sources(seed)]
    if cuda:
        # The program's own peak gauges start after the inputs were made.
        torch.cuda.reset_peak_memory_stats(device)
    warm = Answers()
    _serve(entry, inputs, 0, warm)
    if warm.failed:
        raise RuntimeError(f"the warm-up call failed:\n{warm.errors[0]}")
    del warm
    gc.collect()
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)

    answers = Answers()
    window = {"setup_s": time.time() - t_start, "times": []}
    metrics, device_info, breakdown = {}, {}, None
    if not trace:
        t0 = time.perf_counter()
        k = 0
        while True:
            window["times"].append(_serve(entry, inputs, k, answers))
            k += 1
            if time.perf_counter() - t0 >= seconds:
                break
        window["window_s"] = time.perf_counter() - t0
    else:
        with tr.profiler(device) as prof:
            for k in range(int(traffic.get("trace_inputs", len(inputs)))):
                window["times"].append(_serve(entry, inputs, k, answers))
        trace_obj = tr.Trace(tr.export(prof))
        del prof
        ctx = Context(trace_obj, entry)
        for m in layer:
            value = reader(m["name"], root)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info = {"busy_s": trace_obj.busy_s, "window_s": trace_obj.window_s}
        breakdown = trace_obj.breakdown()
        del trace_obj, ctx
    attempted = len(window["times"])
    window["completed"] = attempted - answers.failed
    window["peak_bytes"] = torch.cuda.max_memory_allocated(device) if cuda else 0
    if not trace:
        for m in e2e:
            metrics[m["name"]] = {"value": END_TO_END[m["name"]](window), "unit": m["unit"]}

    # The check, after the window, on memory the program no longer holds.
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    readings = []
    for i, kept in sorted(answers.by_input.items()):
        want = entry.reference(inputs[i], "float64")
        readings.extend(compare.compare_parts(got, want) for got in kept)
        del want
        if cuda:
            torch.cuda.empty_cache()
    numbers = compare.worst(readings, missing=answers.failed)
    correct, checks = compare.judge(numbers)

    out = {"correct": correct, "attempted": attempted, "failed": answers.failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if cuda else torch.device(device).type,
                      "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                      "count": 1, "memory_peak_bytes": int(window["peak_bytes"]),
                      **device_info, **({"power_limit": power} if power else {})}}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["run"] = {"window_s": window.get("window_s"), "check_s": time.perf_counter() - t_check,
                  "times": window["times"],
                  "loops": [sorted({p["loops"] for a in answers.by_input.get(i, []) for p in a})
                            for i in range(len(inputs))]}
    out["checks"] = checks
    out["_stderr"] = answers.errors[:3] + [
        f"check {k}: {v['value']!r} (limit {v['limit']!r})" for k, v in checks.items()]
    return out
