"""Whole runs on the CPU at small shapes: lookups by name, a cell added by
files alone, the result line, the control and the planted faults."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from bench_port import compare, harness
from bench_port.control import control_readings
from bench_port.tests.conftest import REPO, make_tiny_root

CELLS = ["lofar.archives", "wideband.clean", "lofar.sweep"]
SEED = 2**31 + 3


def run(root, workload, trace=False, seconds=0.5):
    out = harness.run(workload, SEED, seconds, trace, device="cpu", root=root)
    out.pop("_stderr")
    return out


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_run_line(tiny_root, workload, trace):
    out = run(tiny_root, workload, trace)
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    e2e, layer = harness.metrics_of(harness.load_spec(tiny_root), workload)
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        # CPU runs have no device records: only host spans can be read.
        assert set(out["metrics"]) <= {m["name"] for m in layer}
    else:
        assert set(out["metrics"]) == {m["name"] for m in e2e}
        assert all(v["value"] > 0 for k, v in out["metrics"].items()
                   if k != "peak_device_GB")


#: A throwaway entry point: ``clean_cube`` on its fused route.
FUSED_ENTRY = """
import torch

from bench_port.entry_base import Base, sync


class Entry(Base):
    makes = "preprocessed_cube"

    def serve(self, inp):
        from iterative_cleaner_tpu_torch.core.cleaner import clean_cube

        res = clean_cube(inp["D"], inp["w0"], self.cfg.replace(fused=True), device=self.device)
        sync(self.device)
        return [{"weights": res.weights, "scores": res.test_results, "loops": res.loops}]

    def reference(self, inp, precision):
        D = torch.from_numpy(inp["D"]).to(self.device)
        return [self.reference_clean(D, inp["w0"], self.cfg, precision, D_host=inp["D"])]
"""


def test_cell_added_by_files_alone(tmp_path):
    """A configuration, two traffic mixes (one on an entry point of its own),
    and a per-layer metric that exist only as new files and entries are
    found by name and reported."""
    root = make_tiny_root(tmp_path)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "bench_port/configs/lofar_hba.json").read_text())
    cfg["nsub"] = 8
    (root / "bench_port/configs/lofar_tiny.json").write_text(json.dumps(cfg))
    (root / "bench_port/traffic/quiet.json").write_text(json.dumps(
        {"entry": "surgical", "inputs": 2, "trace_inputs": 2, "rfi": {"n_bad_subints": 0}}))
    (root / "bench_port/traffic/fused.json").write_text(json.dumps(
        {"entry": "fused_cube", "inputs": 2, "trace_inputs": 2}))
    (root / "bench_port/entries/fused_cube.py").write_text(FUSED_ENTRY)
    (root / "bench_port/metrics/inputs_traced.py").write_text(
        "def read(ctx):\n    return float(len(ctx.trace.inputs))\n")
    spec["configs"].append({"name": "lofar_tiny", "source": "https://example.org/x",
                            "file": "bench_port/configs/lofar_tiny.json",
                            "reduced": ["nsub"], "why": "throwaway"})
    new = ["tiny.quiet", "tiny.fused"]
    spec["workloads"] += [{"name": name, "config": "lofar_tiny", "traffic": traffic,
                           "chips": 1, "why": "throwaway"}
                          for name, traffic in zip(new, ("quiet", "fused"))]
    for m in spec["end_to_end"]:
        if "workloads" in m:
            m["workloads"] += new
    spec["per_layer"].append({"name": "inputs_traced", "unit": "inputs", "better": "higher",
                              "source": "program_span", "layer": "harness",
                              "moves": "archives_per_s", "workloads": new})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    for name in new:
        out = run(root, name, trace=True)
        assert out["correct"] is True, out["checks"]
        assert out["metrics"]["inputs_traced"]["value"] == 2.0
        out = run(root, name)
        assert out["correct"] is True and "archives_per_s" in out["metrics"]
    assert harness.entry_class("fused_cube", root).makes == "preprocessed_cube"


def test_a_missing_entry_is_named(tiny_root):
    with pytest.raises(FileNotFoundError, match="no_such_entry"):
        harness.entry_class("no_such_entry", tiny_root)


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(tiny_root, workload):
    rows = control_readings(workload, [5, 2**31 + 9, 77], "cpu", root=tiny_root)
    assert rows and not any(r["correct"] for r in rows)
    assert min(r["score_drift"] for r in rows) > 3 * compare.LIMITS["score_drift"]


def _flip(fn):
    """``fn`` with one weight of its answer altered where it is produced."""
    def altered(*args, **kw):
        out = fn(*args, **kw)
        w = out.weights if hasattr(out, "weights") else out[0].weights
        w[0, 0] = 1.0 if w[0, 0] == 0 else 0.0
        return out
    return altered


def _plant(monkeypatch, workload, fault):
    from iterative_cleaner_tpu_torch.backends import torch_backend
    from iterative_cleaner_tpu_torch.core import cleaner
    from iterative_cleaner_tpu_torch.models import surgical, sweep
    from iterative_cleaner_tpu_torch.ops import template
    from iterative_cleaner_tpu_torch.parallel import sharded

    if fault == "state_unchanged":
        if workload == "lofar.sweep":
            step = sharded.batched_clean_step
            monkeypatch.setattr(sharded, "batched_clean_step",
                                lambda D, w0, v, w_prev, *a, **k: (step(D, w0, v, w_prev, *a, **k)[0],
                                                                    w_prev))
        else:
            step = torch_backend.TorchCleaner.step
            monkeypatch.setattr(torch_backend.TorchCleaner, "step",
                                lambda self, w_prev: (step(self, w_prev)[0], w_prev))
    elif fault == "half_left_out":
        plain = template.build_template_plain

        def half(D, weights, init=None):
            keep = max(1, D.shape[0] // 2)
            return 2 * plain(D[:keep], weights[:keep], init)
        monkeypatch.setattr(template, "build_template_plain", half)
    elif fault == "answer_altered":
        if workload == "lofar.sweep":
            monkeypatch.setattr(sweep, "sweep_thresholds", _flip(sweep.sweep_thresholds))
        elif workload == "lofar.archives":
            monkeypatch.setattr(surgical, "clean_cube", _flip(cleaner.clean_cube))
        else:
            monkeypatch.setattr(cleaner, "clean_cube", _flip(cleaner.clean_cube))
    elif fault == "half_the_pairs":
        inner = sweep.sweep_thresholds
        monkeypatch.setattr(sweep, "sweep_thresholds",
                            lambda D, w0, cfg, pairs, **k: inner(D, w0, cfg,
                                                                 pairs[:len(pairs) // 2], **k))


FAULTS = [(w, f) for w in CELLS for f in ("state_unchanged", "half_left_out", "answer_altered")]
FAULTS.append(("lofar.sweep", "half_the_pairs"))


@pytest.mark.parametrize("workload, fault", FAULTS)
def test_planted_fault_is_not_correct(tiny_root, monkeypatch, workload, fault):
    _plant(monkeypatch, workload, fault)
    out = run(tiny_root, workload)
    assert out["correct"] is False, out["checks"]


def _cli(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "bench_port/run.py", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result(no_card):
    p = _cli(REPO, "--workload", "lofar.archives", "--seed", "1", "--seconds", "1",
             "--trace", "0")
    assert p.returncode != 0 and p.stdout == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _cli(tmp_path, "--workload", "lofar.archives", "--seed", "1", "--seconds", "1",
             "--trace", "0")
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(card, workload):
    for trace in ("0", "1"):
        p = _cli(REPO, "--workload", workload, "--seed", str(SEED), "--seconds", "3",
                 "--trace", trace)
        assert p.returncode == 0, p.stderr[-3000:]
        line = json.loads(p.stdout.strip().splitlines()[-1])
        assert line["correct"] is True and line["device"]["platform"] == "gpu"
