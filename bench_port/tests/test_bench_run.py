"""Whole runs on the CPU at small shapes: lookups by name, a cell added by
files alone, and for every cell of BENCHMARK.json the result line, the
control and the faults planted underneath its entry point."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from bench_port import compare, harness
from bench_port.control import control_readings
from bench_port.tests.conftest import CELLS, REPO, make_tiny_root

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


def test_cell_added_by_files_alone(tmp_path, monkeypatch):
    """A configuration (the LOFAR archive in full polarisation, Coherence),
    a traffic mix on an entry point of its own, their cells and a per-layer
    metric, added to a copy of the benchmark as new files and entries in its
    BENCHMARK.json before the small tree is made from it: each cell is found
    by name, reported and correct, and the new entry's answer, altered, is
    not."""
    src = tmp_path / "src"
    src.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", src / "BENCHMARK.json")
    shutil.copytree(REPO / "bench_port", src / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((src / "BENCHMARK.json").read_text())
    cfg = json.loads((src / "bench_port/configs/lofar_hba.json").read_text())
    cfg.update(name="lofar_fullpol", npol=4, state="Coherence",
               cpu_shape={"nsub": 8, "nchan": 32, "nbin": 64})
    (src / "bench_port/configs/lofar_fullpol.json").write_text(json.dumps(cfg))
    (src / "bench_port/traffic/fused.json").write_text(json.dumps(
        {"entry": "fused_cube", "inputs": 2, "trace_inputs": 2}))
    (src / "bench_port/entries/fused_cube.py").write_text(FUSED_ENTRY)
    (src / "bench_port/metrics/inputs_traced.py").write_text(
        "def read(ctx):\n    return float(len(ctx.trace.inputs))\n")
    spec["configs"].append({"name": "lofar_fullpol", "source": "https://example.org/x",
                            "file": "bench_port/configs/lofar_fullpol.json",
                            "reduced": [], "why": "throwaway"})
    new = {"fullpol.archives": "archives", "fullpol.fused": "fused"}
    spec["workloads"] += [{"name": name, "config": "lofar_fullpol", "traffic": traffic,
                           "chips": 1, "why": "throwaway"} for name, traffic in new.items()]
    for m in spec["end_to_end"]:
        if "workloads" in m:
            m["workloads"] += list(new)
    spec["per_layer"].append({"name": "inputs_traced", "unit": "inputs", "better": "higher",
                              "source": "program_span", "layer": "harness",
                              "moves": "archives_per_s", "workloads": list(new)})
    (src / "BENCHMARK.json").write_text(json.dumps(spec))

    root = make_tiny_root(tmp_path / "root", src=src)
    for name, traffic in new.items():
        mix = json.loads((root / "bench_port/traffic" / f"{traffic}.json").read_text())
        out = run(root, name, trace=True)
        assert out["correct"] is True, out["checks"]
        assert out["metrics"]["inputs_traced"]["value"] == mix["trace_inputs"]
        out = run(root, name)
        assert out["correct"] is True and "archives_per_s" in out["metrics"], out["checks"]
    assert harness.entry_class("fused_cube", root).makes == "preprocessed_cube"
    _plant(monkeypatch, "fused_cube", "answer_altered")
    assert run(root, "fullpol.fused")["correct"] is False


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


def _served_altered(monkeypatch):
    """Every entry the harness makes serves its answer with the first
    part's first weight altered: the fault of an entry point whose own
    calls into the program this file does not know."""
    make = harness.make_entry

    def made(*args, **kw):
        entry = make(*args, **kw)
        serve = entry.serve

        def altered(inp):
            out = serve(inp)
            w = np.array(out[0]["weights"], copy=True)
            w.flat[0] = 1.0 if w.flat[0] == 0 else 0.0
            out[0]["weights"] = w
            return out
        entry.serve = altered
        return entry
    monkeypatch.setattr(harness, "make_entry", made)


def _plant(monkeypatch, entry, fault):
    """Plant ``fault`` underneath the cells whose traffic names ``entry``."""
    from iterative_cleaner_tpu_torch.backends import torch_backend
    from iterative_cleaner_tpu_torch.core import cleaner
    from iterative_cleaner_tpu_torch.models import surgical, sweep
    from iterative_cleaner_tpu_torch.ops import template
    from iterative_cleaner_tpu_torch.parallel import sharded

    if fault == "state_unchanged":
        if entry == "sweep":
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
        if entry == "sweep":
            monkeypatch.setattr(sweep, "sweep_thresholds", _flip(sweep.sweep_thresholds))
        elif entry == "surgical":
            monkeypatch.setattr(surgical, "clean_cube", _flip(cleaner.clean_cube))
        elif entry == "clean_cube":
            monkeypatch.setattr(cleaner, "clean_cube", _flip(cleaner.clean_cube))
        else:
            _served_altered(monkeypatch)
    elif fault == "half_the_pairs":
        inner = sweep.sweep_thresholds
        monkeypatch.setattr(sweep, "sweep_thresholds",
                            lambda D, w0, cfg, pairs, **k: inner(D, w0, cfg,
                                                                 pairs[:len(pairs) // 2], **k))


#: The faults planted in the program underneath each entry point's calls;
#: a cell on any other entry gets ``answer_altered`` on the answer it serves.
PLANTED = {entry: ("state_unchanged", "half_left_out", "answer_altered")
           for entry in ("surgical", "clean_cube", "sweep")}
PLANTED["sweep"] += ("half_the_pairs",)


def _entry_of(workload):
    return harness.find_cell(harness.load_spec(), workload)[2]["entry"]


FAULTS = [(w, f) for w in CELLS for f in PLANTED.get(_entry_of(w), ("answer_altered",))]


@pytest.mark.parametrize("workload, fault", FAULTS)
def test_planted_fault_is_not_correct(tiny_root, monkeypatch, workload, fault):
    _plant(monkeypatch, _entry_of(workload), fault)
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
