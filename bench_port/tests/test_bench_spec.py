"""BENCHMARK.json against the benchmark's contract: names, units, keys, files;
each configuration file's ``cpu_shape``, the small shape at which these
tests run it (nothing in a run reads the key); and no test module naming
every configuration or every cell by hand, so that a configuration and its
cells join the tests by data files and entries in BENCHMARK.json alone."""

import ast
import json
import re
from pathlib import Path

import pytest

from bench_port import harness

REPO = Path(__file__).resolve().parents[2]
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench_port"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(SPEC["command"]) <= 32
    assert len(json.dumps(SPEC)) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_just_the_keys(section):
    for e in SPEC[section]:
        extra = set(e) - KEYS[section] - ({"workloads"} if section in ("end_to_end", "per_layer")
                                          else set())
        assert not extra and KEYS[section] <= set(e), (section, e["name"], extra)


@pytest.mark.parametrize("section", sorted(KEYS))
def test_names_and_units_use_the_allowed_characters(section):
    names = [e["name"] for e in SPEC[section]]
    assert len(names) == len(set(names))
    for e in SPEC[section]:
        assert NAME.match(e["name"]), e["name"]
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key]), e[key]
        for key in e.get("reduced", []):
            assert NAME.match(key), key
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def test_metrics_and_cells_are_consistent():
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", [])) <= cells
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        assert (REPO / "bench_port" / "metrics" / f"{m['name']}.py").is_file()
    for w in SPEC["workloads"]:
        e, layer = harness.metrics_of(SPEC, w["name"])
        names = {m["name"] for m in e}
        assert "setup_s" in names and len(names) >= 2 and layer, w["name"]
        assert w["chips"] in (1, 4)


def test_configs_and_traffic_files():
    used = {w["config"] for w in SPEC["workloads"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("bench_port/")
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert {"source", "assumed", "reduced"} <= set(cfg)
    for w in SPEC["workloads"]:
        _cell, _config, traffic = harness.find_cell(SPEC, w["name"])
        assert (REPO / "bench_port" / "entries" / f"{traffic['entry']}.py").is_file()


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_configuration_carries_its_cpu_shape(config):
    cfg = json.loads((REPO / config["file"]).read_text())
    shape = cfg["cpu_shape"]
    assert set(shape) == {"nsub", "nchan", "nbin"}
    for key, size in shape.items():
        assert type(size) is int and 0 < size <= cfg[key], (key, size, cfg[key])


def literal_strings(path: Path):
    """The strings of each list, tuple and set literal of ``path``, and the
    keys of each dict literal, one set a literal."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Dict):
            items = node.keys
        elif isinstance(node, (ast.List, ast.Tuple, ast.Set)):
            items = node.elts
        else:
            continue
        yield {e.value for e in items if isinstance(e, ast.Constant) and isinstance(e.value, str)}


@pytest.mark.parametrize("section", ["configs", "workloads"])
@pytest.mark.parametrize("path", sorted((REPO / "bench_port" / "tests").glob("*.py")),
                         ids=lambda p: p.name)
def test_no_test_names_every_entry_by_hand(path, section):
    """A list or dict of every configuration or every cell is taken from
    BENCHMARK.json; a test of one cell's own feature may name that cell."""
    names = {e["name"] for e in SPEC[section]}
    if len(names) > 1:
        assert not any(names <= found for found in literal_strings(path))
