"""The plain reference against the port on small CPU inputs from the
benchmark's own generator: the same masks and loop counts, scores within the
drift limit; and the generator repeats itself from a seed."""

import json

import numpy as np
import pytest

from bench_port import compare, gen, harness
from bench_port.tests.conftest import CELLS, make_tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("ref"))


def entry_for(root, workload):
    spec = harness.load_spec(root)
    _cell, config, traffic = harness.find_cell(spec, workload, root)
    return harness.make_entry(config, traffic, "cpu", root)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [0, 42, 2**31 + 11])
def test_reference_equals_the_port(root, workload, seed):
    entry = entry_for(root, workload)
    inp = entry.make(entry.sources(seed)[0])
    got, want = entry.serve(inp), entry.reference(inp, "float64")
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert np.array_equal(g["weights"], w["weights"])
        assert (g["weights"] == 0).sum() > 2      # something was zapped
        assert g["loops"] == w["loops"]
    numbers = compare.compare_parts(got, want)
    assert numbers["score_drift"] < compare.LIMITS["score_drift"]


@pytest.mark.parametrize("kind", ["raw_archive", "preprocessed_cube"])
def test_generator_repeats_from_its_seed(kind):
    cfg = json.loads((harness.REPO / "bench_port/configs/lofar_hba.json").read_text())
    cfg.update(cfg["cpu_shape"])
    a, b, c = (getattr(gen, kind)(cfg, s, "cpu") for s in (7, 7, 8))
    for key in a:
        if isinstance(a[key], np.ndarray):
            assert np.array_equal(a[key], b[key])
    key = "data" if kind == "raw_archive" else "D"
    assert not np.array_equal(a[key], c[key])


def test_a_pool_gives_every_seed_the_same_archives_shuffled(root):
    """With a ``pool``, two seeds make the same bases in other orders, each
    archive's subints shuffled: other bytes, the same profiles."""
    entry = entry_for(root, "lofar.sweep")
    a, b = entry.sources(5), entry.sources(2**31 + 7)
    assert sorted(s for s, _ in a) == sorted(s for s, _ in b) == sorted(entry.traffic["pool"])
    assert a == entry.sources(5) and a != b
    base = gen.raw_archive(entry.config, a[0][0], "cpu")
    shuffled = entry.make(a[0])
    assert not np.array_equal(base["data"], shuffled["data"])
    rows = {r.tobytes(): i for i, r in enumerate(base["data"])}
    perm = [rows[r.tobytes()] for r in shuffled["data"]]
    assert sorted(perm) == list(range(len(perm)))
    assert np.array_equal(shuffled["weights"], base["weights"][perm])


def test_a_shuffle_leaves_the_cleaners_work_as_it_was(root):
    """The reference of a shuffled archive is the shuffled reference of its
    base: the same loop counts, the masks permuted with the subints."""
    entry = entry_for(root, "lofar.sweep")
    src = entry.sources(11)[0]
    base = entry.make((src[0], None))
    shuffled = entry.make(src)
    rows = {r.tobytes(): i for i, r in enumerate(base["data"])}
    perm = [rows[r.tobytes()] for r in shuffled["data"]]
    for w, s in zip(entry.reference(base, "float64"), entry.reference(shuffled, "float64")):
        assert w["loops"] == s["loops"]
        assert np.array_equal(s["weights"], w["weights"][perm])
