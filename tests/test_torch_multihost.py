"""The port's multi-process directory split against the JAX package's.

``parallel/multihost.partition_paths`` and ``process_topology`` case for
case against ``iterative_cleaner_tpu/parallel/multihost.py`` from one
table; ``driver.run``'s split (torch backend only; clean.log keeps the whole
invocation; ``--report`` suffixed per process) with a faked topology; the
ranks' entry ``parallel/mesh.initialize_distributed`` refusing what it
must; the subint extent of ``parallel/autoshard.single_archive_mesh``
against the JAX package's mesh; and a two-process CLI run (``gloo`` on
``cpu``) over 3 archives, as ``tests/test_multihost_resume.py`` runs the
JAX CLI: disjoint round-robin slices, ``report.json.p0`` and
``report.json.p1`` and no ``report.json``, outputs equal to a one-process
run's.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import pytest
import torch

from iterative_cleaner_tpu.parallel.autoshard import single_archive_mesh as jax_single_mesh
from iterative_cleaner_tpu.parallel.multihost import partition_paths as jax_partition
from iterative_cleaner_tpu.parallel.multihost import process_topology as jax_topology
from iterative_cleaner_tpu_torch import cli, driver
from iterative_cleaner_tpu_torch.config import CleanConfig
from iterative_cleaner_tpu_torch.io.npz import NpzIO
from iterative_cleaner_tpu_torch.io.synthetic import make_archive
from iterative_cleaner_tpu_torch.parallel import autoshard, multihost
from iterative_cleaner_tpu_torch.parallel.mesh import initialize_distributed, subint_bounds
from test_torch_ranks import run_ranks

SEVEN = [f"p{i}" for i in range(7)]

#: (paths, process_index, process_count, the slice or the error).
PARTITION_CASES = [
    (["a", "b", "c"], None, None, ["a", "b", "c"]),          # (0, 1) topology
    (SEVEN, 0, 3, ["p0", "p3", "p6"]),
    (SEVEN, 1, 3, ["p1", "p4"]),
    (SEVEN, 2, 3, ["p2", "p5"]),
    (["a", "b", "c"], 0, 2, ["a", "c"]),
    (["a", "b", "c"], 1, 2, ["b"]),
    ([], 0, 2, []),
    (["a"], 3, 3, ValueError),
    (["a"], -1, 2, ValueError),
    (["a"], 0, 0, ValueError),
]


class TestPartitionPaths:
    @pytest.mark.parametrize("paths, index, count, want", PARTITION_CASES)
    def test_against_the_jax_package(self, paths, index, count, want):
        if want is ValueError:
            for fn in (multihost.partition_paths, jax_partition):
                with pytest.raises(ValueError, match="process_index"):
                    fn(paths, index, count)
            return
        assert multihost.partition_paths(paths, index, count) == want
        assert jax_partition(paths, index, count) == want

    def test_every_path_lands_on_exactly_one_process(self):
        slices = [multihost.partition_paths(SEVEN, i, 3) for i in range(3)]
        assert sorted(p for s in slices for p in s) == sorted(SEVEN)

    def test_topology_single_process(self):
        assert multihost.process_topology() == jax_topology() == (0, 1)


def _fake_topology(monkeypatch, rank, n):
    monkeypatch.setattr(multihost, "process_topology", lambda: (rank, n))


def _write(tmp_path, n=3, seed0=140):
    paths = []
    for i in range(n):
        p = str(tmp_path / f"mh{i}.npz")
        NpzIO().save(make_archive(nsub=4, nchan=16, nbin=64, seed=seed0 + i), p)
        paths.append(p)
    return paths


class TestDriverSplit:
    @pytest.mark.parametrize("backend, want", [("torch", [1]), ("numpy", [0, 1, 2])])
    def test_run_cleans_its_slice_with_torch_only(self, tmp_path, monkeypatch, backend, want):
        paths = _write(tmp_path)
        _fake_topology(monkeypatch, 1, 2)
        reports = driver.run(paths, CleanConfig(backend=backend, quiet=True),
                             log_dir=str(tmp_path), device="cpu")
        assert [r.path for r in reports] == [paths[i] for i in want]
        assert all(r.error is None for r in reports)
        log = (tmp_path / "clean.log").read_text().strip().splitlines()
        # Every line names the whole invocation, not the slice.
        assert len(log) == len(want) and all(all(p in line for p in paths) for line in log)

    def test_sweep_takes_its_slice(self, tmp_path, monkeypatch):
        paths = _write(tmp_path)
        _fake_topology(monkeypatch, 0, 2)
        reports = driver.run_sweep(paths, CleanConfig(backend="torch"), [(5.0, 5.0)],
                                   device="cpu")
        assert [r.path for r in reports] == [paths[0], paths[2]]
        assert not os.path.exists(paths[1] + "_sweep.npz")

    @pytest.mark.parametrize("backend, topology, name", [
        ("torch", (1, 2), "r.json.p1"), ("torch", (0, 1), "r.json"),
        ("numpy", (1, 2), "r.json"), (None, (1, 2), "r.json")])
    def test_report_suffix(self, tmp_path, monkeypatch, backend, topology, name):
        _fake_topology(monkeypatch, *topology)
        cfg = None if backend is None else CleanConfig(backend=backend)
        driver.write_report([driver.ArchiveReport(path="a", out_path=None)],
                            str(tmp_path / "r.json"), cfg)
        assert sorted(os.listdir(tmp_path)) == [name]


class TestInitializeDistributed:
    ENV = {"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1"}

    @pytest.mark.parametrize("drop", ["RANK", "MASTER_PORT"])
    def test_reads_env(self, monkeypatch, drop):
        for k, v in self.ENV.items():
            monkeypatch.setenv(k, v)
        monkeypatch.delenv(drop)
        with pytest.raises(RuntimeError, match=drop):
            initialize_distributed(device="cpu")

    @pytest.mark.parametrize("kw, err, match", [
        ({"device": "cuda:1"}, RuntimeError, "does not exist"),
        ({}, RuntimeError, "does not exist"),                 # cuda:{LOCAL_RANK}
        ({"device": "cpu", "backend": "nccl"}, ValueError, "nccl runs on CUDA"),
    ])
    def test_refuses_without_falling_back(self, monkeypatch, kw, err, match):
        for k, v in self.ENV.items():
            monkeypatch.setenv(k, v)
        monkeypatch.setenv("LOCAL_RANK", "0")
        with pytest.raises(err, match=match):
            initialize_distributed(**kw)
        assert not torch.distributed.is_initialized()

    def test_local_mesh_needs_a_card_unless_asked(self):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            multihost.local_mesh()


class TestSingleArchiveMesh:
    @pytest.mark.parametrize("nsub", [8, 6, 9, 5])
    @pytest.mark.parametrize("n", range(1, 9))
    def test_sp_matches_the_jax_package(self, cpu_devices, nsub, n):
        want = jax_single_mesh((nsub, 16, 64), n).shape["sp"]
        assert autoshard.subint_ranks(nsub, n) == want

    @pytest.mark.parametrize("nsub, sp, want", [
        (8, 2, [(0, 4), (4, 8)]), (8, 3, [(0, 3), (3, 6), (6, 8)]), (5, 1, [(0, 5)]),
        (2, 4, [(0, 1), (1, 2), (2, 2), (2, 2)])])
    def test_subint_bounds(self, nsub, sp, want):
        assert subint_bounds(nsub, sp) == want


#: One process of the CLI run: joins the group, runs the CLI over every
#: path with a report, prints its slice.
CLI_SCRIPT = r"""
import json, os, sys
from iterative_cleaner_tpu_torch.parallel.mesh import initialize_distributed
initialize_distributed(backend="gloo", device="cpu", timeout_s=60)
from iterative_cleaner_tpu_torch.cli import main
from iterative_cleaner_tpu_torch.parallel.multihost import partition_paths, process_topology
paths = sys.argv[1:]
rc = main(["--device", "cpu", "-q", "--report", "report.json"] + paths)
rank = int(os.environ["RANK"])
assert process_topology() == (rank, 2), process_topology()
print("SLICE%d=%s" % (rank, json.dumps(partition_paths(paths))))
sys.exit(rc)
"""


def test_two_process_cli_run(tmp_path):
    run_dir, solo_dir = tmp_path / "ranks", tmp_path / "solo"
    run_dir.mkdir()
    solo_dir.mkdir()
    paths = _write(run_dir)
    solo = [shutil.copy(p, solo_dir) for p in paths]
    outs = run_ranks(CLI_SCRIPT, 2, run_dir, paths)

    slices = []
    for rank, (_rc, out, _err) in enumerate(outs):
        line = next(ln for ln in out.splitlines() if ln.startswith(f"SLICE{rank}="))
        slices.append(json.loads(line.split("=", 1)[1]))
    assert slices == [[paths[0], paths[2]], [paths[1]]]
    for rank, sl in enumerate(slices):
        rep = json.loads((run_dir / f"report.json.p{rank}").read_text())
        assert [r["path"] for r in rep] == sl and all(r["error"] is None for r in rep)
    assert not (run_dir / "report.json").exists()
    log = (run_dir / "clean.log").read_text().strip().splitlines()
    assert len(log) == 3 and all(all(p in line for p in paths) for line in log)

    # The same archives cleaned by one process: the same weights.
    assert cli.main(["--device", "cpu", "-q", "-l", *solo]) == 0
    for p, s in zip(paths, solo):
        got = NpzIO().load(p + "_cleaned.npz").weights
        want = NpzIO().load(s + "_cleaned.npz").weights
        assert np.array_equal(got, want), p


def test_new_modules_are_in_the_import_hygiene_glob():
    # tests/test_torch_clean.py's TestImportHygiene parses every file of its
    # glob for JAX imports and imports them all in a fresh interpreter.
    from test_torch_clean import REPO, _py_files

    files = {str(p.relative_to(REPO)) for p in _py_files()}
    assert {"iterative_cleaner_tpu_torch/parallel/multihost.py",
            "iterative_cleaner_tpu_torch/parallel/collectives.py"} <= files
