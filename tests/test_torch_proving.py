"""The port's proving package against the JAX package's, on the CPU.

``iterative_cleaner_tpu_torch.proving`` is held against
``iterative_cleaner_tpu.proving``: the ``ict-trace/v1`` grammar reads
across packages (a trace recorded by one is loaded by the other, a flight
recorder segment sealed by one replays through the other's ``traces``,
and both refuse the same malformed files), the seeded scenario generators
write byte-identical cubes in the same arrival order, and ``prove
--smoke`` on port replicas (``--device cpu``) passes with the JAX
verdict's keys.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
PKGS = ("iterative_cleaner_tpu", "iterative_cleaner_tpu_torch")
OTHER = {PKGS[0]: PKGS[1], PKGS[1]: PKGS[0]}
IDS = ["jax_writes", "port_writes"]


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _event_log(path: Path, seed: int) -> None:
    """A seeded JSON-lines event log with every submission shape the
    recorder derives from: keyed service submissions (with a failover's
    repeat), anonymous CLI arrivals, fleet-cache hits, other events and a
    torn line."""
    rng = np.random.default_rng(seed)
    ts = 100.0
    with open(path, "w") as fh:
        for i in range(24):
            ts += float(rng.integers(1, 50)) / 10
            kind = int(rng.integers(4))
            shape = [int(2 ** rng.integers(1, 4)), 16, 64]
            rec = {"event": "job_submitted", "ts": ts, "path": f"/d/{i}.npz",
                   "shape": shape, "bucket": "x".join(map(str, shape))}
            if kind == 0:
                rec.update(tenant=f"t{int(rng.integers(3))}",
                           idem_key=f"k{i}", trace_id=f"tr{i}",
                           entry="service")
            elif kind == 1:
                rec.update(entry="cli")
            elif kind == 2:
                rec.update(event="fleet_cache_hit", idem_key=f"c{i}",
                           cache_salt="s1")
            else:
                rec = {"event": "job_done", "ts": ts, "path": f"/d/{i}.npz"}
            fh.write(json.dumps(rec) + "\n")
            if kind == 0 and rng.random() < 0.3:   # a failover's repeat
                fh.write(json.dumps({**rec, "ts": ts + 0.5}) + "\n")
        fh.write("{torn line not json\n")


@pytest.mark.parametrize("seed", [0, 8])
@pytest.mark.parametrize("writer", PKGS, ids=IDS)
def test_trace_recorded_by_one_loads_in_the_other(tmp_path, writer, seed):
    log = tmp_path / "events.jsonl"
    _event_log(log, seed)
    out = {}
    for pkg in PKGS:
        path = str(tmp_path / f"{pkg}.trace.jsonl")
        out[pkg] = (_mod(pkg, "proving.traces").record_trace(str(log), path),
                    Path(path).read_bytes())
    assert out[PKGS[0]] == out[PKGS[1]]
    reader = _mod(OTHER[writer], "proving.traces")
    entries = reader.load_trace(str(tmp_path / f"{writer}.trace.jsonl"))
    assert len(entries) == out[writer][0] > 0
    assert [reader.replay_key(e, i) for i, e in enumerate(entries)] == [
        _mod(writer, "proving.traces").replay_key(e, i)
        for i, e in enumerate(entries)]


@pytest.mark.parametrize("writer", PKGS, ids=IDS)
def test_recorder_segment_sealed_by_one_replays_in_the_other(tmp_path,
                                                             writer):
    rec = _mod(writer, "proving.recorder").FlightRecorder(
        str(tmp_path / "tape"), max_segment_kb=1, keep=64)
    rng = np.random.default_rng(4)
    for i in range(30):
        rec.record(path=f"/data/j{i}.npz", tenant=f"t{i % 3}",
                   idem_key=f"job:{i}", shape=(4, 16, 64), bucket="4x16x64",
                   trace_id=f"tr-{i}", ts=1000.0 + i + float(rng.random()),
                   synthetic=bool(i % 7 == 0))
    rec.seal()
    rows = rec.segments()
    assert len(rows) >= 2
    loaded = 0
    for row in rows:
        entries = [_mod(pkg, "proving.traces").load_trace(row["path"])
                   for pkg in PKGS]
        assert [e.to_json() for e in entries[0]] == [
            e.to_json() for e in entries[1]]
        assert len(entries[1]) == row["entries"]
        loaded += row["entries"]
    assert loaded == rec.stats()["entries_total"] == 30 - 5
    # The other package's recorder adopts the sealed sequence.
    again = _mod(OTHER[writer], "proving.recorder").FlightRecorder(
        str(tmp_path / "tape"), max_segment_kb=1, keep=64)
    assert [r["name"] for r in again.segments()] == [r["name"] for r in rows]


BAD_TRACES = [
    ([], "empty"),
    (["not json"], "not JSON"),
    (['{"kind": "other", "version": 1}'], "kind"),
    (['{"kind": "ict-trace", "version": 99}'], "version"),
    (['{"kind": "ict-trace", "version": 1}', '{"t": 0.0}'], "path"),
    (['{"kind": "ict-trace", "version": 1}',
      '{"t": 5.0, "path": "/a"}', '{"t": 1.0, "path": "/b"}'], "out of order"),
    (['{"kind": "ict-trace", "version": 1}',
      '{"t": 0.0, "path": "/a", "entry": "carrier-pigeon"}'], "entry"),
]


@pytest.mark.parametrize("lines,msg", BAD_TRACES)
def test_bad_traces_refused_as_jax_refuses(tmp_path, lines, msg):
    p = tmp_path / "bad.trace.jsonl"
    p.write_text("\n".join(lines) + ("\n" if lines else ""))
    errors = []
    for pkg in PKGS:
        with pytest.raises(ValueError, match=msg) as info:
            _mod(pkg, "proving.traces").load_trace(str(p))
        errors.append(str(info.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("seed", [0, 5])
def test_scenario_mix_matches_jax(tmp_path, seed):
    out = {}
    for pkg in PKGS:
        sc = _mod(pkg, "proving.scenarios")
        workdir = tmp_path / pkg
        workdir.mkdir()
        subs = sc.build_mix(str(workdir), seed, sc.SMOKE_MIX)
        out[pkg] = ([(os.path.basename(s.path), s.tenant, s.idem_key,
                      tuple(s.shape), s.scenario) for s in subs],
                    sc.mix_digest(subs))
    assert out[PKGS[0]] == out[PKGS[1]]


def test_proving_modules_import_without_jax():
    code = """
import importlib, pkgutil, sys
sys.modules["jax"] = None

class Block:
    def find_spec(self, name, path=None, target=None):
        if name == "iterative_cleaner_tpu" or name.startswith(
                "iterative_cleaner_tpu."):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import iterative_cleaner_tpu_torch.proving as pkg
names = [i.name for i in pkgutil.iter_modules(pkg.__path__)]
for name in names:
    importlib.import_module(pkg.__name__ + "." + name)
print(sorted(names))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(REPO),
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(
        ["chaos", "recorder", "scenarios", "soak", "traces"])


def _verdict(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == 1            # the one-line contract
    return rc, json.loads(lines[0])


def test_prove_smoke_passes_with_the_jax_verdict_keys(tmp_path):
    from iterative_cleaner_tpu.proving.soak import prove_main as jax_main
    from iterative_cleaner_tpu_torch.proving.soak import prove_main

    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    rc, got = _verdict(prove_main, ["--smoke", "-q", "--device", "cpu",
                                    "--workdir", str(tmp_path / "port")])
    assert rc == 0 and got["prove"] == "pass", got
    assert got["backend"] == "torch" and all(got["triad"].values())
    assert got["jobs"]["lost"] == 0 and got["replay"]["ok"]
    assert all(d["ok"] for d in got["drills"])
    jax_rc, ref = _verdict(jax_main, ["--smoke", "-q", "--workdir",
                                      str(tmp_path / "jax")])
    assert jax_rc == 0 and ref["prove"] == "pass"
    assert sorted(got) == sorted(ref)
    assert sorted(got["jobs"]) == sorted(ref["jobs"])
    assert sorted(got["triad"]) == sorted(ref["triad"])
