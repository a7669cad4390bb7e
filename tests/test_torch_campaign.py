"""The port's campaign package against the JAX package's, on the CPU.

``iterative_cleaner_tpu_torch.campaign`` is held against
``iterative_cleaner_tpu.campaign``: ``compile_manifest`` compiles the same
manifests to the same records (and refuses the same bad ones with the same
message), the idempotency keys agree, the QA and cost roll-ups fold the same
numpy-seeded records to the same figures, and a campaign spool written by
one package is read back by the other's store.  End to end, a campaign
through a port router in front of two port replicas (``device="cpu"``)
runs every archive exactly once, a duplicate is served from the fleet
cache, the masks are the oracle's, and the ``campaign`` sub-command follows
it to rc 0.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from iterative_cleaner_tpu.obs.quality import quality_summary as jax_quality_summary
from iterative_cleaner_tpu_torch import cli
from iterative_cleaner_tpu_torch.config import CleanConfig
from iterative_cleaner_tpu_torch.core.cleaner import clean_cube
from iterative_cleaner_tpu_torch.fleet.router import FleetConfig, FleetRouter
from iterative_cleaner_tpu_torch.io.npz import NpzIO
from iterative_cleaner_tpu_torch.io.synthetic import make_archive
from iterative_cleaner_tpu_torch.models.surgical import finalize_weights
from iterative_cleaner_tpu_torch.obs import tracing
from iterative_cleaner_tpu_torch.ops.preprocess import preprocess
from iterative_cleaner_tpu_torch.service import CleaningService, ServeConfig

REPO = Path(__file__).resolve().parent.parent
PKGS = ("iterative_cleaner_tpu", "iterative_cleaner_tpu_torch")
MAX_ITER = 3


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _archives(tmp_path, n=3):
    paths = []
    for i in range(n):
        p = tmp_path / f"s{i}.npz"
        p.write_bytes(b"x")
        paths.append(str(p))
    return paths


MANIFESTS = {
    "explicit": lambda paths, tmp: {"name": "a", "archives": paths[:2]},
    "globs_sorted": lambda paths, tmp: {"globs": [str(tmp / "s*.npz")],
                                        "tenant": "survey"},
    "overrides_and_config": lambda paths, tmp: {
        "archives": paths, "overrides": {paths[1]: {"audit": True}},
        "config": {"max_iter": 12}, "max_inflight": 2},
    "duplicates_keep_distinct_keys": lambda paths, tmp: {
        "archives": [paths[0], paths[0], paths[2]]},
}


@pytest.mark.parametrize("case", sorted(MANIFESTS))
def test_compile_manifest_matches_jax(tmp_path, case):
    paths = _archives(tmp_path)
    raw = MANIFESTS[case](paths, tmp_path)
    ref, port = (_mod(pkg, "campaign.manifest").compile_manifest(
        json.loads(json.dumps(raw)), campaign_id="c-fixed") for pkg in PKGS)
    for rec in (ref, port):
        rec.pop("created_s")
    assert port == ref
    keys = [e["idem_key"] for e in port["entries"]]
    assert len(set(keys)) == len(keys)


BAD_MANIFESTS = [
    ({"archives": ["/a"], "archvies": ["/b"]}, "unknown manifest field"),
    ({"globs": ["/nonexistent_dir_for_test/none_*.npz"]}, "names no archives"),
    ({"archives": ["/a"], "overrides": {"/zzz": {"audit": True}}},
     "not in the campaign"),
    ({"archives": ["/a"], "overrides": {"/a": {"max_iter": 9}}},
     "unsupported override"),
    ({"archives": ["/a"], "max_inflight": 0}, "max_inflight"),
    ([], "JSON object"),
]


@pytest.mark.parametrize("raw,msg", BAD_MANIFESTS)
def test_bad_manifests_refused_as_jax_refuses(raw, msg):
    errors = []
    for pkg in PKGS:
        with pytest.raises(ValueError, match=msg) as info:
            _mod(pkg, "campaign.manifest").compile_manifest(raw)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("seed", [0, 3, 77])
def test_idem_keys_match_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        cid = f"c{int(rng.integers(1000))}"
        index = int(rng.integers(100))
        path = f"/data/{int(rng.integers(1 << 30)):x}.npz"
        assert len({_mod(pkg, "campaign.manifest").archive_idem_key(
            cid, index, path) for pkg in PKGS}) == 1


def _records(seed):
    """Per-archive status records as the store keeps them: quality from
    seeded masks, cost records with seeded figures, a mix of states."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(12):
        state = "done" if rng.random() < 0.8 else "error"
        rec = {"index": i, "path": f"/a{i}.npz", "state": state}
        if state == "done":
            w = (rng.random((8, 16)) > rng.uniform(0.0, 0.5)).astype(
                np.float32)
            rec["quality"] = jax_quality_summary(
                w, termination=["converged", "max_iter"][int(rng.integers(2))])
            rec["cost"] = {
                "device_s": float(rng.integers(1, 100)) / 10,
                "compile_s": float(rng.integers(0, 10)) / 10,
                "phases": {"dispatch": float(rng.integers(1, 50)) / 10,
                           "emit": 0.1},
                "cache_hit": bool(rng.random() < 0.3),
                "avoided_device_s": float(rng.integers(0, 5)),
                "attainment": float(rng.random())}
        out.append(json.loads(json.dumps(rec)))
    return out


@pytest.mark.parametrize("seed", [1, 2, 5])
def test_rollups_match_jax(seed):
    recs = _records(seed)
    ref, port = ({"quality": _mod(pkg, "campaign.rollup").fold_quality(recs),
                  "cost": _mod(pkg, "campaign.rollup").fold_cost(recs)}
                 for pkg in PKGS)
    assert port == ref
    assert port["quality"]["jobs"] == sum(r["state"] == "done" for r in recs)


@pytest.mark.parametrize("writer", PKGS, ids=["jax_writes", "port_writes"])
def test_campaign_spool_reads_across_packages(tmp_path, writer):
    reader = PKGS[1] if writer == PKGS[0] else PKGS[0]
    paths = _archives(tmp_path)
    camp = _mod(writer, "campaign.manifest").compile_manifest(
        {"archives": paths, "tenant": "survey"}, campaign_id="c-x")
    store = _mod(writer, "campaign.store").CampaignStore(str(tmp_path / "sp"))
    store.save_campaign(camp)
    for e in camp["entries"]:
        store.save_archive("c-x", {"index": e["index"], "path": e["path"],
                                   "state": "done"})
    back = _mod(reader, "campaign.store").CampaignStore(str(tmp_path / "sp"))
    assert back.list_ids() == ["c-x"]
    assert back.load_campaign("c-x") == camp
    assert [r["index"] for r in back.load_archives("c-x")] == [0, 1, 2]


def test_campaign_modules_import_without_jax():
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
import iterative_cleaner_tpu_torch.campaign as pkg
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
        ["cli", "manifest", "orchestrator", "rollup", "store"])


# --- end to end on a port mini-fleet ---


def _replica(tmp_path, tag, **kw):
    svc = CleaningService(ServeConfig(
        spool_dir=str(tmp_path / f"spool_{tag}"), port=0, replica_id=tag,
        deadline_s=0.2, quiet=True, retry_backoff_s=0.01, device="cpu",
        clean=CleanConfig(backend="torch", max_iter=MAX_ITER, quiet=True,
                          no_log=True), **kw))
    svc.start()
    return svc


def _oracle(path):
    cfg = CleanConfig(backend="numpy", max_iter=MAX_ITER)
    res = clean_cube(*preprocess(NpzIO().load(path)), cfg)
    return finalize_weights(res.weights, cfg)[0]


def _get(base, route):
    with urllib.request.urlopen(base + route, timeout=30) as resp:
        return json.load(resp)


def test_campaign_runs_exactly_once_on_a_port_fleet(tmp_path):
    paths = []
    for i in range(4):
        p = str(tmp_path / f"survey{i}.npz")
        NpzIO().save(make_archive(nsub=4, nchan=16, nbin=64, seed=620 + i), p)
        paths.append(p)
    svcs = [_replica(tmp_path, "cp-a"), _replica(tmp_path, "cp-b")]
    router = FleetRouter(FleetConfig(
        replicas=tuple(f"http://127.0.0.1:{s.port}" for s in svcs),
        port=0, poll_interval_s=999.0, dead_after=2, quiet=True,
        retry_backoff_s=0.01, queue_timeout_s=5.0,
        spool_dir=str(tmp_path / "router_spool")))
    router.start()
    base = f"http://127.0.0.1:{router.port}"
    try:
        router.poll_tick()
        # Clean paths[0] once first, so the campaign's copy of it is a
        # fleet-cache hit.
        req = urllib.request.Request(
            f"{base}/jobs", data=json.dumps({"path": paths[0]}).encode(),
            headers={"Content-Type": "application/json"})
        first = json.load(urllib.request.urlopen(req, timeout=30))
        deadline = time.monotonic() + 120
        while _get(base, f"/jobs/{first['id']}")["state"] != "done":
            assert time.monotonic() < deadline, "first job not done"
            router.poll_tick()
            time.sleep(0.05)
        router.poll_tick()      # the router learns the result for its cache
        done0 = tracing.counters_snapshot().get("service_jobs_done", 0)
        manifest = tmp_path / "m.json"
        manifest.write_text(json.dumps({"name": "t", "tenant": "survey",
                                        "archives": paths}))
        # The follow client against the router, the poll loop driven by
        # hand beside it (the router's own loop is dormant).
        buf = io.StringIO()
        rc = {}

        def follow():
            with contextlib.redirect_stdout(buf):
                rc["rc"] = cli.main(["campaign", str(manifest), "--router",
                                     base, "--poll_s", "0.05", "--timeout_s",
                                     "120", "--json", "-q"])

        t = threading.Thread(target=follow)
        t.start()
        deadline = time.monotonic() + 150
        while t.is_alive():
            assert time.monotonic() < deadline, "campaign never settled"
            router.poll_tick()
            time.sleep(0.05)
        t.join()
        assert rc["rc"] == 0, buf.getvalue()
        view = json.loads(buf.getvalue().strip().splitlines()[-1])
        assert view["state"] == "done"
        assert view["archives"]["done"] == len(paths)
        # Exactly once: three fresh archives cleaned, the fourth served
        # from the fleet cache.
        assert tracing.counters_snapshot().get(
            "service_jobs_done", 0) - done0 == len(paths) - 1
        assert view["cost"]["cache_hits"] >= 1
        assert view["rollup"]["jobs"] == len(paths)
        for rec in view["archive_records"]:
            assert NpzIO().load(rec["out_path"]).weights.tobytes() == \
                _oracle(rec["path"]).tobytes()
    finally:
        router.stop()
        for s in svcs:
            s.stop()
