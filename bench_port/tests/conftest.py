"""Fixtures of the benchmark's own tests.

Run here on the CPU with ``python -m pytest bench_port/tests -q``; the tests
marked ``card`` run only where torch sees a CUDA device (on the card:
``python3 -m pytest bench_port/tests -q -m card``).  Whether a card is
present is decided inside the ``card`` fixture, never while a module is
imported.

Each configuration file carries its own small CPU shape under ``cpu_shape``
(``nsub``, ``nchan``, ``nbin``), which :func:`make_tiny_root` puts in place of
the configuration's size; nothing in a run reads the key.  So a
configuration and its cells join these tests by data files and entries in
``BENCHMARK.json`` alone.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

#: The cells of the repository's BENCHMARK.json, in its order.
CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]

def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (torch.cuda)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda is not available")
    return "cuda:0"


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")


def make_tiny_root(root: Path, src: Path = REPO) -> Path:
    """A checkout-like tree under ``root`` with the BENCHMARK.json, traffic
    mixes, entry points and metric readers of the tree ``src`` (by default
    the repository), and each configuration at its ``cpu_shape``."""
    spec = json.loads((src / "BENCHMARK.json").read_text())
    (root / "bench_port").mkdir(parents=True, exist_ok=True)
    for sub in ("traffic", "entries", "metrics"):
        shutil.copytree(src / "bench_port" / sub, root / "bench_port" / sub,
                        dirs_exist_ok=True, ignore=shutil.ignore_patterns("__pycache__"))
    for c in spec["configs"]:
        cfg = json.loads((src / c["file"]).read_text())
        cfg.update(cfg["cpu_shape"])
        (root / c["file"]).parent.mkdir(parents=True, exist_ok=True)
        (root / c["file"]).write_text(json.dumps(cfg))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))
