"""Fixtures of the benchmark's own tests.

Run here on the CPU with ``python -m pytest bench_port/tests -q``; the tests
marked ``card`` run only where torch sees a CUDA device (on the card:
``python3 -m pytest bench_port/tests -q -m card``).  Whether a card is
present is decided inside the ``card`` fixture, never while a module is
imported.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

#: Small shapes of each configuration for runs on the CPU.
TINY = {"lofar_hba": {"nsub": 16, "nchan": 64, "nbin": 128},
        "wideband_4096": {"nsub": 32, "nchan": 64, "nbin": 64}}


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


def make_tiny_root(root: Path) -> Path:
    """A checkout-like tree under ``root`` with the repository's
    BENCHMARK.json, traffic mixes, entry points and metric readers, and each
    configuration at its small CPU shape."""
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    (root / "bench_port").mkdir(parents=True, exist_ok=True)
    for sub in ("traffic", "entries", "metrics"):
        shutil.copytree(REPO / "bench_port" / sub, root / "bench_port" / sub,
                        dirs_exist_ok=True, ignore=shutil.ignore_patterns("__pycache__"))
    for c in spec["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        cfg.update(TINY[c["name"]])
        (root / c["file"]).parent.mkdir(parents=True, exist_ok=True)
        (root / c["file"]).write_text(json.dumps(cfg))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))
