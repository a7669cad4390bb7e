"""The frozen byte counts give the kernel table's numbers at LOFAR."""

import pytest

from bench_port import bounds

LOFAR = (256, 1024, 1024)


@pytest.mark.parametrize("kernel, launch, gb", [
    ("fused_fit_moments", {"narch": 1, "shape": LOFAR}, 2.152),
    ("ordered_template", {"narch": 1, "shape": LOFAR}, 1.075),
    ("ordered_template", {"narch": 9, "shape": LOFAR, "reads": 1}, 1.083),
    ("ordered_template", {"narch": 1, "shape": (1024, 4096, 1024)}, 17.20),
    ("fused_fit_moments", {"narch": 1, "shape": (366, 4096, 1024)}, 12.306),
])
def test_bytes(kernel, launch, gb):
    nbytes, _ops = bounds.COSTS[kernel](**launch)
    assert round(nbytes / 1e9, 3 if gb < 17 else 2) == gb


def test_bound_is_bytes_at_lofar():
    assert bounds.bound_s("fused_fit_moments", narch=1, shape=LOFAR) == pytest.approx(
        2_151_948_292 / 3.35e12)
    assert bounds.bound_s("ordered_template", narch=1, shape=LOFAR) * 1e3 == pytest.approx(
        0.3208, abs=1e-4)
