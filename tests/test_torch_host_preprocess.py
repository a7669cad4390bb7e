"""The port's host preprocess pass (``csrc/host_preprocess.cc``,
``ict_host_preprocess``, through ``native.preprocess_native``) against the
shared pass ``ict_preprocess`` of ``native/ict_native.cc``, built into the
same library with the same flags, and against the numpy path of
``ops/preprocess``, byte for byte.

The numpy path is compared wherever the total profile is finite, and where
a NaN makes the first window mean NaN (both keep start 0); where a NaN or an
infinity reaches a later window, the numpy path's ``argmin`` takes the first
NaN mean and the native passes the least of the others (``ops/preprocess``'s
docstring), so those cases hold the new pass to ``ict_preprocess`` alone.
The thread count must not move a bit: the pass runs in subprocesses at 1
thread, at 3 (which divides neither nbin nor the 16-bin line) and at the
host's count, and with teams smaller than it planned for (``OMP_THREAD_LIMIT``
of 1, 2 and 3, ``OMP_DYNAMIC``).  Skipped where there is no ``g++``.
"""

from __future__ import annotations

import ctypes
import gc
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from iterative_cleaner_tpu_torch import native
from iterative_cleaner_tpu_torch.io.base import STATE_COHERENCE, STATE_INTENSITY, STATE_STOKES
from iterative_cleaner_tpu_torch.io.synthetic import make_archive
from iterative_cleaner_tpu_torch.obs import tracing
from iterative_cleaner_tpu_torch.ops import preprocess as pp

REPO = Path(__file__).resolve().parent.parent

#: name -> (nsub, npol, nchan, nbin, state, shifts, specials, numpy_too).
#: shifts: "zero" (dedispersed), "dm" (a dispersion sweep within [0, nbin)),
#: "negative", "wide" (at least nbin), "mixed" (every kind at once).
CASES = {
    "intensity_dedispersed": (5, 1, 33, 100, STATE_INTENSITY, "zero", (), True),
    "intensity_dispersed": (5, 1, 33, 100, STATE_INTENSITY, "dm", (), True),
    "stokes_4pol_dedispersed": (5, 4, 33, 100, STATE_STOKES, "zero", (), True),
    "stokes_4pol_dispersed": (5, 4, 33, 100, STATE_STOKES, "dm", (), True),
    "coherence_2pol_dedispersed": (5, 2, 33, 100, STATE_COHERENCE, "zero", (), True),
    "coherence_2pol_dispersed": (5, 2, 33, 100, STATE_COHERENCE, "dm", (), True),
    "coherence_4pol_dedispersed": (5, 4, 33, 100, STATE_COHERENCE, "zero", (), True),
    "coherence_4pol_dispersed": (5, 4, 33, 100, STATE_COHERENCE, "dm", (), True),
    "negative_shifts": (4, 1, 24, 100, STATE_INTENSITY, "negative", (), True),
    "shifts_of_nbin_or_more": (4, 1, 24, 100, STATE_INTENSITY, "wide", (), True),
    "coherence_mixed_shifts": (3, 2, 17, 100, STATE_COHERENCE, "mixed", (), True),
    "nbin_7": (6, 1, 20, 7, STATE_INTENSITY, "mixed", (), True),
    "nbin_7_coherence": (6, 2, 20, 7, STATE_COHERENCE, "mixed", (), True),
    "nbin_16": (6, 1, 20, 16, STATE_INTENSITY, "mixed", (), True),
    "nbin_1024": (3, 1, 40, 1024, STATE_INTENSITY, "mixed", (), True),
    "nbin_1024_stokes": (2, 4, 24, 1024, STATE_STOKES, "dm", (), True),
    "fewer_profiles_than_threads": (1, 1, 3, 100, STATE_INTENSITY, "mixed", (), True),
    "one_profile_nbin_1024": (1, 1, 1, 1024, STATE_INTENSITY, "negative", (), True),
    "zero_weights": (6, 1, 30, 100, STATE_INTENSITY, "mixed", ("zero_weights",), True),
    "nan_and_infinities": (5, 1, 33, 100, STATE_INTENSITY, "mixed", ("nan_inf",), False),
    "nan_and_infinities_coherence": (4, 2, 16, 64, STATE_COHERENCE, "mixed", ("nan_inf",),
                                     False),
    "nan_and_infinities_zero_weights": (5, 1, 33, 1024, STATE_INTENSITY, "mixed",
                                        ("nan_inf", "zero_weights"), False),
    "wide_dynamic_range": (4, 1, 24, 100, STATE_INTENSITY, "mixed", ("scaled",), True),
    "wide_dynamic_range_coherence": (3, 2, 24, 1024, STATE_COHERENCE, "mixed", ("scaled",),
                                     True),
    "cancelling_pairs": (4, 1, 24, 100, STATE_INTENSITY, "mixed", ("cancel",), True),
    "cancelling_pairs_1024": (2, 1, 16, 1024, STATE_INTENSITY, "dm", ("cancel",), True),
    "cancelling_pairs_coherence": (3, 2, 16, 100, STATE_COHERENCE, "wide", ("cancel",), True),
    "nan_first_window_mean": (4, 1, 12, 100, STATE_INTENSITY, "mixed", ("nan_first",), True),
    "nan_first_window_mean_1024": (2, 1, 12, 1024, STATE_INTENSITY, "dm", ("nan_first",),
                                   True),
}


@pytest.fixture(autouse=True)
def _toolchain():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native runtime cannot be built here")
    if not native.available():
        pytest.fail(f"g++ is present but the native build failed:\n{native.build_log()}")


def _case(name: str, seed: int = 23):
    nsub, npol, nchan, nbin, state, kind, specials, numpy_too = CASES[name]
    rng = np.random.default_rng(seed + _name_seed(name))
    data = rng.normal(0.0, 1.0, (nsub, npol, nchan, nbin)).astype(np.float32)
    data[..., nbin // 3] += 20.0   # a pulse, so the window has a minimum to find
    w = rng.uniform(0.5, 2.0, (nsub, nchan)).astype(np.float32)
    dm = np.round(np.linspace(0.0, 0.9, nchan) ** 2 * nbin).astype(np.int32) % nbin
    shifts = {
        "zero": np.zeros(nchan, np.int32),
        "dm": dm,
        "negative": -rng.integers(1, nbin + 1, nchan).astype(np.int32),
        "wide": rng.integers(nbin, 5 * nbin, nchan).astype(np.int32),
        "mixed": rng.integers(-3 * nbin, 3 * nbin, nchan).astype(np.int32),
    }[kind]
    if kind == "mixed":
        shifts[: min(4, nchan)] = [0, nbin, -nbin, nbin - 1][: min(4, nchan)]
    if "scaled" in specials:
        # Magnitudes 1e-12 to 1e12: float64 sums of them round, so any other
        # order of adds shows in the bits.
        data *= (10.0 ** rng.uniform(-12, 12, data.shape)).astype(np.float32)
    if "cancel" in specials:
        # +1e20 then -1e20 every 7 bins: a float64 sum loses what came before
        # each pair, so only the same order of adds gives the same mean.
        data[..., 0::7] += np.float32(1e20)
        data[..., 1::7] -= np.float32(1e20)
    if "zero_weights" in specials:
        w[rng.random(w.shape) < 0.3] = 0.0
    if "nan_inf" in specials:
        last = nbin - 1
        data[0, 0, 0, last] = np.nan
        data[-1, 0, -1, last - 1] = np.inf
        data[0, 0, -1, last - 2] = -np.inf
        if npol > 1:
            data[-1, 1, 0, last] = np.nan
        w[0, 0] = 0.0   # 0 * NaN still reaches the total
    if "nan_first" in specials:
        # Rolled bin 0 of profile (0, 0) is source bin shifts[0] mod nbin.
        data[0, 0, 0, int(shifts[0]) % nbin] = np.nan
    return data, w, shifts, state, numpy_too


def _name_seed(name: str) -> int:
    return int(hashlib.sha256(name.encode()).hexdigest()[:6], 16)


def _call(fn_name: str, data, w, shifts, state) -> tuple[np.ndarray, int]:
    lib = native.get_lib()
    nsub, npol, nchan, nbin = data.shape
    out = np.full((nsub, nchan, nbin), 7.0, np.float32)   # every byte must be written
    fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
    rc = getattr(lib, fn_name)(
        data.ctypes.data_as(fp), w.ctypes.data_as(fp), shifts.ctypes.data_as(ip),
        nsub, npol, nchan, nbin, native.STATE_TO_ENUM[state], pp.baseline_width(nbin),
        out.ctypes.data_as(fp))
    return out, rc


def _numpy_path(data, w, shifts, state) -> np.ndarray:
    cube = pp.pscrunch(data, state).astype(np.float32)
    cube = pp.roll_cube(cube, shifts.astype(np.int64))
    with np.errstate(invalid="ignore"):
        return np.ascontiguousarray(pp.remove_baseline(cube, w), np.float32)


@pytest.mark.parametrize("name", list(CASES))
def test_byte_identical_to_the_shared_pass_and_the_numpy_path(name):
    data, w, shifts, state, numpy_too = _case(name)
    got, threads = _call("ict_host_preprocess", data, w, shifts, state)
    want, rc = _call("ict_preprocess", data, w, shifts, state)
    assert rc == 0 and threads >= 1
    assert got.tobytes() == want.tobytes()
    if numpy_too:
        assert got.tobytes() == _numpy_path(data, w, shifts, state).tobytes()
    else:
        # The case is one of those the numpy path's window differs on.
        assert not np.isfinite(got).all()


@pytest.mark.parametrize("npol, state, dispersed",
                         [(1, None, True), (1, None, False), (4, STATE_STOKES, False),
                          (2, STATE_COHERENCE, False), (4, STATE_COHERENCE, True)])
def test_preprocess_native_on_archives_sets_the_threads_gauge(npol, state, dispersed):
    ar = make_archive(nsub=6, nchan=40, nbin=128, npol=npol, seed=5, dispersed=dispersed,
                      state=state)
    D, w0 = native.preprocess_native(ar)
    want, _ = _call("ict_preprocess", np.ascontiguousarray(ar.data), ar.weights,
                    pp.archive_shifts(ar), ar.state)
    D_np, w_np = pp.preprocess(ar, prefer_native=False)
    assert D.shape == (6, 40, 128) and D.dtype == np.float32 and D.flags.c_contiguous
    assert D.flags.writeable
    assert D.tobytes() == want.tobytes() == D_np.tobytes()
    assert w0.tobytes() == w_np.tobytes() and not np.shares_memory(w0, ar.weights)
    tracing.set_gauge("clean_preprocess_threads", 0)
    snap = tracing.snapshot()
    D_route, _ = pp.preprocess(ar)   # the host route keeps the pass's threads
    assert tracing.delta(snap, "preprocess_native") == 1
    assert D_route.tobytes() == want.tobytes()
    threads = tracing.gauges_snapshot()[0]["clean_preprocess_threads"]
    assert threads == native.host_pass(ar)[2] == expected_threads(128, 240, _omp_threads())


def _omp_threads() -> int:
    n = os.environ.get("OMP_NUM_THREADS")
    return int(n) if n else len(os.sched_getaffinity(0))


def expected_threads(nbin: int, nprof: int, omp: int) -> int:
    """The pass's threads: the total's ranges of whole 16-bin lines, at
    most one a thread, and the rows' threads, the fewer."""
    want = max(1, min(omp, nbin // 16))
    chunk = -(-nbin // want)
    chunk = -(-chunk // 16) * 16
    return min(-(-nbin // chunk), omp, nprof)


def test_a_released_output_is_reused_and_a_held_one_never_is():
    native._spare.clear()
    a = native.output_array((3, 4, 256))
    view = a[1:]
    addr = a.ctypes.data
    del a
    gc.collect()
    b = native.output_array((3, 4, 256))   # the first is still held by its view
    assert b.ctypes.data != addr and not np.shares_memory(b, view)
    del view
    gc.collect()
    c = native.output_array((3, 4, 256))
    assert c.ctypes.data == addr and c.flags.writeable
    d = native.output_array((2, 4, 256))   # another size: a fresh mapping
    assert d.ctypes.data not in (addr, b.ctypes.data)
    del b, c, d
    gc.collect()
    assert len(native._spare) == 1         # one spare at most
    assert native.output_array((0, 4, 256)).shape == (0, 4, 256)


def test_an_output_over_the_spare_limit_is_never_kept(monkeypatch):
    native._spare.clear()
    monkeypatch.setattr(native, "SPARE_MAX_BYTES", 3 * 4 * 256 * 4)
    a = native.output_array((3, 4, 256))   # at the limit: kept when released
    del a
    gc.collect()
    assert len(native._spare) == 1
    big = native.output_array((4, 4, 256))   # over it: a plain array, the spare let go
    assert big.shape == (4, 4, 256) and big.flags.writeable and big.base is None
    assert len(native._spare) == 0
    del big
    gc.collect()
    assert len(native._spare) == 0


def test_a_window_wider_than_the_row_is_refused():
    data = np.zeros((1, 1, 2, 8), np.float32)
    lib = native.get_lib()
    fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
    out = np.empty((1, 2, 8), np.float32)
    rc = lib.ict_host_preprocess(
        data.ctypes.data_as(fp), np.ones((1, 2), np.float32).ctypes.data_as(fp),
        np.zeros(2, np.int32).ctypes.data_as(ip), 1, 1, 2, 8, 0, 9, out.ctypes.data_as(fp))
    assert rc == -1


_CHILD = """
import hashlib, json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
from iterative_cleaner_tpu_torch import native
from iterative_cleaner_tpu_torch.obs import tracing
from iterative_cleaner_tpu_torch.io.synthetic import make_archive
out = {}
for nbin, npol, state in ((1024, 1, None), (100, 2, "Coherence"), (7, 1, None)):
    ar = make_archive(nsub=4, nchan=48, nbin=nbin, npol=npol, seed=11, dispersed=True,
                      state=state)
    ar.data[0, 0, 5, nbin - 1] = np.nan
    D, _, threads = native.host_pass(ar)
    out[str(nbin)] = [hashlib.sha256(D.tobytes()).hexdigest(), threads]
print(json.dumps(out))
"""


def _child_runs(env: dict) -> dict:
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(REPO)],
                          env={**os.environ, **env}, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _shared_hashes() -> dict:
    """The children's archives through ``ict_preprocess``, in this process."""
    out = {}
    for nbin, npol, state in ((1024, 1, None), (100, 2, "Coherence"), (7, 1, None)):
        ar = make_archive(nsub=4, nchan=48, nbin=nbin, npol=npol, seed=11, dispersed=True,
                          state=state)
        ar.data[0, 0, 5, nbin - 1] = np.nan
        want, _ = _call("ict_preprocess", np.ascontiguousarray(ar.data), ar.weights,
                        pp.archive_shifts(ar), ar.state)
        out[str(nbin)] = hashlib.sha256(want.tobytes()).hexdigest()
    return out


def test_the_thread_count_moves_no_bit():
    host = len(os.sched_getaffinity(0))
    runs = {n: _child_runs({"OMP_NUM_THREADS": str(n)}) for n in sorted({1, 3, host})}
    for key in ("1024", "100", "7"):
        assert len({runs[n][key][0] for n in runs}) == 1, (key, runs)
    # nbin 1024 gives every thread a range; 7 bins are less than a line.
    for n in runs:
        assert runs[n]["1024"][1] == expected_threads(1024, 192, n) == min(n, 64)
        assert runs[n]["100"][1] == expected_threads(100, 192, n)
        assert runs[n]["7"][1] == 1
    # The shared pass agrees with them all.
    want = _shared_hashes()
    assert {k: v[0] for k, v in runs[1].items()} == want


@pytest.mark.parametrize("limit", [1, 2, 3])
def test_a_team_smaller_than_asked_moves_no_bit(limit):
    """OMP_THREAD_LIMIT under the threads asked for: the runtime gives each
    parallel region a smaller team than the pass planned its bin ranges for,
    and every range must still be summed."""
    host = len(os.sched_getaffinity(0))
    asked = max(host, 8)
    runs = _child_runs({"OMP_NUM_THREADS": str(asked), "OMP_THREAD_LIMIT": str(limit)})
    assert {k: v[0] for k, v in runs.items()} == _shared_hashes()
    assert runs["1024"][1] == min(limit, expected_threads(1024, 192, asked))
    assert runs["100"][1] == min(limit, expected_threads(100, 192, asked))
    assert runs["7"][1] == 1


def test_a_dynamic_team_moves_no_bit():
    """OMP_DYNAMIC lets the runtime give any team up to the threads asked."""
    host = len(os.sched_getaffinity(0))
    runs = _child_runs({"OMP_NUM_THREADS": str(max(host, 8)), "OMP_DYNAMIC": "true"})
    assert {k: v[0] for k, v in runs.items()} == _shared_hashes()
    assert all(1 <= v[1] <= max(host, 8) for v in runs.values())
