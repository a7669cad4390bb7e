"""The surgical clean's device preprocess (``ops/preprocess.preprocess`` with a
device, ``csrc/preprocess.cu``, its plain twin) against the native host pass.

On the CPU: the plain twin :func:`preprocess_plane_plain` is the native pass
(``native/ict_native.cc``, called with the same shifts) bit for bit — the
cube, the window start and the NaN-ignoring peak — and the numpy path where
the total profile is finite (where a NaN or an infinity reaches it, the
numpy path's ``argmin`` takes the first NaN mean and the native pass the
least of the others; the device route follows the native pass).  The route
choice of ``models/surgical.preprocess_device_for``, the pass-through of a
resident cube by ``to_device`` / ``upload``, and ``clean_cube`` on a tensor
cube with its peak.

Marked ``card`` (skipped without a CUDA card, which is decided in a fixture):
the kernels against the native pass at LOFAR shape (256 x 1024 x 1024) and
on the CPU cases, the >1e17 warning, and ``SurgicalCleaner.clean`` on both
routes: the same weights, scores and loops, no higher peak of the
allocator.  On the card: ``python -m pytest --noconftest -p no:cacheprovider
-m card tests/test_torch_preprocess_device.py`` (the suite's conftest
imports JAX, which the card's host does not have; this file does not).
"""

from __future__ import annotations

import ctypes
import shutil
import warnings
import zlib

import numpy as np
import pytest
import torch

from iterative_cleaner_tpu_torch import native
from iterative_cleaner_tpu_torch.backends import torch_backend
from iterative_cleaner_tpu_torch.config import CleanConfig
from iterative_cleaner_tpu_torch.core import cleaner
from iterative_cleaner_tpu_torch.io.base import STATE_COHERENCE, STATE_STOKES
from iterative_cleaner_tpu_torch.io.synthetic import make_archive
from iterative_cleaner_tpu_torch.models import surgical
from iterative_cleaner_tpu_torch.models.surgical import SurgicalCleaner, preprocess_device_for
from iterative_cleaner_tpu_torch.obs import tracing
from iterative_cleaner_tpu_torch.ops import preprocess as pp


def _native_lib():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native runtime cannot be built here")
    lib = native.get_lib()
    if lib is None:
        pytest.fail(f"g++ is present but the native build failed:\n{native.build_log()}")
    return lib


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the preprocess kernels have no CPU mode")
    return torch.device("cuda")


# --- the cases ---

#: name -> (nsub, nchan, nbin, what is done to the plane, weights or shifts).
CASES = {
    "dispersed": (5, 16, 64, "dispersed"),
    "dedispersed": (5, 16, 64, "none"),
    "shift_0_and_nbin_less_1": (4, 8, 64, "edge_shifts"),
    "negative_shifts": (4, 8, 64, "negative_shifts"),
    "window_wraps": (4, 8, 64, "wrap"),
    "zero_and_nonunit_weights": (5, 16, 64, "weights"),
    "nan_sample": (5, 16, 64, "nan"),
    "nan_profile": (5, 16, 64, "nan_row"),
    "infinities": (5, 16, 64, "inf"),
    "magnitude_1e18": (5, 16, 64, "big"),
    "nbin_3": (4, 6, 3, "dispersed"),
    "nbin_33_odd_width": (4, 8, 33, "dispersed"),
    "nbin_100_odd_width": (3, 8, 100, "dispersed"),
}


def _case(name: str):
    """(plane float32 (nsub, nchan, nbin), weights (nsub, nchan) float32,
    shifts int32 (nchan,))."""
    nsub, nchan, nbin, kind = CASES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    ar = make_archive(nsub=nsub, nchan=nchan, nbin=nbin, seed=11, dispersed=kind != "none")
    plane = np.ascontiguousarray(ar.data[:, 0], np.float32)
    w = np.array(ar.weights, np.float32)
    shifts = (pp.dispersion_shifts(ar.freqs, ar.dm, ar.period, nbin, ar.centre_frequency)
              if ar.dedispersed is False else np.zeros(nchan, np.int64))
    if kind == "edge_shifts":
        shifts = np.where(np.arange(nchan) % 2 == 0, 0, nbin - 1)
    elif kind == "negative_shifts":
        shifts = -rng.integers(1, 3 * nbin, nchan)
    elif kind == "wrap":
        # The baseline's dip straddles the last bin and the first.
        plane = rng.normal(size=plane.shape).astype(np.float32)
        plane[..., :3] -= 50.0
        plane[..., -4:] -= 50.0
        plane[..., nbin // 2:nbin // 2 + 5] += 80.0
        shifts = np.zeros(nchan, np.int64)
    elif kind == "weights":
        w[1] = 0.0
        w[2, 3] = 2.5
        w[3, ::3] = 0.375
    elif kind == "nan":
        plane[1, 3, 10] = np.nan
    elif kind == "nan_row":
        plane[1, 3, :] = np.nan
    elif kind == "inf":
        plane[2, 4, 20] = np.inf
        plane[0, 1, 5] = -np.inf
    elif kind == "big":
        plane[2, 4, 20] = 1e18
    return plane, w, np.asarray(shifts).astype(np.int32)


def _native(plane, w, shifts):
    """The native pass on an Intensity plane with these shifts."""
    lib = _native_lib()
    nsub, nchan, nbin = plane.shape
    out = np.empty_like(plane)
    fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
    rc = lib.ict_preprocess(plane.ctypes.data_as(fp), w.ctypes.data_as(fp),
                            shifts.ctypes.data_as(ip), nsub, 1, nchan, nbin,
                            native.STATE_TO_ENUM["Intensity"], pp.baseline_width(nbin),
                            out.ctypes.data_as(fp))
    assert rc == 0
    return out


def _native_start(plane, w, shifts) -> int:
    """The native pass's window start, step by step as ict_native.cc takes
    it: the rolled rows' float64 total profile in (subint, channel) order,
    the running csum and the strict ``<``."""
    nbin = plane.shape[-1]
    width = pp.baseline_width(nbin)
    rows = pp.roll_cube(plane, shifts).reshape(-1, nbin).astype(np.float64)
    total = np.zeros(nbin)
    with np.errstate(invalid="ignore"):
        for wi, row in zip(w.reshape(-1).astype(np.float64), rows):
            total = total + wi * row
        csum = [0.0]
        for b in range(nbin + width):
            csum.append(csum[-1] + total[b % nbin])
        start, best = 0, (csum[width] - csum[0]) / width
        for b in range(1, nbin):
            m = (csum[b + width] - csum[b]) / width
            if m < best:
                best, start = m, b
    return start, np.isfinite(total).all()


def _same_cube(got: np.ndarray, want: np.ndarray) -> bool:
    """Bit for bit where a number, NaN where NaN (a NaN's payload is the
    hardware's)."""
    nan = np.isnan(want)
    return (np.array_equal(nan, np.isnan(got))
            and np.array_equal(got.view(np.int32)[~nan], want.view(np.int32)[~nan]))


# --- CPU: the plain twin ---


@pytest.mark.parametrize("name", list(CASES))
def test_plain_twin_is_the_native_pass_bit_for_bit(name):
    plane, w, shifts = _case(name)
    want = _native(plane, w, shifts)
    D = torch.from_numpy(plane.copy())
    start, peak = pp.preprocess_plane(D, torch.from_numpy(w), torch.from_numpy(shifts),
                                      pp.baseline_width(plane.shape[-1]))
    assert _same_cube(D.numpy(), want)
    native_start, finite = _native_start(plane, w, shifts)
    assert int(start) == native_start
    if name == "window_wraps":
        assert native_start > plane.shape[-1] - pp.baseline_width(plane.shape[-1])
    lo, hi = peak.read()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # an all-NaN cube
        want_lo, want_hi = float(np.nanmin(want)), float(np.nanmax(want))
    assert (lo, hi) == (want_lo, want_hi)
    if finite:
        # The numpy path, where its argmin sees no NaN mean.
        numpy_D = pp.remove_baseline(pp.roll_cube(plane, shifts), w)
        assert _same_cube(numpy_D, want)


STATES = [(1, None, True), (2, STATE_COHERENCE, True), (4, STATE_STOKES, False)]


@pytest.mark.parametrize("npol, state, dispersed", STATES)
def test_device_route_on_the_cpu_is_the_host_route(npol, state, dispersed):
    _native_lib()
    ar = make_archive(nsub=5, nchan=33, nbin=100, npol=npol, seed=4, dispersed=dispersed,
                      state=state)
    raw = ar.data.copy()
    want, want_w0 = pp.preprocess(ar)
    snap = tracing.snapshot()
    D, w0, peak = pp.preprocess(ar, device="cpu")
    assert tracing.delta(snap, "preprocess_device") == 1
    assert tracing.delta(snap, "preprocess_native") == 0
    assert isinstance(D, torch.Tensor) and _same_cube(D.numpy(), want)
    assert w0.tobytes() == want_w0.tobytes() and not np.shares_memory(w0, ar.weights)
    assert np.array_equal(ar.data, raw)   # the archive is never written
    assert peak.read() == (float(np.nanmin(want)), float(np.nanmax(want)))


def test_peak_is_read_once_and_lets_go_of_the_pair():
    peak = pp.DevicePeak(torch.tensor([-2.0, 3.0]))
    assert peak.read() == (-2.0, 3.0)
    assert peak._pair is None and peak.read() == (-2.0, 3.0)
    lo, hi = pp.cube_peak(torch.full((2, 3, 4), float("nan"))).read()
    assert np.isnan(lo) and np.isnan(hi)


def test_kernel_wrapper_checks_its_operands():
    D = torch.zeros(2, 3, 8)
    w, sh = torch.ones(2, 3), torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        pp.preprocess_plane(D, w, sh.to(torch.int64), 2)
    with pytest.raises(ValueError, match="weight"):
        pp.preprocess_plane(D, torch.ones(2, 2), sh, 2)
    with pytest.raises(ValueError, match="window"):
        pp.preprocess_plane(D, w, sh, 9)
    with pytest.raises(ValueError, match="contiguous float32"):
        pp.preprocess_plane(D.double(), w, sh, 2)


# --- CPU: the route choice ---


def _tiny(npol=1, state=None):
    return make_archive(nsub=4, nchan=8, nbin=64, npol=npol, seed=2, state=state)


@pytest.fixture
def fake_card(monkeypatch):
    """A CUDA device that exists as far as the route choice asks, with the
    cube in memory by the estimate."""
    from iterative_cleaner_tpu_torch.parallel import autoshard

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(autoshard, "chunk_block_subints", lambda *a, **k: None)
    monkeypatch.delenv("ICT_FORENSICS", raising=False)


#: What keeps the host route, with the device a card.
HOST_ROUTE = {
    "coherence": (dict(), dict(npol=2, state=STATE_COHERENCE), {}),
    "x64": (dict(x64=True), {}, {}),
    "chunk_block": (dict(chunk_block=2), {}, {}),
    "audit": (dict(audit=True), {}, {}),
    "attribution": (dict(), {}, {"ICT_FORENSICS": "1"}),
    "numpy_backend": (dict(backend="numpy"), {}, {}),
}


def test_route_choice_takes_the_card_where_nothing_reads_a_host_cube(fake_card):
    got = preprocess_device_for(_tiny(), CleanConfig(backend="torch"), "cuda")
    assert got == torch.device("cuda")
    assert preprocess_device_for(_tiny(npol=4, state=STATE_STOKES),
                                 CleanConfig(backend="torch", unload_res=True),
                                 "cuda") == torch.device("cuda")


@pytest.mark.parametrize("why", list(HOST_ROUTE))
def test_route_choice_keeps_the_host_route(fake_card, monkeypatch, why):
    cfg_kw, ar_kw, env = HOST_ROUTE[why]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert preprocess_device_for(_tiny(**ar_kw), CleanConfig(backend="torch").replace(**cfg_kw),
                                 "cuda") is None


def test_route_choice_keeps_the_host_route_beyond_the_kernels_widest_row(fake_card):
    ar = make_archive(nsub=1, nchan=2, nbin=8, seed=2)
    ar.data = np.zeros((1, 1, 2, pp.DEVICE_MAX_NBIN + 4), np.float32)
    assert preprocess_device_for(ar, CleanConfig(backend="torch"), "cuda") is None


def test_route_choice_keeps_the_host_route_where_the_estimate_streams(monkeypatch):
    from iterative_cleaner_tpu_torch.parallel import autoshard

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(autoshard, "chunk_block_subints", lambda *a, **k: 2)
    assert preprocess_device_for(_tiny(), CleanConfig(backend="torch"), "cuda") is None
    assert preprocess_device_for(_tiny(), CleanConfig(backend="torch", auto_shard=False),
                                 "cuda") == torch.device("cuda")


@pytest.mark.parametrize("why", ["cpu_device", *HOST_ROUTE])
def test_clean_on_the_cpu_keeps_the_host_route(monkeypatch, why):
    cfg_kw, ar_kw, env = HOST_ROUTE.get(why, ({}, {}, {}))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    snap = tracing.snapshot()
    out = SurgicalCleaner(CleanConfig(backend="torch").replace(**cfg_kw),
                          device="cpu").clean(_tiny(**ar_kw))
    assert out.result.loops >= 1
    assert tracing.delta(snap, "preprocess_device") == 0


# --- CPU: the clean on a resident cube ---


def test_to_device_and_upload_pass_a_resident_tensor_through_uncounted():
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    host = np.ones((2, 2), np.float32)
    assert torch_backend.to_device(t, "cpu") is t
    snap = tracing.snapshot()
    out = torch_backend.upload(torch.device("cpu"), torch.float32, t, host)
    assert out[0] is t and np.array_equal(out[1].numpy(), host)
    assert tracing.delta(snap, "clean_upload_bytes") == host.nbytes


@pytest.mark.parametrize("fused", [False, True])
def test_clean_on_the_device_route_is_the_host_route(monkeypatch, fused):
    """The device route forced on the CPU (the plain twin): the same result
    as the host route, the cube never uploaded twice."""
    ar = make_archive(nsub=8, nchan=16, nbin=64, seed=42)
    cfg = CleanConfig(backend="torch", fused=fused)
    want = SurgicalCleaner(cfg, device="cpu").clean(ar)
    monkeypatch.setattr(surgical, "preprocess_device_for",
                        lambda archive, cfg, device: torch.device("cpu"))
    snap = tracing.snapshot()
    got = SurgicalCleaner(cfg, device="cpu").clean(ar)
    assert tracing.delta(snap, "preprocess_device") == 1
    # The plane, the weights and shifts once, the weights again: no cube twice.
    plane = ar.data[:, 0].nbytes
    assert tracing.delta(snap, "clean_upload_bytes") < 2 * plane
    assert np.array_equal(got.cleaned.weights, want.cleaned.weights)
    assert np.array_equal(got.result.test_results, want.result.test_results, equal_nan=True)
    assert got.result.loops == want.result.loops


def _parity_messages(D, w0, peak=None) -> list[str]:
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        cleaner._parity_warnings(D, w0, peak)
    return [str(w.message) for w in caught if "data magnitude" in str(w.message)]


@pytest.mark.parametrize("value, warns", [(2e17, True), (3e16, False), (np.nan, False),
                                          (np.inf, False), (-np.inf, False)])
@pytest.mark.parametrize("fill", ["one_sample", "every_sample"])
def test_parity_warning_reads_the_peak_as_the_host_scan(value, warns, fill):
    D = np.zeros((3, 4, 8), np.float32)
    if fill == "one_sample":
        D[1, 2, 3] = value
    else:
        D[:] = value
    w0 = np.ones((3, 4), np.float32)
    host = _parity_messages(D, w0)
    t = torch.from_numpy(D)
    assert _parity_messages(t, w0, pp.cube_peak(t)) == host
    assert _parity_messages(t, w0) == host
    assert bool(host) == warns


# --- on the card ---


@pytest.mark.card
@pytest.mark.parametrize("name", list(CASES))
def test_kernels_are_the_native_pass_on_the_small_cases(card, name):
    plane, w, shifts = _case(name)
    want = _native(plane, w, shifts)
    D = torch.from_numpy(plane.copy()).to(card)
    launches = pp.preprocess_plane.launches
    start, peak = pp.preprocess_plane(D, torch.from_numpy(w).to(card),
                                      torch.from_numpy(shifts).to(card),
                                      pp.baseline_width(plane.shape[-1]))
    assert pp.preprocess_plane.launches == launches + 1
    torch.cuda.synchronize()
    assert _same_cube(D.cpu().numpy(), want)
    assert int(start) == _native_start(plane, w, shifts)[0]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert peak.read() == (float(np.nanmin(want)), float(np.nanmax(want)))


@pytest.mark.card
def test_kernels_are_the_native_pass_and_the_twin_at_lofar(card):
    _native_lib()
    ar = make_archive(nsub=256, nchan=1024, nbin=1024, seed=42)
    want, _ = native.preprocess_native(ar)
    D, _w0, peak = pp.preprocess(ar, device=card)
    assert _same_cube(D.cpu().numpy(), want)
    assert peak.read() == (float(np.nanmin(want)), float(np.nanmax(want)))
    # The window start against the twin's, on the same plane on the card.
    shifts = pp.archive_shifts(ar)
    args = (torch.from_numpy(np.array(ar.weights, np.float32)).to(card),
            torch.from_numpy(shifts).to(card), pp.baseline_width(ar.nbin))
    plane = torch.from_numpy(np.ascontiguousarray(ar.data[:, 0])).to(card)
    start, _ = pp.preprocess_plane(plane.clone(), *args)
    twin = plane.clone()
    twin_start, _ = pp.preprocess_plane_plain(twin, *args)
    assert int(start) == int(twin_start)
    assert torch.equal(twin, D)


def _spiked(seed=42):
    ar = make_archive(nsub=32, nchan=128, nbin=256, seed=seed)
    ar.data[3, 0, 5, 40] = 1e18
    return ar


@pytest.mark.card
def test_magnitude_warning_on_the_device_route_as_on_the_host_route(card, monkeypatch):
    cfg = CleanConfig(backend="torch")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        SurgicalCleaner(cfg).clean(_spiked())
    on_device = [str(w.message) for w in caught if "data magnitude" in str(w.message)]
    monkeypatch.setattr(surgical, "preprocess_device_for", lambda *a: None)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        SurgicalCleaner(cfg).clean(_spiked())
    on_host = [str(w.message) for w in caught if "data magnitude" in str(w.message)]
    assert len(on_device) == 1 and on_device == on_host


@pytest.mark.card
@pytest.mark.parametrize("fused", [False, True])
def test_clean_on_both_routes_at_lofar(card, monkeypatch, fused):
    """The same weights, scores and loops; the device route's peak of the
    allocator no higher than the host route's."""
    ar = make_archive(nsub=256, nchan=1024, nbin=1024, seed=42)
    cfg = CleanConfig(backend="torch", fused=fused)
    SurgicalCleaner(cfg).clean(ar)   # both routes' kernels built and warm

    def run():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        snap = tracing.snapshot()
        out = SurgicalCleaner(cfg).clean(ar)
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated(), tracing.delta(snap, "preprocess_device")

    on_device, device_peak, n_device = run()
    with monkeypatch.context() as m:
        m.setattr(surgical, "preprocess_device_for", lambda *a: None)
        on_host, host_peak, n_host = run()
    assert (n_device, n_host) == (1, 0)
    assert np.array_equal(on_device.cleaned.weights, on_host.cleaned.weights)
    assert np.array_equal(on_device.result.test_results, on_host.result.test_results,
                          equal_nan=True)
    assert on_device.result.loops == on_host.result.loops
    assert device_peak <= host_peak, (device_peak, host_peak)
