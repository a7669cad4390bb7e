"""Iteration-invariant preprocessing: pscrunch → dedisperse → baseline removal.

A copy of ``iterative_cleaner_tpu/ops/preprocess.py:43-148``:
weight-independent work that runs once, producing the static cube
``D:(nsub, nchan, nbin) float32`` the iteration loop reads.  On the host, as
in the JAX package, :func:`preprocess` prefers the native C++/OpenMP route
(:mod:`..native`, bit-identical) when its library builds, and takes the
numpy path otherwise.  Given a ``device``, it uploads the raw pscrunched
plane instead and preprocesses it there in place (:func:`preprocess_plane`:
the hand-written kernels of ``csrc/preprocess.cu`` on the card, their plain
twin :func:`preprocess_plane_plain` on the CPU), bit for bit with the native
pass, and hands back the cube's NaN-ignoring peak for the input scan
(``core/cleaner._parity_warnings``).  The route taken is counted in
:mod:`..obs.tracing` (``preprocess_native`` / ``preprocess_numpy`` /
``preprocess_device``).

Semantics (documented divergences from PSRCHIVE, shared by both packages):

- ``pscrunch``: Intensity → identity; Stokes → pol 0; Coherence → pol0+pol1.
- ``dedisperse``: per-channel integer-bin circular rotation with the
  dispersion constant 1/2.41e-4 MHz^2 s (all four diagnostics are
  circular-shift invariant, so integer rotation is mask-equivalent).
- ``remove_baseline``: the width-``0.15*nbin`` circular window minimising the
  weighted total profile's running mean; each profile loses its own mean over
  that window, accumulated in f64.  Where a NaN or an infinity reaches the
  total profile, the numpy path's ``argmin`` takes the first NaN mean, the
  native pass (and the device route with it) the least of the others.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from iterative_cleaner_tpu_torch.io.base import (
    Archive,
    STATE_COHERENCE,
    STATE_INTENSITY,
    STATE_STOKES,
)
from iterative_cleaner_tpu_torch.obs import tracing
from iterative_cleaner_tpu_torch.ops.cuda_build import load_library

# PSRCHIVE's inverse dispersion constant: delay[s] = DM / 2.41e-4 * f^-2[MHz].
DM_CONST = 1.0 / 2.41e-4
BASELINE_FRAC = 0.15


def pscrunch(data: np.ndarray, state: str) -> np.ndarray:
    """(nsub, npol, nchan, nbin) → total intensity (nsub, nchan, nbin)."""
    if data.shape[1] == 1 or state == STATE_INTENSITY:
        return data[:, 0]
    if state == STATE_STOKES:
        return data[:, 0]
    if state == STATE_COHERENCE:
        return data[:, 0] + data[:, 1]
    raise ValueError(f"unknown polarization state {state!r}")


def dispersion_shifts(
    freqs: np.ndarray, dm: float, period: float, nbin: int, ref_freq: float
) -> np.ndarray:
    """Integer bin shift per channel that dedisperses the cube."""
    if dm == 0.0 or period <= 0:
        return np.zeros(len(freqs), dtype=np.int64)
    delay = DM_CONST * dm * (
        np.asarray(freqs, np.float64) ** -2 - float(ref_freq) ** -2)  # ict: f64-ok(oracle-parity f64 accumulation on the host)
    return np.round(delay / period * nbin).astype(np.int64) % nbin


def archive_shifts(archive: Archive) -> np.ndarray:
    """The int32 shift of each channel that dedisperses ``archive`` (0
    where it is dedispersed already), as the native pass and the device
    route take them."""
    if archive.dedispersed:
        return np.zeros(archive.nchan, np.int32)
    return dispersion_shifts(archive.freqs, archive.dm, archive.period, archive.nbin,
                             archive.centre_frequency).astype(np.int32)


def baseline_width(nbin: int, frac: float = BASELINE_FRAC) -> int:
    """The baseline window's width in bins, as every route takes it."""
    return max(1, int(round(frac * nbin)))


def roll_cube(cube: np.ndarray, shifts: np.ndarray, inverse: bool = False) -> np.ndarray:
    """Circularly rotate each channel of (..., nchan, nbin) by its shift."""
    nbin = cube.shape[-1]
    sh = (-shifts if inverse else shifts) % nbin
    idx = (np.arange(nbin)[None, :] + sh[:, None]) % nbin  # (nchan, nbin)
    return np.take_along_axis(cube, idx[(None,) * (cube.ndim - 2)], axis=-1)


def baseline_window(total_profile: np.ndarray, frac: float = BASELINE_FRAC) -> tuple[int, int]:
    """(start, width) of the circular window minimising the running mean."""
    nbin = total_profile.shape[-1]
    width = baseline_width(nbin, frac)
    ext = np.concatenate([total_profile, total_profile[:width]])
    csum = np.concatenate([[0.0], np.cumsum(ext)])
    means = (csum[width : width + nbin] - csum[:nbin]) / width
    return int(np.argmin(means)), width


def remove_baseline(cube: np.ndarray, weights: np.ndarray, frac: float = BASELINE_FRAC) -> np.ndarray:
    """Subtract each profile's off-pulse mean (window from the total profile).

    ``cube`` is (nsub, nchan, nbin) dedispersed; ``weights`` (nsub, nchan).
    The subtraction runs in f64 per subint, keeping the f64 temporaries at
    nchan*nbin.
    """
    nbin = cube.shape[-1]
    total = np.einsum(
        "sc,scb->b", weights.astype(np.float64), cube.astype(np.float64))  # ict: f64-ok(oracle-parity f64 accumulation on the host)
    start, width = baseline_window(total, frac)
    idx = (start + np.arange(width)) % nbin
    base = cube[..., idx].mean(axis=-1, keepdims=True, dtype=np.float64)  # ict: f64-ok(oracle-parity f64 accumulation on the host)
    out = np.empty_like(cube, dtype=np.float32)
    for s in range(cube.shape[0]):
        out[s] = (cube[s].astype(np.float64) - base[s]).astype(np.float32)  # ict: f64-ok(oracle-parity f64 accumulation on the host)
    return out


def preprocess(archive: Archive, prefer_native: bool = True, device=None):
    """Archive → (D, w0): the pscrunched, dedispersed, baseline-removed
    float32 cube (nsub, nchan, nbin) and the frozen original weights.

    On the host (``device`` None) it uses the C++/OpenMP host runtime when
    it builds (bit-identical output, ``tests/test_torch_native.py``) and
    falls back to the numpy path.  Given a ``device`` it returns (D, w0,
    peak): the raw pscrunched plane and the weights are uploaded
    (``backends/torch_backend.upload``, before the phase), then
    :func:`preprocess_plane` makes D of that device tensor in place, bit for
    bit with the native pass; ``w0`` is a fresh host copy as on the host,
    ``peak`` the :class:`DevicePeak` of D.  Every route runs in the
    ``clean_preprocess`` phase."""
    if device is not None:
        return _preprocess_on(archive, device)
    with tracing.phase("clean_preprocess"):
        if prefer_native:
            from iterative_cleaner_tpu_torch import native

            out = native.preprocess_native(archive)
            if out is not None:
                tracing.count("preprocess_native")
                return out
        tracing.count("preprocess_numpy")
        cube = pscrunch(archive.data, archive.state).astype(np.float32)
        if not archive.dedispersed:
            shifts = dispersion_shifts(
                archive.freqs, archive.dm, archive.period, archive.nbin, archive.centre_frequency
            )
            cube = roll_cube(cube, shifts)
        w0 = archive.weights.astype(np.float32)
        cube = remove_baseline(cube, w0)
        return np.ascontiguousarray(cube, dtype=np.float32), w0


def _preprocess_on(archive: Archive, device):
    from iterative_cleaner_tpu_torch.backends.torch_backend import upload

    dev = torch.device(device)
    # Always a fresh copy, as the host routes give: w0 must not alias
    # archive.weights.
    w0 = np.array(archive.weights, dtype=np.float32, copy=True)
    D, w = upload(dev, torch.float32, pscrunch(archive.data, archive.state), w0)
    (sh,) = upload(dev, torch.int32, archive_shifts(archive))
    if D.device.type == "cpu":
        # A CPU tensor may share the archive's memory: never preprocess that.
        D = D.clone()
    with tracing.phase("clean_preprocess"):
        tracing.count("preprocess_device")
        _start, peak = preprocess_plane(D, w, sh, baseline_width(archive.nbin))
    return D, w0, peak


class DevicePeak:
    """The NaN-ignoring (min, max) of a cube on its device, as a device pair
    that nothing has waited for yet.  :meth:`read` fetches it once (which
    waits for the work that made it) and lets go of the device pair, so that
    none of it stays allocated through the loop; (NaN, NaN) where every
    value is NaN, as ``np.nanmin`` / ``np.nanmax`` give."""

    def __init__(self, pair: torch.Tensor) -> None:
        self._pair = pair
        self._value: tuple[float, float] | None = None

    def read(self) -> tuple[float, float]:
        if self._value is None:
            lo, hi = self._pair.tolist()
            self._pair = None
            nan = float("nan")
            self._value = (lo, hi) if lo <= hi else (nan, nan)
        return self._value


def cube_peak(D: torch.Tensor) -> DevicePeak:
    """:class:`DevicePeak` of ``D (nsub, ...)``, subint by subint (the
    device route's kernels fold it into their last pass instead)."""
    lo = torch.full((), float("inf"), dtype=D.dtype, device=D.device)
    hi = torch.full((), float("-inf"), dtype=D.dtype, device=D.device)
    for x in D:
        nan = torch.isnan(x)
        lo = torch.minimum(lo, torch.where(nan, float("inf"), x).amin())
        hi = torch.maximum(hi, torch.where(nan, float("-inf"), x).amax())
    return DevicePeak(torch.stack((lo, hi)))


def first_minimum(means: np.ndarray) -> int:
    """The native pass's window start: the first index of the least mean
    under its strict ``<``, which no NaN ever passes (a NaN first mean
    keeps 0)."""
    if np.isnan(means[0]):
        return 0
    return int(np.flatnonzero(means == np.nanmin(means))[0])


#: Profiles the plain twin widens at once before its ordered adds.
PLAIN_ROWS = 4096


def preprocess_plane_plain(D: torch.Tensor, w: torch.Tensor, shifts: torch.Tensor,
                           width: int) -> tuple[torch.Tensor, DevicePeak]:
    """The kernels' function in plain PyTorch, in place on ``D``: each row
    of channel ``c`` rotated by ``shifts[c]``; the float64 total profile
    ``total[b] += w[i] * D[i, b]``, profile after profile in
    (subint, channel) order; the window start (:func:`first_minimum` of the
    running means, from native's sequential ``csum``); each row less its
    window mean, summed in window order in float64.  Returns (start, peak):
    an int32 scalar on ``D``'s device and D's :class:`DevicePeak`."""
    nsub, nchan, nbin = D.shape
    f64 = torch.float64  # ict: f64-ok(the native pass's float64 accumulation, bit for bit)
    rows = D.view(-1, nbin)
    sh = torch.remainder(shifts.to(torch.int64), nbin)
    idx = (torch.arange(nbin, device=D.device)[None, :] + sh[:, None]) % nbin
    for s in range(nsub):
        D[s] = torch.gather(D[s], 1, idx)
    wf = w.reshape(-1).to(f64)
    total = torch.zeros(nbin, dtype=f64, device=D.device)
    for lo in range(0, rows.shape[0], PLAIN_ROWS):
        for row in rows[lo:lo + PLAIN_ROWS].to(f64) * wf[lo:lo + PLAIN_ROWS, None]:
            total = total + row
    t = total.cpu().numpy()
    # np.cumsum accumulates in order, as the native pass's csum does; an
    # infinity in it makes NaN means, as there.
    with np.errstate(invalid="ignore"):
        csum = np.concatenate([[0.0], np.cumsum(np.concatenate([t, t[:width]]))])
        start = first_minimum((csum[width:width + nbin] - csum[:nbin]) / width)
    acc = torch.zeros(rows.shape[0], dtype=f64, device=D.device)
    for k in range(width):
        acc = acc + rows[:, (start + k) % nbin].to(f64)
    # A true quotient: CUDA divides by a scalar as a product with its
    # reciprocal, which rounds otherwise.
    mean = (acc / torch.full_like(acc, width)).view(nsub, nchan, 1)
    for s in range(nsub):
        D[s] = (D[s].to(f64) - mean[s]).to(torch.float32)
    return torch.full((), start, dtype=torch.int32, device=D.device), cube_peak(D)


#: The widest row the kernels take (the roll stages a row in a block's
#: shared memory); the library's ``preprocess_max_bins``.
DEVICE_MAX_NBIN = 232448 // 4


def _bind(lib) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.preprocess_launch.argtypes = [p] * 6 + [i64, i32, i32, i32, i32, p]
    lib.preprocess_launch.restype = i32
    lib.preprocess_error_string.argtypes = [i32]
    lib.preprocess_error_string.restype = ctypes.c_char_p
    lib.preprocess_max_bins.argtypes = []
    lib.preprocess_max_bins.restype = i32
    if lib.preprocess_max_bins() != DEVICE_MAX_NBIN:
        raise RuntimeError(
            "csrc/preprocess.cu and ops/preprocess.py disagree on the widest row: "
            f"{lib.preprocess_max_bins()} against {DEVICE_MAX_NBIN}")


def _check_operands(D: torch.Tensor, w: torch.Tensor, shifts: torch.Tensor, width: int) -> None:
    if D.dim() != 3 or D.dtype != torch.float32 or not D.is_contiguous():
        raise ValueError(f"D must be a contiguous float32 (nsub, nchan, nbin) cube, got "
                         f"{D.dtype} {tuple(D.shape)}")
    nsub, nchan, nbin = D.shape
    if (w.dtype != torch.float32 or not w.is_contiguous() or w.numel() != nsub * nchan
            or w.device != D.device):
        raise ValueError(f"w must hold one contiguous float32 weight per profile on {D.device}")
    if (shifts.dtype != torch.int32 or not shifts.is_contiguous() or shifts.numel() != nchan
            or shifts.device != D.device):
        raise ValueError(f"shifts must be one contiguous int32 shift per channel on {D.device}")
    if not 0 < width <= nbin:
        raise ValueError(f"the window must be 1 to {nbin} bins wide, got {width}")
    if D.device.type == "cuda" and nbin > DEVICE_MAX_NBIN:
        raise ValueError(f"the kernels take rows of at most {DEVICE_MAX_NBIN} bins, got {nbin}")


def preprocess_plane(D: torch.Tensor, w: torch.Tensor, shifts: torch.Tensor,
                     width: int) -> tuple[torch.Tensor, DevicePeak]:
    """Dedisperse and baseline-remove the raw plane ``D (nsub, nchan,
    nbin)`` in place under the weights ``w (nsub, nchan)``, the channels'
    ``shifts`` (int32, any sign) and a ``width``-bin window
    (:func:`baseline_width`).  Returns (start, peak): the window's start
    as an int32 device scalar and D's :class:`DevicePeak`, neither read.  A CPU tensor runs
    :func:`preprocess_plane_plain`; a CUDA tensor launches
    ``csrc/preprocess.cu`` or raises — there is no fallback.  Launches
    count in ``launches``."""
    _check_operands(D, w, shifts, width)
    if D.device.type == "cpu":
        return preprocess_plane_plain(D, w, shifts, width)
    if D.device.type != "cuda":
        raise ValueError(f"preprocess_plane runs on cuda or cpu, not {D.device}")
    nsub, nchan, nbin = D.shape
    scratch = torch.empty(nsub * nchan + 3 * nbin + width + 1,
                          dtype=torch.float64,  # ict: f64-ok(the native pass's float64 accumulation, bit for bit)
                          device=D.device)
    start = torch.empty((), dtype=torch.int32, device=D.device)
    pair = torch.empty(2, dtype=torch.float32, device=D.device)
    path = 0 if D.data_ptr() % 16 == 0 and nbin % 4 == 0 else 1
    lib = load_library("preprocess", bind=_bind)
    with torch.cuda.device(D.device):  # ict: backend-init-ok(the operands are on the card: CUDA is live)
        stream = torch.cuda.current_stream(D.device).cuda_stream  # ict: backend-init-ok(the operands are on the card: CUDA is live)
        err = lib.preprocess_launch(
            D.data_ptr(), w.data_ptr(), shifts.data_ptr(), scratch.data_ptr(), start.data_ptr(),
            pair.data_ptr(), nsub, nchan, nbin, width, path, stream)
    if err != 0:
        raise RuntimeError(f"preprocess launch failed: "
                           f"{lib.preprocess_error_string(err).decode()} (cudaError {err})")
    with _LAUNCHES_LOCK:   # launches may come from several host threads
        preprocess_plane.launches += 1
    return start, DevicePeak(pair)


#: Launches of ``csrc/preprocess.cu`` since the last reset (plain-twin
#: calls never count).
preprocess_plane.launches = 0
_LAUNCHES_LOCK = threading.Lock()


def redisperse_cube(archive: Archive, cube: np.ndarray) -> np.ndarray:
    """Inverse of the dedispersion roll, for the residual archive, which the
    reference stores in the original dispersed frame."""
    if archive.dedispersed:
        return cube
    shifts = dispersion_shifts(
        archive.freqs, archive.dm, archive.period, archive.nbin, archive.centre_frequency
    )
    return roll_cube(cube, shifts, inverse=True)
