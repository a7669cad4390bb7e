"""ctypes bindings for the native host runtime (``native/ict_native.cc``).

A port of ``iterative_cleaner_tpu/native.py``: the ``.ictb`` archive writer
and reader (``ictb_save``, ``ictb_load_header``, ``ictb_load``) and the
OpenMP preprocess (``ict_preprocess``: pscrunch, integer dedispersion,
baseline removal), bit-identical to the numpy path of
:mod:`.ops.preprocess`.

The port compiles the repo's shared source ``native/ict_native.cc`` itself,
with ``g++``, straight into its own git-ignored ``_build/`` directory (never
through ``make -C native``, whose Makefile writes into the JAX package).
The library's name carries a hash of the source, the flags and the host's
CPU (``-march=native``), and it is written under a temporary name and
renamed, so concurrent processes (the test suite's workers) never load a
half-written file (``ops/cuda_build``'s ``keyed_library`` and
``compile_shared``, which the CUDA kernels build through too).  The build runs at
first use, never at import.

As in the JAX package, everything degrades to numpy when the toolchain or
the source is missing: :func:`available` is then False and
:func:`build_log` says why.  Which route each preprocess took is counted in
:mod:`.obs.tracing` (``preprocess_native`` / ``preprocess_numpy``), so a
caller can refuse a silent fall back to numpy.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path

import numpy as np

from iterative_cleaner_tpu_torch.ops import cuda_build

PKG_DIR = Path(__file__).resolve().parent
SOURCE = PKG_DIR.parent / "native" / "ict_native.cc"
BUILD_DIR = PKG_DIR / "_build"

#: The JAX package's ``native/Makefile`` flags.
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-fopenmp", "-std=c++17", "-Wall")

_lock = threading.Lock()
_lib = None  # ict: guarded-by(_lock)
_tried = False  # ict: guarded-by(_lock)
_build_log = ""  # ict: guarded-by(_lock)

STATE_TO_ENUM = {"Intensity": 0, "Stokes": 1, "Coherence": 2}
ENUM_TO_STATE = {v: k for k, v in STATE_TO_ENUM.items()}


class IctbHeader(ctypes.Structure):
    _fields_ = [
        ("magic", ctypes.c_uint32),
        ("version", ctypes.c_uint32),
        ("nsub", ctypes.c_uint32),
        ("npol", ctypes.c_uint32),
        ("nchan", ctypes.c_uint32),
        ("nbin", ctypes.c_uint32),
        ("centre_frequency", ctypes.c_double),
        ("dm", ctypes.c_double),
        ("period", ctypes.c_double),
        ("mjd_start", ctypes.c_double),
        ("mjd_end", ctypes.c_double),
        ("state", ctypes.c_uint32),
        ("dedispersed", ctypes.c_uint32),
        ("source", ctypes.c_char * 64),
    ]


def _host_cpu() -> bytes:
    """The host CPU's model and feature flags: ``-march=native`` builds for
    them, so a checkout copied to another host builds its own library."""
    try:
        with open("/proc/cpuinfo", "rb") as fh:
            lines = fh.read().split(b"\n\n", 1)[0].splitlines()
    except OSError:
        return b""
    return b"\n".join(ln for ln in lines if ln.startswith((b"model name", b"flags")))


def library_path() -> Path:
    """The build of the current source under :data:`CXXFLAGS` for this
    host's CPU."""
    return cuda_build.keyed_library("ict_native", SOURCE.read_bytes() + _host_cpu(),
                                    CXXFLAGS, BUILD_DIR)


def _build(log: list[str] | None = None) -> Path | None:
    """Compile the source unless this exact build exists; the library path,
    or None.  ``log``, when given, receives the build's log (the reason
    when None), which :func:`get_lib` keeps for :func:`build_log`."""
    log = [] if log is None else log
    if not SOURCE.is_file():
        log.append(f"no native source at {SOURCE}")
        return None
    out = library_path()
    if out.exists():
        return out
    cmd = ["g++", *CXXFLAGS, str(SOURCE)]
    try:
        proc = cuda_build.compile_shared(cmd, out, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as exc:
        log.append(f"{' '.join(cmd)}\n{exc}")
        return None
    log.append(f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    return out if proc.returncode == 0 else None


def get_lib():
    """The loaded library, building it first if needed; None if unavailable."""
    global _lib, _tried, _build_log
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        log: list[str] = []
        path = _build(log)
        if log:
            _build_log = log[-1]
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        u32, f32p = ctypes.c_uint32, ctypes.POINTER(ctypes.c_float)
        f64p, i32p = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32)
        hp = ctypes.POINTER(IctbHeader)
        lib.ictb_save.argtypes = [ctypes.c_char_p, hp, f64p, f32p, f32p]
        lib.ictb_save.restype = ctypes.c_int
        lib.ictb_load_header.argtypes = [ctypes.c_char_p, hp]
        lib.ictb_load_header.restype = ctypes.c_int
        lib.ictb_load.argtypes = [ctypes.c_char_p, hp, f64p, f32p, f32p]
        lib.ictb_load.restype = ctypes.c_int
        lib.ict_preprocess.argtypes = [
            f32p, f32p, i32p, u32, u32, u32, u32, u32, u32, f32p]
        lib.ict_preprocess.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def build_log() -> str:
    """The compiler's command and output of this process's build attempt
    (empty when the library was already built)."""
    with _lock:
        return _build_log


def _require():
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native library unavailable (no g++ toolchain?):\n{build_log()}")
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def save_ictb(path: str, archive) -> None:
    lib = _require()
    h = IctbHeader(
        nsub=archive.nsub, npol=archive.npol, nchan=archive.nchan,
        nbin=archive.nbin, centre_frequency=archive.centre_frequency,
        dm=archive.dm, period=archive.period, mjd_start=archive.mjd_start,
        mjd_end=archive.mjd_end, state=STATE_TO_ENUM[archive.state],
        dedispersed=int(archive.dedispersed),
        source=archive.source.encode()[:63],
    )
    data = np.ascontiguousarray(archive.data, np.float32)
    weights = np.ascontiguousarray(archive.weights, np.float32)
    freqs = np.ascontiguousarray(archive.freqs, np.float64)
    rc = lib.ictb_save(
        path.encode(), ctypes.byref(h),
        freqs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        _fptr(weights), _fptr(data))
    if rc != 0:
        raise OSError(f"ictb_save({path}) failed with rc={rc}")


def load_ictb(path: str):
    from iterative_cleaner_tpu_torch.io.base import Archive

    lib = _require()
    h = IctbHeader()
    rc = lib.ictb_load_header(path.encode(), ctypes.byref(h))
    if rc != 0:
        raise OSError(f"ictb_load_header({path}) failed with rc={rc}")
    freqs = np.empty(h.nchan, np.float64)
    weights = np.empty((h.nsub, h.nchan), np.float32)
    data = np.empty((h.nsub, h.npol, h.nchan, h.nbin), np.float32)
    rc = lib.ictb_load(
        path.encode(), ctypes.byref(h),
        freqs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        _fptr(weights), _fptr(data))
    if rc != 0:
        raise OSError(f"ictb_load({path}) failed with rc={rc}")
    return Archive(
        data=data, weights=weights, freqs=freqs,
        centre_frequency=h.centre_frequency, dm=h.dm, period=h.period,
        source=h.source.decode(errors="replace"),
        mjd_start=h.mjd_start, mjd_end=h.mjd_end,
        state=ENUM_TO_STATE[h.state], dedispersed=bool(h.dedispersed),
        filename=path,
    )


def preprocess_native(archive) -> tuple[np.ndarray, np.ndarray] | None:
    """Native pscrunch + dedisperse + baseline; None if the library is
    missing.  Bit-matches the numpy path of ``ops.preprocess.preprocess``
    (both accumulate baselines in f64)."""
    from iterative_cleaner_tpu_torch.ops.preprocess import archive_shifts, baseline_width

    lib = get_lib()
    if lib is None:
        return None
    nsub, npol, nchan, nbin = archive.data.shape
    shifts = archive_shifts(archive)
    width = baseline_width(nbin)
    data = np.ascontiguousarray(archive.data, np.float32)
    # Always a fresh copy: w0 is the frozen original weights and must not
    # alias archive.weights (the numpy path's astype also copies).
    w0 = np.array(archive.weights, dtype=np.float32, copy=True)
    out = np.empty((nsub, nchan, nbin), np.float32)
    rc = lib.ict_preprocess(
        _fptr(data), _fptr(w0),
        shifts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        nsub, npol, nchan, nbin, STATE_TO_ENUM[archive.state], width, _fptr(out))
    if rc != 0:
        raise RuntimeError(f"ict_preprocess failed with rc={rc}")
    return out, w0
