"""ctypes bindings for the native host runtime.

A port of ``iterative_cleaner_tpu/native.py``: the ``.ictb`` archive writer
and reader (``ictb_save``, ``ictb_load_header``, ``ictb_load``) of the repo's
shared source ``native/ict_native.cc``, and the port's own host preprocess
pass (``ict_host_preprocess``, ``csrc/host_preprocess.cc``: pscrunch, integer
dedispersion, baseline removal on every core), bit for bit with that source's
``ict_preprocess`` and with the numpy path of :mod:`.ops.preprocess`.

The port compiles both sources itself, with ``g++``, into one library in its
own git-ignored ``_build/`` directory (never through ``make -C native``, whose
Makefile writes into the JAX package; ``ict_preprocess`` stays in the library
as the tests' reference).  The library's name carries a hash of the sources,
the flags and the host's CPU (``-march=native``), and it is written under a
temporary name and renamed, so concurrent processes (the test suite's
workers) never load a half-written file (``ops/cuda_build``'s
``keyed_library`` and ``compile_shared``, which the CUDA kernels build
through too).  The build runs at first use, never at import.

The pass reads the raw archive twice and writes its output once
(``csrc/host_preprocess.cc``).  Its output is an anonymous private mapping;
when every array over it is gone, the mapping is kept, already faulted in,
for the next output of its size (one at most, of up to
:data:`SPARE_MAX_BYTES`), so an archive after the first pays no page faults
for its 1 GiB (:func:`output_array`).  :func:`host_pass` also returns the
threads the pass ran on, which ``ops/preprocess`` keeps in the gauge
``clean_preprocess_threads``.

As in the JAX package, everything degrades to numpy when the toolchain or
the source is missing: :func:`available` is then False and
:func:`build_log` says why.  Which route each preprocess took is counted in
:mod:`.obs.tracing` (``preprocess_native`` / ``preprocess_numpy``), so a
caller can refuse a silent fall back to numpy.
"""

from __future__ import annotations

import collections
import ctypes
import mmap
import subprocess
import threading
import weakref
from pathlib import Path

import numpy as np

from iterative_cleaner_tpu_torch.ops import cuda_build

PKG_DIR = Path(__file__).resolve().parent
SOURCE = PKG_DIR.parent / "native" / "ict_native.cc"
HOST_SOURCE = PKG_DIR / "csrc" / "host_preprocess.cc"
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
    """The build of the current sources under :data:`CXXFLAGS` for this
    host's CPU."""
    return cuda_build.keyed_library(
        "ict_native", SOURCE.read_bytes() + HOST_SOURCE.read_bytes() + _host_cpu(),
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
    cmd = ["g++", *CXXFLAGS, str(SOURCE), str(HOST_SOURCE)]
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
        lib.ict_host_preprocess.argtypes = lib.ict_preprocess.argtypes
        lib.ict_host_preprocess.restype = ctypes.c_int
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


#: The last released output mapping, faulted in, for the next of its size.
_spare = collections.deque(maxlen=1)  # ict: guarded-by(none: atomic pop and append)

#: The largest output kept as the spare: four LOFAR archives' 1 GiB.  A
#: larger one (the north star's 17 GB cube on the chunked route) goes back to
#: the system when released, as any array does.
SPARE_MAX_BYTES = 4 << 30


def output_array(shape: tuple[int, ...]) -> np.ndarray:
    """A float32 array of ``shape`` to write whole, over an anonymous private
    mapping: the spare one when it has this size, else a fresh one (and any
    spare of another size is let go).  When the last array over the mapping
    is gone, the mapping becomes the spare: pages already faulted in, where a
    fresh 1 GiB costs a fault a page on first touch.  Above
    :data:`SPARE_MAX_BYTES`, a plain array that nothing keeps."""
    nbytes = int(np.prod(shape)) * 4
    if nbytes > SPARE_MAX_BYTES:
        _spare.clear()
    if nbytes == 0 or nbytes > SPARE_MAX_BYTES:
        return np.empty(shape, np.float32)
    try:
        buf = _spare.pop()
    except IndexError:
        buf = None
    if buf is None or len(buf) != nbytes:
        buf = mmap.mmap(-1, nbytes, flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS)
    flat = np.frombuffer(buf, np.float32)
    # Every view of ``flat`` holds it as its base, so this runs after the last.
    weakref.finalize(flat, _spare.append, buf)
    return flat.reshape(shape)


def host_pass(archive) -> tuple[np.ndarray, np.ndarray, int] | None:
    """Native pscrunch + dedisperse + baseline (``ict_host_preprocess``):
    (D, w0, the threads the pass ran on), or None if the library is missing.
    Bit-matches ``ict_preprocess`` and the numpy path of
    ``ops.preprocess.preprocess`` (both accumulate baselines in f64)."""
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
    out = output_array((nsub, nchan, nbin))
    threads = lib.ict_host_preprocess(
        _fptr(data), _fptr(w0),
        shifts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        nsub, npol, nchan, nbin, STATE_TO_ENUM[archive.state], width, _fptr(out))
    if threads < 1:
        raise RuntimeError(f"ict_host_preprocess failed with rc={threads}")
    return out, w0, threads


def preprocess_native(archive) -> tuple[np.ndarray, np.ndarray] | None:
    """(D, w0) of :func:`host_pass`, or None if the library is missing."""
    out = host_pass(archive)
    return None if out is None else out[:2]
