"""Build and load the package's hand-written CUDA kernels.

Each ``csrc/<stem>.cu`` has a plain C interface (the headers beside it,
``csrc/*.cuh``, are shared by the kernels).  It is compiled with
``nvcc`` for Hopper (``sm_90a``) into a shared library and loaded with
``ctypes`` — seconds to build, against minutes for an extension that
includes PyTorch's headers.  The build happens at first use, never at
import, into ``iterative_cleaner_tpu_torch/_build/`` (git-ignored), keyed
by a hash of the source and the flags, so an unchanged source is built once
per checkout.  A failed build raises with the compiler's output.  Each build
is accounted in ``obs.tracing`` (``observe_kernel_build``: the
``kernel_build`` phase and ``compiles_total`` / ``compile_seconds_total``),
the port's counterpart of the JAX package's compile accounting.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from iterative_cleaner_tpu_torch.obs import tracing

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, then ``nvcc`` on PATH, then the default
    toolkit location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked at $CUDA_HOME/bin, PATH and /usr/local/cuda/bin); "
        "the CUDA kernels are built from source at first use")


def keyed_library(name: str, data: bytes, flags, build_dir: Path = BUILD_DIR) -> Path:
    """``<build_dir>/lib<name>-<key>.so``, the key a hash of ``data`` (what
    the build depends on) and the compiler ``flags``."""
    key = hashlib.sha256(data + " ".join(flags).encode()).hexdigest()[:16]
    return build_dir / f"lib{name}-{key}.so"


def compile_shared(cmd: list[str], out: Path,
                   timeout: float | None = None) -> subprocess.CompletedProcess:
    """Run the compiler command ``cmd`` with ``-o`` a temporary name beside
    ``out``, and rename the library to ``out`` when it succeeds: several
    processes (the test suite's workers) may build at once, and none may
    load a half-written file.  Returns the compiler's process; a failed
    build leaves no file.  Shared by the CUDA kernels and the native host
    runtime (``native.py``)."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    try:
        proc = subprocess.run([*cmd, "-o", str(tmp)], capture_output=True, text=True,
                              timeout=timeout)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    if proc.returncode == 0:
        os.replace(tmp, out)
    else:
        tmp.unlink(missing_ok=True)
    return proc


def library_path(stem: str, defines: tuple[str, ...] = ()) -> Path:
    """The build of ``csrc/<stem>.cu`` under ``defines``, keyed on the
    source, the headers under ``csrc/`` and the flags."""
    text = b"".join(p.read_bytes() for p in [CSRC_DIR / f"{stem}.cu",
                                              *sorted(CSRC_DIR.glob("*.cuh"))])
    return keyed_library(stem, text, (*NVCC_FLAGS, *(f"-D{d}" for d in defines)))


def build(stem: str, defines: tuple[str, ...] = ()) -> Path:
    """Compile ``csrc/<stem>.cu`` unless this exact source is built; returns
    the library path.  ``defines`` (``NAME=VALUE``, passed as ``-D``) build a
    variant beside it, for the probes under ``tools_torch/``.  The
    compiler's output (``-Xptxas -v``: registers, shared memory, spills) is
    kept beside it as ``.log``."""
    out = library_path(stem, defines)
    if out.exists():
        return out
    cmd = [find_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines),
           str(CSRC_DIR / f"{stem}.cu")]
    t0 = time.perf_counter()
    proc = compile_shared(cmd, out)
    tracing.observe_kernel_build(time.perf_counter() - t0)
    if proc.returncode != 0:
        raise RuntimeError(
            f"building {stem}.cu failed (nvcc exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    return out


def build_log(stem: str, defines: tuple[str, ...] = ()) -> str:
    log = library_path(stem, defines).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load_library(stem: str, bind=None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, building it first if
    needed.  ``bind(lib)`` declares its C interface once, under the same
    lock as the build and the load: several host threads (the serving
    daemon's dispatch worker and its session passes) may reach the first
    launch together, and none may call the library before it is bound."""
    with _lock:
        lib = _loaded.get(stem)
        if lib is None:
            lib = ctypes.CDLL(str(build(stem)))
            if bind is not None:
                bind(lib)
            _loaded[stem] = lib
        return lib
