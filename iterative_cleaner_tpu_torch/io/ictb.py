"""Native binary archive backend (``.ictb``) — the fast data-loader path.

A copy of ``iterative_cleaner_tpu/io/ictb.py``.  The flat binary layout is
written and read by the C++ runtime (``native/ict_native.cc``, bound in
:mod:`..native`): no compression, one sequential read.  Files are
byte-identical to the JAX package's, so either package reads the other's.
"""

from __future__ import annotations

from iterative_cleaner_tpu_torch import native
from iterative_cleaner_tpu_torch.io.base import Archive


class IctbIO:
    def __init__(self) -> None:
        if not native.available():
            raise ImportError(
                "native library unavailable (needs g++ to build native/ict_native.cc); "
                f"use the .npz backend\n{native.build_log()}")

    def load(self, path: str) -> Archive:
        return native.load_ictb(path)

    def save(self, archive: Archive, path: str) -> None:
        native.save_ictb(path, archive)
