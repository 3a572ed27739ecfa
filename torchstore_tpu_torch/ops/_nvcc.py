"""Build and load of the hand-written CUDA kernels.

Each kernel source under ``csrc/`` is compiled with ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface and bound
with ``ctypes``. The library lands in ``_build/`` (git-ignored), named by
the hash of the source and the flags, at first use; nothing is compiled or
loaded when a module is imported. ``build_all`` starts several builds at
once, one ``nvcc`` per source.
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
from typing import Optional, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# ``-Xptxas -v`` puts registers, shared memory and spills in the build log.
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


class NvccLibrary:
    """One ``csrc/`` source built into a shared library, and its C entry
    point ``symbol`` with the given ``argtypes`` (return type ``int``: the
    CUDA error of the launch, 0 on success)."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence) -> None:
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.build_seconds: Optional[float] = None
        self.build_log = ""
        self.fn = None
        self._lock = threading.Lock()
        self._proc: Optional[subprocess.Popen] = None

    def _lib_path(self) -> Path:
        src = self.source.read_bytes()
        tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return BUILD_DIR / f"libtst_{self.source.stem}_{tag[:16]}.so"

    def start(self) -> None:
        """Start ``nvcc`` in the background unless the library is built."""
        with self._lock:
            if self.fn is not None or self._proc is not None:
                return
            lib_path = self._lib_path()
            self._t0 = time.perf_counter()
            if lib_path.exists():
                return
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            self._tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(self._tmp), str(self.source)]
            self._proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )

    def build(self) -> None:
        """Finish the build (starting it if needed) and load the library."""
        self.start()
        with self._lock:
            if self.fn is not None:
                return
            lib_path = self._lib_path()
            if self._proc is not None:
                out, _ = self._proc.communicate()
                self.build_log = out
                rc = self._proc.returncode
                self._proc = None
                if rc != 0:
                    raise RuntimeError(f"nvcc failed ({rc}) building {self.source}:\n{out}")
                os.replace(self._tmp, lib_path)  # concurrent builds: the last rename wins
            self.build_seconds = time.perf_counter() - self._t0
            fn = getattr(ctypes.CDLL(str(lib_path)), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self.fn = fn


def build_all(libraries: Sequence[NvccLibrary]) -> None:
    """Build several libraries at once: every ``nvcc`` starts before the
    first is waited for."""
    for lib in libraries:
        lib.start()
    for lib in libraries:
        lib.build()
