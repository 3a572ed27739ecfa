"""The host copies of the data path, in C++ bound with ctypes.

Port of ``torchstore_tpu/native.py`` on torch CPU tensors. The port keeps
its own copy of the library's source (``csrc/host_copy.cc``) and builds it
with ``g++`` into ``_build/`` at first use, named by the hash of the source
and the flags, as the CUDA kernels are (``ops/_nvcc.py``); nothing is built
or loaded at import. The entry points take ``Tensor.data_ptr()`` addresses:
a multi-threaded memcpy (``fast_copy``, ``copy_into``), a strided row-block
copy (``fast_copy_2d``), a multi-threaded page prefault of fresh buffers
(``prefault``) and a batched scatter memcpy (``copy_batch``).

Gated per process by ``TORCHSTORE_TORCH_USE_NATIVE`` (on by default; the
volumes a process spawns inherit it), read at each call. With the gate on, a failed build or load raises: nothing drops
to ``Tensor.copy_`` unnoticed. Turning the gate off is the only way to the
torch copies. Every native call adds one to ``ts_native_calls_total``
under its entry point.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import torch

from torchstore_tpu_torch.config import ENV_USE_NATIVE, _env_bool
from torchstore_tpu_torch.observability import metrics as obs_metrics

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "host_copy.cc"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
BUILD_TIMEOUT_S = 120

# Below this size the ctypes call costs more than the threads win.
PARALLEL_THRESHOLD = 8 * 1024 * 1024

_CALLS = obs_metrics.counter(
    "ts_native_calls_total", "Native host-copy calls, by entry point"
)

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


class NativeLibraryError(RuntimeError):
    """The native library did not build or load while the gate is on."""


def _compiler() -> str:
    found = shutil.which(os.environ.get("CXX", "g++"))
    if found is None:
        raise NativeLibraryError("no C++ compiler (g++) to build the native host copies")
    return found


def lib_path() -> Path:
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libtst_host_copy_{tag[:16]}.so"


def _build(path: Path) -> None:
    """Compile the source into ``path`` under a file lock, so processes
    starting together build it once and none loads a half-written file."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".host_copy.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            return
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
        except (OSError, subprocess.SubprocessError) as exc:
            raise NativeLibraryError(f"building {SOURCE.name} failed: {exc}") from exc
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeLibraryError(
                f"g++ failed ({proc.returncode}) building {SOURCE}:\n{proc.stderr}"
            )
        os.replace(tmp, path)


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    u64, vp, cint = ctypes.c_uint64, ctypes.c_void_p, ctypes.c_int
    lib.ts_parallel_memcpy.argtypes = [vp, vp, u64, cint]
    lib.ts_parallel_memcpy.restype = None
    lib.ts_copy_2d.argtypes = [vp, u64, vp, u64, u64, u64, cint]
    lib.ts_copy_2d.restype = None
    lib.ts_prefault.argtypes = [vp, u64, cint]
    lib.ts_prefault.restype = cint
    lib.ts_copy_batch.argtypes = [vp, vp, vp, u64, cint]
    lib.ts_copy_batch.restype = None
    lib.ts_version.restype = ctypes.c_uint32
    version = lib.ts_version()
    if version != 3:
        raise NativeLibraryError(f"native host copies: version {version}, expected 3")
    return lib


def enabled() -> bool:
    return _env_bool(ENV_USE_NATIVE, True)


def get_lib() -> Optional[ctypes.CDLL]:
    """The bound library, built at first use; None when the gate is off.
    Raises ``NativeLibraryError`` when the gate is on and it cannot be built
    or loaded."""
    global _lib
    if not enabled():
        return None
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path = lib_path()
            if not path.exists():
                _build(path)
            try:
                _lib = _bind(path)
            except OSError as exc:
                raise NativeLibraryError(f"loading {path} failed: {exc}") from exc
    return _lib


def available() -> bool:
    return get_lib() is not None


def reset() -> None:
    """Forget the loaded library (the next call builds or loads again)."""
    global _lib
    with _lock:
        _lib = None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _host(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check_shapes(dst: torch.Tensor, src: torch.Tensor) -> None:
    # A landing copy never broadcasts: a broadcast would paper over a stale
    # location (a same-key shape change) with wrong data.
    if tuple(dst.shape) != tuple(src.shape):
        raise ValueError(
            f"landing-copy shape mismatch: dst {tuple(dst.shape)} vs src {tuple(src.shape)}"
        )


def fast_copy(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)`` with a multi-threaded native memcpy for large
    contiguous same-dtype host copies. Shapes must match exactly."""
    _check_shapes(dst, src)
    lib = get_lib()
    if (
        lib is not None
        and dst.dtype == src.dtype
        and _host(dst, src)
        and _nbytes(dst) >= PARALLEL_THRESHOLD
        and dst.is_contiguous()
        and src.is_contiguous()
    ):
        _CALLS.inc(op="parallel_memcpy")
        lib.ts_parallel_memcpy(dst.data_ptr(), src.data_ptr(), _nbytes(dst), 0)
        return
    dst.copy_(src)


def copy_into(dst: torch.Tensor, src: torch.Tensor) -> None:
    """The best copy for a landing: the contiguous native memcpy, then the
    native strided row-block copy, then ``Tensor.copy_``. Never
    broadcasts."""
    _check_shapes(dst, src)
    if dst.dtype == src.dtype and dst.is_contiguous() and src.is_contiguous():
        fast_copy(dst, src)
        return
    if fast_copy_2d(dst, src):
        return
    dst.copy_(src)


def _row_pitch(t: torch.Tensor) -> Optional[int]:
    """Bytes between rows of a 2D tensor whose rows are contiguous (None
    otherwise); a tensor of one row has any pitch, so its row bytes."""
    if t.stride(1) != 1 and t.shape[1] > 1:
        return None
    if t.shape[0] <= 1:
        return t.shape[1] * t.element_size()
    return t.stride(0) * t.element_size()


def fast_copy_2d(dst: torch.Tensor, src: torch.Tensor) -> bool:
    """Row-block strided copy of 2D host tensors of the same shape and
    dtype whose rows are contiguous; False when that does not apply (the
    caller copies otherwise)."""
    lib = get_lib()
    if (
        lib is None
        or dst.ndim != 2
        or tuple(src.shape) != tuple(dst.shape)
        or dst.dtype != src.dtype
        or not _host(dst, src)
        or _nbytes(dst) < PARALLEL_THRESHOLD
    ):
        return False
    dst_pitch, src_pitch = _row_pitch(dst), _row_pitch(src)
    if dst_pitch is None or src_pitch is None:
        return False
    _CALLS.inc(op="copy_2d")
    lib.ts_copy_2d(dst.data_ptr(), dst_pitch, src.data_ptr(), src_pitch,
                   dst.shape[1] * dst.element_size(), dst.shape[0], 0)
    return True


def copy_batch(
    dst_addrs: Sequence[int], src_addrs: Sequence[int], lens: Sequence[int], nthreads: int = 0
) -> bool:
    """Batched scatter memcpy: one GIL-free call lands ``len(lens)``
    independent (dst, src, len) copies, byte-balanced across threads. The
    caller owns eligibility: host memory, both sides contiguous, no
    overlap. False when the gate is off (the caller copies itself)."""
    lib = get_lib()
    if lib is None:
        return False
    n = len(lens)
    if n == 0:
        return True
    arrays = [torch.tensor([int(a) for a in seq], dtype=torch.int64)
              for seq in (dst_addrs, src_addrs, lens)]
    _CALLS.inc(op="copy_batch")
    lib.ts_copy_batch(*(a.data_ptr() for a in arrays), n, nthreads)
    return True


def prefault(addr: int, length: int, nthreads: int = 0) -> bool:
    """Multi-threaded prefault of ``length`` bytes at ``addr`` (one write per
    page; ``nthreads`` 0 picks by size). False when the gate is off (the
    caller touches the pages itself or not at all)."""
    lib = get_lib()
    if lib is None:
        return False
    if length <= 0:
        return True
    _CALLS.inc(op="prefault")
    lib.ts_prefault(addr, length, nthreads)
    return True
