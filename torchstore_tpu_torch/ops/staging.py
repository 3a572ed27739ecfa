"""Device-side staging ops: the transfer-dtype cast.

The direct weight-sync source casts every floating leaf to the transfer
dtype on the card before the device-to-host copy, so that copy moves the
transfer dtype's bytes (half of fp32's for bf16). On a CUDA tensor
``device_cast`` launches the hand-written kernel in ``csrc/cast.cu`` (the
Hopper port of ``torchstore_tpu/ops/staging.py::pallas_cast``) or raises;
on a CPU tensor it takes the plain version, ``cast_reference``.

The kernel is built at first use by ``ops/_nvcc.py``; nothing is compiled
or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes

import torch

from torchstore_tpu_torch.ops._nvcc import NvccLibrary

# Kind codes shared with csrc/cast.cu.
_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_BAD_PAIR = -1

# The pairs the kernel covers.
PAIRS = (
    (torch.float32, torch.bfloat16),
    (torch.float32, torch.float16),
    (torch.bfloat16, torch.float32),
    (torch.float16, torch.float32),
    (torch.bfloat16, torch.float16),
    (torch.float16, torch.bfloat16),
)

# Pair -> (source kind, destination kind).
_PAIR_KINDS = {(src, dst): (_KINDS[src], _KINDS[dst]) for src, dst in PAIRS}


def cast_reference(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The plain version of the cast kernel: ``x.to(dtype)``."""
    return x.to(dtype)


class CastKernel:
    """The built cast library, its build log, and the launch count.

    ``launches`` grows by one per kernel launch and nowhere else; CPU
    tensors (the plain version) and empty tensors do not count."""

    def __init__(self) -> None:
        self.launches = 0
        self.lib = NvccLibrary(
            "cast.cu",
            "tst_cast",
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int64, ctypes.c_void_p],
        )

    def build(self) -> None:
        """Compile ``csrc/cast.cu`` (once per source content) and load it."""
        self.lib.build()

    def __call__(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        kinds = _PAIR_KINDS.get((x.dtype, dtype))
        if kinds is None:
            raise TypeError(
                f"cast kernel does not cover {x.dtype} -> {dtype}; covered: "
                f"{[(str(a), str(b)) for a, b in PAIRS]}"
            )
        if not x.is_cuda:
            raise ValueError("the cast kernel takes CUDA tensors")
        if not x.is_contiguous():
            raise ValueError(
                "cast kernel needs a contiguous input (pass x.contiguous())"
            )
        device = x.device
        out = torch.empty(x.shape, dtype=dtype, device=device)
        n = x.numel()
        if n == 0:
            return out
        if self.lib.fn is None:
            self.lib.build()
        # The launch goes to the current stream of x's device, which must
        # be the thread's current device; switch only when it is not.
        if device.index == torch.cuda.current_device():
            err = self._launch(x, kinds, out, n, device)
        else:
            with torch.cuda.device(device):
                err = self._launch(x, kinds, out, n, device)
        if err == _BAD_PAIR:
            raise TypeError(f"cast kernel refused {x.dtype} -> {dtype}")
        if err != 0:
            raise RuntimeError(f"cast kernel launch failed: CUDA error {err}")
        self.launches += 1
        return out

    def _launch(self, x, kinds, out, n, device) -> int:
        stream = torch.cuda.current_stream(device).cuda_stream
        return self.lib.fn(x.data_ptr(), kinds[0], out.data_ptr(), kinds[1], n, stream)


cast_kernel = CastKernel()


def device_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Cast ``x`` to ``dtype``: the CUDA kernel for a CUDA tensor (which
    raises on a pair it does not cover, a non-contiguous input or a failed
    build), the plain version for a CPU tensor."""
    if x.is_cuda:
        return cast_kernel(x, dtype)
    return cast_reference(x, dtype)
