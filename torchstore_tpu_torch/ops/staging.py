"""Device-side staging ops: the transfer-dtype cast, grouped.

The weight-sync source casts every floating leaf to the transfer dtype on
the card before the device-to-host copy, so that copy moves the transfer
dtype's bytes (half of fp32's for bf16). ``cast_group`` casts a list of
tensors: the planner (``plan_chunks``) groups them by dtype pair and cuts
each group into chunks bounded by output bytes and by the kernel's table
size, and each chunk is one launch of the hand-written grouped kernel in
``csrc/cast.cu`` (the Hopper port of
``torchstore_tpu/ops/staging.py::pallas_cast``). ``device_cast`` is a group
of one. On CUDA tensors the wrappers launch the kernel or raise; on CPU
tensors they take the plain version, ``cast_group_reference``.

The kernel is built at first use by ``ops/_nvcc.py``; nothing is compiled
or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import struct
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import torch

from torchstore_tpu_torch.ops._nvcc import NvccLibrary

# Kind codes shared with csrc/cast.cu.
_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_BAD_PAIR = -1
_BAD_TABLE = -2

# Table layout shared with csrc/cast.cu (``Entry``, ``kUnitElems``,
# ``kMaxEntries``, ``kNoBody``): per entry the source and destination
# pointers, the element count, the entry's first work unit in the group and
# the elements before its 16-byte aligned body.
ENTRY = struct.Struct("<QQqII")
UNIT_ELEMS = 8192
MAX_ENTRIES = 1000
NO_BODY = 0xFFFFFFFF
_MAX_UNITS = (1 << 32) - 1

# Output bytes per chunk of a group.
DEFAULT_CHUNK_BYTES = 1 << 30

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
_ITEMSIZE = {dtype: torch.empty((), dtype=dtype).element_size() for dtype in _KINDS}


def cast_reference(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The plain version of the cast kernel on one tensor: ``x.to(dtype)``."""
    return x.to(dtype)


def cast_group_reference(tensors: Sequence[torch.Tensor], dtype: torch.dtype) -> list[torch.Tensor]:
    """The plain version of the grouped cast: ``[t.to(dtype) for t in tensors]``."""
    return [t.to(dtype) for t in tensors]


@dataclass(frozen=True)
class CastChunk:
    """One launch of the grouped kernel: the positions (in the caller's
    list) of tensors that share ``pair``, and their output bytes."""

    pair: tuple[torch.dtype, torch.dtype]
    indices: tuple[int, ...]
    out_bytes: int


def _check_pair(src: torch.dtype, dtype: torch.dtype) -> None:
    if (src, dtype) not in _PAIR_KINDS:
        raise TypeError(
            f"cast kernel does not cover {src} -> {dtype}; covered: "
            f"{[(str(a), str(b)) for a, b in PAIRS]}"
        )


def _iter_chunks(
    tensors: Sequence[torch.Tensor], dtype: torch.dtype, max_chunk_bytes: int
) -> Iterator[CastChunk]:
    """The launches that cast ``tensors`` to ``dtype``, each as soon as it is
    planned. Tensors are grouped by (source dtype, ``dtype``) and each group
    is cut, in the tensors' order, into chunks of at most ``max_chunk_bytes``
    of output and ``MAX_ENTRIES`` tensors (the kernel's table). A chunk comes out when the next
    tensor of its group would overflow it, so the first launch need not wait
    for the whole list to be planned; the chunks still open at the end come
    out in order of their group's first tensor. A tensor larger than the
    bound is a chunk of its own; empty tensors are in no chunk. Reads only
    dtypes and sizes."""
    if max_chunk_bytes < 1:
        raise ValueError(f"bad chunk bound: {max_chunk_bytes} bytes")
    out_size = _ITEMSIZE.get(dtype, 0)
    open_chunks: dict[torch.dtype, tuple[list[int], list[int]]] = {}  # src -> (indices, [bytes])
    for i, t in enumerate(tensors):
        cur = open_chunks.get(t.dtype)
        if cur is None:
            _check_pair(t.dtype, dtype)
            cur = open_chunks[t.dtype] = ([], [0])
        nbytes = t.numel() * out_size
        if not nbytes:
            continue
        indices, total = cur
        if indices and (total[0] + nbytes > max_chunk_bytes or len(indices) == MAX_ENTRIES):
            yield CastChunk((t.dtype, dtype), tuple(indices), total[0])
            indices.clear()
            total[0] = 0
        indices.append(i)
        total[0] += nbytes
    for src, (indices, total) in open_chunks.items():
        if indices:
            yield CastChunk((src, dtype), tuple(indices), total[0])


def plan_chunks(
    tensors: Sequence[torch.Tensor],
    dtype: torch.dtype,
    max_chunk_bytes: int = DEFAULT_CHUNK_BYTES,
) -> list[CastChunk]:
    """The launches of ``cast_group(tensors, dtype)``: every chunk of
    ``_iter_chunks``, in the order they launch."""
    return list(_iter_chunks(tensors, dtype, max_chunk_bytes))


def entry_head(src_ptr: int, dst_ptr: int, n: int, in_size: int, out_size: int) -> int:
    """Elements before the first one at which both pointers are 16-byte
    aligned (where the kernel's bulk body starts), or ``NO_BODY`` when no
    such element is among the ``n``: the entry then goes element by element."""
    for h in range(min(n, 8)):  # the alignment of ptr + h * size repeats every 8 elements
        if ((src_ptr + h * in_size) | (dst_ptr + h * out_size)) & 15 == 0:
            return h
    return NO_BODY


def entry_units(n: int, head: int) -> int:
    """Work units of an entry of ``n`` elements with this head: the elements
    after the head in units of ``UNIT_ELEMS`` (the first unit also takes the
    head), or all ``n`` when the entry has no aligned body."""
    rest = n if head == NO_BODY else n - head
    return -(-rest // UNIT_ELEMS)


def pack_table(entries: Sequence[tuple[int, int, int, int, int]]) -> tuple[bytes, int]:
    """The kernel's table for entries (src pointer, dst pointer, n, source
    element size, destination element size), and the group's unit count."""
    fields: list[int] = []
    first = 0
    for src_ptr, dst_ptr, n, in_size, out_size in entries:
        head = entry_head(src_ptr, dst_ptr, n, in_size, out_size)
        fields += (src_ptr, dst_ptr, n, first, head)
        first += entry_units(n, head)
    if first > _MAX_UNITS:
        raise ValueError(f"a chunk of {first} work units exceeds the kernel's {_MAX_UNITS}")
    return struct.pack("<" + "QQqII" * len(entries), *fields), first


class CastKernel:
    """The built cast library, its build log, and the launch count.

    ``launches`` grows by one per kernel launch (one per chunk) and nowhere
    else; CPU tensors (the plain version) and empty tensors do not count.
    ``fallbacks`` counts the CUDA tensors ``cast_on_card`` casts by ``x.to()``
    because the kernel does not cover their pair; they are not launches."""

    def __init__(self) -> None:
        self.launches = 0
        self.fallbacks = 0
        self.lib = NvccLibrary(
            "cast.cu",
            "tst_cast_group",
            [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
             ctypes.c_void_p],
        )

    def build(self) -> None:
        """Compile ``csrc/cast.cu`` (once per source content) and load it."""
        self.lib.build()

    def __call__(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """One tensor: a group of one."""
        return self.group([x], dtype)[0]

    def group(
        self,
        tensors: Sequence[torch.Tensor],
        dtype: torch.dtype,
        max_chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    ) -> list[torch.Tensor]:
        """Every tensor cast to ``dtype``, one launch per planned chunk; each
        output is a contiguous tensor of its own."""
        out: list = [None] * len(tensors)
        for chunk, outs in self.chunks(tensors, dtype, max_chunk_bytes):
            for i, y in zip(chunk.indices, outs):
                out[i] = y
        for i, t in enumerate(tensors):
            if out[i] is None:  # empty: no launch
                out[i] = torch.empty(t.shape, dtype=dtype, device=t.device)
        return out

    def chunks(
        self,
        tensors: Sequence[torch.Tensor],
        dtype: torch.dtype,
        max_chunk_bytes: int = DEFAULT_CHUNK_BYTES,
        outs: Optional[Sequence[torch.Tensor]] = None,
    ) -> Iterator[tuple[CastChunk, list[torch.Tensor]]]:
        """Launch the chunks of ``_iter_chunks`` one at a time, yielding each
        chunk with its outputs (in ``chunk.indices`` order) before the next
        launches, so a caller that drops them holds at most one chunk of
        outputs. With ``outs`` (one per tensor: contiguous, of the tensor's
        shape, in ``dtype``, on its device) the kernel writes into them
        instead of new tensors. A chunk's tensors are checked before its
        launch."""
        device = None
        for chunk in _iter_chunks(tensors, dtype, max_chunk_bytes):
            srcs = [tensors[i] for i in chunk.indices]
            for t in srcs:
                if not t.is_cuda:
                    raise ValueError("the cast kernel takes CUDA tensors")
                if device is None:
                    device = t.device
                elif t.device != device:
                    raise ValueError(f"one cast group takes one device: {device} and {t.device}")
                if not t.is_contiguous():
                    raise ValueError("cast kernel needs a contiguous input (pass x.contiguous())")
            if outs is None:
                dsts = [torch.empty_like(x, dtype=dtype) for x in srcs]  # contiguous, as x
            else:
                dsts = [outs[i] for i in chunk.indices]
                for x, y in zip(srcs, dsts):
                    if (y.device != x.device or y.dtype != dtype or y.shape != x.shape
                            or not y.is_contiguous()):
                        raise ValueError("a cast output must be contiguous, of its input's "
                                         "shape and device, in the target dtype")
            if self.lib.fn is None:
                self.lib.build()
            in_size, out_size = _ITEMSIZE[chunk.pair[0]], _ITEMSIZE[dtype]
            table, units = pack_table(
                [(x.data_ptr(), y.data_ptr(), x.numel(), in_size, out_size)
                 for x, y in zip(srcs, dsts)]
            )
            kinds = _PAIR_KINDS[chunk.pair]
            # The launch goes to the current stream of the tensors' device,
            # which must be the thread's current device; switch only when
            # it is not.
            if device.index == torch.cuda.current_device():
                err = self._launch(table, len(srcs), kinds, units, device)
            else:
                with torch.cuda.device(device):
                    err = self._launch(table, len(srcs), kinds, units, device)
            if err == _BAD_PAIR:
                raise TypeError(f"cast kernel refused {chunk.pair[0]} -> {dtype}")
            if err == _BAD_TABLE:
                raise ValueError(f"cast kernel refused a table of {len(srcs)} entries")
            if err != 0:
                raise RuntimeError(f"cast kernel launch failed: CUDA error {err}")
            self.launches += 1
            yield chunk, dsts

    def _launch(self, table, count, kinds, units, device) -> int:
        stream = torch.cuda.current_stream(device).cuda_stream
        return self.lib.fn(table, count, kinds[0], kinds[1], units, stream)


cast_kernel = CastKernel()


def device_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Cast ``x`` to ``dtype``: the CUDA kernel (a group of one) for a CUDA
    tensor, which raises on a pair it does not cover, a non-contiguous input
    or a failed build; the plain version for a CPU tensor."""
    if x.is_cuda:
        return cast_kernel(x, dtype)
    return cast_reference(x, dtype)


def cast_group(
    tensors: Sequence[torch.Tensor],
    dtype: torch.dtype,
    *,
    max_chunk_bytes: int = DEFAULT_CHUNK_BYTES,
) -> list[torch.Tensor]:
    """Cast every tensor to ``dtype``: contiguous CUDA tensors on one device
    through the grouped kernel, one launch per chunk of ``plan_chunks``
    (raising as ``CastKernel.chunks`` does); CPU tensors through the plain
    version."""
    if tensors and not any(t.is_cuda for t in tensors):
        return cast_group_reference(tensors, dtype)
    return cast_kernel.group(tensors, dtype, max_chunk_bytes)


def card_of(t: torch.Tensor) -> Optional[torch.device]:
    """The CUDA device ``t`` lives on, or None for a host tensor."""
    return t.device if t.is_cuda else None


def cast_on_card(
    tensors: Sequence[torch.Tensor],
    dtype: torch.dtype,
    max_chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    outs: Optional[Sequence[torch.Tensor]] = None,
) -> Iterator[tuple[tuple[int, ...], list[torch.Tensor]]]:
    """Cast contiguous CUDA tensors of one device to ``dtype``, yielding
    (positions in ``tensors``, outputs) a batch at a time: the pairs the
    kernel covers through ``cast_kernel.chunks`` (one launch per chunk, each
    chunk's outputs yielded before the next launches), any other pair by the
    plain ``x.to()``, counted in ``cast_kernel.fallbacks`` (the reference
    leaves such pairs to XLA's ``astype``). With ``outs`` (one per tensor,
    as ``CastKernel.chunks`` takes them) every cast lands in its out. A
    covered pair whose kernel fails to build or launch raises; it never
    takes the plain cast."""
    covered = []
    for i, t in enumerate(tensors):
        if (t.dtype, dtype) in _PAIR_KINDS:
            covered.append(i)
        else:
            cast_kernel.fallbacks += 1
            y = t.to(dtype)
            if outs is not None:
                y = outs[i].copy_(y)
            yield (i,), [y]
    srcs = [tensors[i] for i in covered]
    dsts = None if outs is None else [outs[i] for i in covered]
    for chunk, ys in cast_kernel.chunks(srcs, dtype, max_chunk_bytes, outs=dsts):
        yield tuple(covered[j] for j in chunk.indices), ys
