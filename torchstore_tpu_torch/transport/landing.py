"""The landing copies of the shared-memory rung, and the arena layout.

Port of ``torchstore_tpu/transport/landing.py``: the arena layout (with
the scale-slot mode of the quantized wire tier and the fused quant-blob
layout), the landing copies and the landing pool. A put copies
every payload into its segment, and a get with destinations copies every
part out of one; ``land_async`` runs such a batch without blocking the
event loop:

- host-to-host copies go to a bounded thread pool (``Tensor.copy_``
  releases the GIL), large ones split into row blocks so one tensor
  pipelines across the threads, small ones grouped so a batch of many
  small keys costs a handful of submissions;
- a copy with a CUDA end is issued ``non_blocking`` on the card's side
  stream (``pinning.side_stream``), which first waits for the work queued
  on the caller's stream, and is waited on before ``land_async`` returns:
  the caller releases its read lease only after that. From page-locked
  memory the copy runs at the DMA rate; from pageable memory the issuing
  pool thread blocks instead of the event loop.
"""

from __future__ import annotations

import asyncio
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import torch

from torchstore_tpu_torch.config import StoreConfig, default_config
from torchstore_tpu_torch.transport.pinning import side_stream

# Row-block size that splits one large host copy across the pool threads.
CHUNK_BYTES = 32 << 20

# Arena members start on a cache-line boundary (enough for any dtype).
ARENA_ALIGN = 64

_exec: Optional[ThreadPoolExecutor] = None
_exec_threads = 0
_exec_lock = threading.Lock()


def configured_threads(config: Optional[StoreConfig] = None) -> int:
    n = (config or default_config()).landing_threads
    if n > 0:
        return n
    return max(1, min(4, os.cpu_count() or 1))


def get_executor(config: Optional[StoreConfig] = None) -> ThreadPoolExecutor:
    """The process's landing pool, made on first use and rebuilt only when a
    config asks for more threads than it has."""
    global _exec, _exec_threads
    want = configured_threads(config)
    with _exec_lock:
        if _exec is None or want > _exec_threads:
            old = _exec
            _exec = ThreadPoolExecutor(max_workers=want, thread_name_prefix="tst-landing")
            _exec_threads = want
            if old is not None:
                old.shutdown(wait=False)
        return _exec


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _chunk_pairs(dst: torch.Tensor, src: torch.Tensor) -> list[tuple]:
    """One large contiguous same-dtype copy as row blocks of at most
    ``CHUNK_BYTES``; any other pair unsplit."""
    if (
        _nbytes(dst) <= CHUNK_BYTES
        or dst.dtype != src.dtype
        or dst.shape != src.shape
        or not dst.is_contiguous()
        or not src.is_contiguous()
    ):
        return [(dst, src)]
    flat_d, flat_s = dst.reshape(-1), src.reshape(-1)
    step = max(1, CHUNK_BYTES // dst.element_size())
    return [
        (flat_d[off : off + step], flat_s[off : off + step])
        for off in range(0, flat_d.numel(), step)
    ]


def _copy_group(group: list[tuple]) -> None:
    for dst, src in group:
        dst.copy_(src)


def _plan_tasks(pairs: list[tuple], threads: int) -> list[list[tuple]]:
    """A host landing batch as at most about 2 x ``threads`` pool tasks:
    each row block of a large pair is a task, and the other pairs are
    grouped into runs of about equal bytes."""
    tasks: list[list[tuple]] = []
    small: list[tuple] = []
    small_bytes = 0
    for dst, src in pairs:
        if _nbytes(dst) > CHUNK_BYTES:
            tasks.extend([pair] for pair in _chunk_pairs(dst, src))
        else:
            small.append((dst, src))
            small_bytes += _nbytes(dst)
    if small:
        target = max(1, -(-small_bytes // max(1, threads)))
        group: list[tuple] = []
        acc = 0
        for pair in small:
            group.append(pair)
            acc += _nbytes(pair[0])
            if acc >= target:
                tasks.append(group)
                group, acc = [], 0
        if group:
            tasks.append(group)
    return tasks


def _card(dst: torch.Tensor, src: torch.Tensor) -> Optional[torch.device]:
    if dst.is_cuda:
        return dst.device
    if src.is_cuda:
        return src.device
    return None


def _copy_on_card(device: torch.device, ready: "torch.cuda.Event", group: list[tuple]) -> None:
    """Issue ``group``'s copies on ``device``'s side stream after ``ready``
    and wait for them."""
    stream = side_stream(device)
    stream.wait_event(ready)
    with torch.cuda.stream(stream):
        for dst, src in group:
            dst.copy_(src, non_blocking=True)
    stream.synchronize()


async def land_async(pairs: list[tuple], config: Optional[StoreConfig] = None) -> None:
    """Land every (dst, src) pair; returns once every copy is complete.
    Shapes must match (``Tensor.copy_`` would broadcast)."""
    pairs = [(d, s) for d, s in pairs if d.numel()]
    for dst, src in pairs:
        if dst.shape != src.shape:
            raise ValueError(
                f"destination shape {tuple(dst.shape)} != fetched {tuple(src.shape)}"
            )
    if not pairs:
        return
    host: list[tuple] = []
    by_card: dict[torch.device, list[tuple]] = {}
    for dst, src in pairs:
        card = _card(dst, src)
        if card is None:
            host.append((dst, src))
        else:
            by_card.setdefault(card, []).append((dst, src))
    loop = asyncio.get_running_loop()
    pool = get_executor(config)
    jobs = []
    for card, group in by_card.items():
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(card))
        jobs.append(loop.run_in_executor(pool, _copy_on_card, card, ready, group))
    tasks = _plan_tasks(host, configured_threads(config))
    if len(tasks) == 1 and not jobs and sum(_nbytes(d) for d, _ in host) <= (256 << 10):
        _copy_group(tasks[0])  # the submission would cost more than the copy
        return
    jobs.extend(loop.run_in_executor(pool, _copy_group, group) for group in tasks)
    for result in await asyncio.gather(*jobs, return_exceptions=True):
        if isinstance(result, BaseException):
            raise result


async def run_in_pool(fn, *args, config: Optional[StoreConfig] = None):
    """Run one CPU-bound callable on the landing pool (torch's CPU kernels
    release the GIL, so several run at once beside the event loop)."""
    loop = asyncio.get_running_loop()
    return await loop.run_in_executor(get_executor(config), fn, *args)


def align_up(n: int, align: int = ARENA_ALIGN) -> int:
    return (n + align - 1) // align * align


# A scale table is f32: its slot after a payload needs 4-byte alignment only.
SCALE_ALIGN = 4


def compute_arena_layout(sizes: list[int], scale_sizes: Optional[list[int]] = None):
    """Offsets and total size for ``sizes`` byte payloads packed back to
    back at ``ARENA_ALIGN`` boundaries: ``(offsets, total)``. With
    ``scale_sizes`` (the quantized wire tier) member ``i`` also has a scale
    slot of ``scale_sizes[i]`` bytes right after its payload, at a
    ``SCALE_ALIGN`` boundary, so the scales share the payload's segment:
    ``(offsets, scale_offsets, total)``."""
    offsets: list[int] = []
    scale_offsets: list[int] = []
    off = 0
    for i, nbytes in enumerate(sizes):
        offsets.append(off)
        end = off + int(nbytes)
        if scale_sizes is not None:
            s_off = align_up(end, SCALE_ALIGN)
            scale_offsets.append(s_off)
            end = s_off + int(scale_sizes[i])
        off = align_up(end)
    total = max(off, 1)
    if scale_sizes is not None:
        return offsets, scale_offsets, total
    return offsets, total


# --------------------------------------------------------------------------
# the fused quant blob: [header + shape | changed-block bitmap | packed codes
# | f32 scale table], one uint8 tensor per quantized leaf
# --------------------------------------------------------------------------

QUANT_HEADER_BYTES = 64


def quant_payload_nbytes(fmt: str, block: int, changed: int) -> int:
    """Packed-code bytes of ``changed`` blocks of ``block`` elements: one
    byte an element, or two 4-bit codes a byte for int4_block (an odd block
    takes a padding nibble)."""
    if fmt == "int4_block":
        return changed * ((block + 1) // 2)
    return changed * block


def quant_blob_layout(rank: int, nblocks: int, changed: int, fmt: str, block: int) -> dict:
    """Section offsets and total size of one fused quant blob; the scale
    table takes the payload's scale slot."""
    head = QUANT_HEADER_BYTES + 8 * rank
    bitmap = (nblocks + 7) // 8
    offsets, scale_offsets, total = compute_arena_layout(
        [head, bitmap, quant_payload_nbytes(fmt, block, changed)],
        scale_sizes=[0, 0, 4 * changed],
    )
    return {"header": offsets[0], "bitmap": offsets[1], "payload": offsets[2],
            "scales": scale_offsets[2], "total": total}


def quant_wire_nbytes(fmt: str, block: int, nelems: int, rank: int) -> int:
    """Size of the full keyframe blob of an ``nelems``-element tensor of
    ``rank`` dimensions."""
    nblocks = max(1, -(-int(nelems) // max(1, block)))
    return quant_blob_layout(rank, nblocks, nblocks, fmt, block)["total"]
