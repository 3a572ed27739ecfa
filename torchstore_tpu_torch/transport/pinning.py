"""Page-locking of host memory and the one side stream per card.

Both legs of a weight sync copy between a card and ``/dev/shm`` mappings:
direct sync through its staging segments and attachments, the buffered
store through its cached segment attachments. A copy from page-locked
memory runs asynchronously at the DMA rate; ``cudaHostRegister`` locks an
existing mapping in place. Every copy of the process between host segments
and a card is issued on that card's one side stream, so the allocator
reuses the blocks freed on it.
"""

from __future__ import annotations

from typing import Optional

import torch

_side_streams: dict = {}


def host_register(t: torch.Tensor) -> Optional[int]:
    """Page-lock the host memory under ``t`` (a ``/dev/shm`` mapping or
    process memory) with ``cudaHostRegister``, so copies between it and a
    card run asynchronously at the DMA rate; returns the pointer to
    unregister, or None for an empty tensor."""
    nbytes = t.numel() * t.element_size()
    if nbytes == 0:
        return None
    err = torch.cuda.cudart().cudaHostRegister(t.data_ptr(), nbytes, 0)
    if int(err) != 0:
        raise RuntimeError(f"cudaHostRegister of {nbytes} bytes failed: CUDA error {int(err)}")
    return t.data_ptr()


def host_unregister(ptrs) -> None:
    """Unpin what ``host_register`` pinned; runs before the memory is
    unmapped or freed."""
    ptrs = list(ptrs)
    if ptrs:
        cudart = torch.cuda.cudart()
        for ptr in ptrs:
            cudart.cudaHostUnregister(ptr)


def side_stream(device: torch.device) -> "torch.cuda.Stream":
    """The process's side stream of ``device``, made on first use."""
    stream = _side_streams.get(device)
    if stream is None:
        stream = _side_streams[device] = torch.cuda.Stream(device=device)
    return stream


def reinit_after_fork() -> None:
    """A forked child keeps no stream of its parent (a forked process cannot
    use its parent's CUDA state): each is made again on first use."""
    _side_streams.clear()
