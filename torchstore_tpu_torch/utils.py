"""Reshard math and small helpers.

PyTorch port of ``torchstore_tpu/utils.py``: ``Box`` regions of a global
index space, their intersection, coverage and bounding box, destination
views into torch tensors for in-place landings, the assembly of fetched
parts into one tensor, the host identity, a free port, and the
fire-and-forget task helper. Tensors may live on the CPU or a CUDA device.
"""

from __future__ import annotations

import asyncio
import inspect
import logging
import math
import os
import socket
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from torchstore_tpu_torch.observability import metrics as obs_metrics

ENV_HOSTNAME = "TORCHSTORE_TORCH_HOSTNAME"

_BG_ERRORS = obs_metrics.counter(
    "ts_background_task_errors_total", "Fire-and-forget tasks that failed, by task name"
)


@dataclass(frozen=True)
class Box:
    """An axis-aligned region of a global index space: ``offsets`` + ``shape``."""

    offsets: tuple[int, ...]
    shape: tuple[int, ...]

    def __post_init__(self) -> None:
        if len(self.offsets) != len(self.shape):
            raise ValueError(
                f"rank mismatch: offsets={self.offsets} shape={self.shape}"
            )

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape) if self.shape else 1

    def to_index(self) -> tuple[slice, ...]:
        """The box as an index into a tensor of the global space."""
        return tuple(slice(o, o + s) for o, s in zip(self.offsets, self.shape))

    def contains(self, other: "Box") -> bool:
        return all(
            oo >= so and oo + osz <= so + ssz
            for so, ssz, oo, osz in zip(
                self.offsets, self.shape, other.offsets, other.shape
            )
        )


def intersect_boxes(a: Box, b: Box) -> Optional[Box]:
    """Per-dimension interval intersection; None when disjoint."""
    if a.ndim != b.ndim:
        raise ValueError(f"rank mismatch: {a} vs {b}")
    offsets = []
    shape = []
    for ao, asz, bo, bsz in zip(a.offsets, a.shape, b.offsets, b.shape):
        start = max(ao, bo)
        stop = min(ao + asz, bo + bsz)
        if stop <= start:
            return None
        offsets.append(start)
        shape.append(stop - start)
    return Box(tuple(offsets), tuple(shape))


def subtract_box(base: Box, cut: Box) -> list[Box]:
    """``base`` minus ``cut``: disjoint boxes covering every element of
    ``base`` outside ``cut``."""
    inter = intersect_boxes(base, cut)
    if inter is None:
        return [base]
    out: list[Box] = []
    cur_off = list(base.offsets)
    cur_shape = list(base.shape)
    for d in range(base.ndim):
        lo, hi = cur_off[d], cur_off[d] + cur_shape[d]
        ilo = inter.offsets[d]
        ihi = ilo + inter.shape[d]
        if ilo > lo:
            shp = list(cur_shape)
            shp[d] = ilo - lo
            out.append(Box(tuple(cur_off), tuple(shp)))
        if ihi < hi:
            off = list(cur_off)
            shp = list(cur_shape)
            off[d] = ihi
            shp[d] = hi - ihi
            out.append(Box(tuple(off), tuple(shp)))
        cur_off[d], cur_shape[d] = ilo, ihi - ilo
    return out


def boxes_cover(region: Box, covers: list[Box]) -> bool:
    """True iff the union of ``covers`` contains every element of
    ``region`` (overlaps and duplicates are fine)."""
    remaining = [region]
    for cut in covers:
        if not remaining:
            return True
        remaining = [r for base in remaining for r in subtract_box(base, cut)]
    return not remaining


def get_destination_view(
    dest: torch.Tensor,
    dest_box: Box,
    region: Box,
    require_contiguous: bool = True,
) -> Optional[torch.Tensor]:
    """View into ``dest`` (which occupies ``dest_box`` of the global space)
    covering global ``region``; None when ``dest_box`` does not contain it,
    or when the view is not contiguous and ``require_contiguous`` is set.
    Works for CPU and CUDA tensors alike."""
    if not dest_box.contains(region):
        return None
    rel = tuple(ro - do for ro, do in zip(region.offsets, dest_box.offsets))
    index = tuple(slice(r, r + s) for r, s in zip(rel, region.shape))
    view = dest[index]
    if require_contiguous and view.numel() > 1 and not view.is_contiguous():
        return None
    return view


def to_byte_view(t: torch.Tensor) -> torch.Tensor:
    """Flat uint8 view over a contiguous tensor's bytes."""
    if not t.is_contiguous():
        raise ValueError("to_byte_view requires a contiguous tensor")
    return t.reshape(-1).view(torch.uint8)


def byte_range(t: torch.Tensor) -> tuple[int, int]:
    """[lo, hi) byte addresses ``t`` touches on its device."""
    start = t.data_ptr()
    if t.numel() == 0:
        return (start, start)
    lo = hi = start
    for size, stride in zip(t.shape, t.stride()):
        extent = (size - 1) * stride * t.element_size()
        if extent > 0:
            hi += extent
        else:
            lo += extent
    return (lo, hi + t.element_size())


def tensors_overlap_in_memory(dest: torch.Tensor, parts: Sequence[torch.Tensor]) -> bool:
    """True when every non-empty part lies inside ``dest``'s memory on
    ``dest``'s device: all parts already landed in place and no assembly
    copy is needed."""
    if dest.numel() == 0:
        return False
    d0, d1 = byte_range(dest)
    for p in parts:
        if p.numel() == 0:
            continue
        p0, p1 = byte_range(p)
        if p.device != dest.device or p0 < d0 or p1 > d1:
            return False
    return True


def bounding_box(boxes: Sequence[Box]) -> Box:
    if not boxes:
        raise ValueError("bounding_box of no boxes")
    ndim = boxes[0].ndim
    mins = [min(b.offsets[d] for b in boxes) for d in range(ndim)]
    maxs = [max(b.offsets[d] + b.shape[d] for b in boxes) for d in range(ndim)]
    return Box(tuple(mins), tuple(m - n for m, n in zip(maxs, mins)))


def assemble_tensor(
    parts: Sequence[tuple[torch.Tensor, tuple[int, ...]]],
) -> tuple[torch.Tensor, tuple[int, ...]]:
    """Assemble fetched parts, each with its global offsets, into one tensor
    on the first part's device. Returns ``(tensor, offsets)``, ``offsets``
    being the global offset of the assembled bounding box; raises when the
    parts leave a hole in it."""
    if not parts:
        raise ValueError("assemble_tensor of no parts")
    first = parts[0][0]
    for p, _ in parts:
        if p.dtype != first.dtype:
            raise ValueError(f"dtype mismatch during assembly: {p.dtype} vs {first.dtype}")
        if p.ndim != first.ndim:
            raise ValueError("rank mismatch during assembly")
    boxes = [Box(tuple(off), tuple(p.shape)) for p, off in parts]
    bbox = bounding_box(boxes)
    if len(parts) == 1 and boxes[0] == bbox:
        return first, bbox.offsets
    out = torch.empty(bbox.shape, dtype=first.dtype, device=first.device)
    painted = torch.zeros(bbox.shape, dtype=torch.bool)
    for (p, _), box in zip(parts, boxes):
        rel = Box(tuple(o - bo for o, bo in zip(box.offsets, bbox.offsets)), box.shape)
        out[rel.to_index()] = p
        painted[rel.to_index()] = True
    holes = int((~painted).sum())
    if holes:
        raise ValueError(
            f"assembled parts leave {holes} of {bbox.size} elements uncovered; "
            "parts do not tile the requested region"
        )
    return out, bbox.offsets


async def maybe_await(value):
    """Await ``value`` when it is a coroutine, else return it."""
    if inspect.iscoroutine(value):
        return await value
    return value


def get_hostname() -> str:
    """The host identity every layer keys on (same-host transport choice,
    volume hostnames). ``TORCHSTORE_TORCH_HOSTNAME`` overrides it."""
    return os.environ.get(ENV_HOSTNAME) or socket.gethostname()


def get_free_port() -> int:
    """A TCP port on the loopback that was free when asked (another process
    may take it before the caller binds it)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_logged(
    coro, *, name: str, tasks: Optional[set] = None, log=None
) -> "asyncio.Future":
    """``asyncio.ensure_future`` that keeps the task in ``tasks`` until it
    is done, and logs and counts (``ts_background_task_errors_total``) its
    exception instead of letting it vanish. Cancellation is not an error."""
    task = asyncio.ensure_future(coro)
    if tasks is not None:
        tasks.add(task)

    def _done(t: "asyncio.Future") -> None:
        if tasks is not None:
            tasks.discard(t)
        if t.cancelled():
            return
        exc = t.exception()
        if exc is not None:
            _BG_ERRORS.inc(task=name)
            (log or logging.getLogger("torchstore_tpu_torch.tasks")).error(
                "background task %r failed: %r", name, exc, exc_info=exc
            )

    task.add_done_callback(_done)
    return task
