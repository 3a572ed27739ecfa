"""StateDictManifest: the shape of a working set, without its bytes.

Port of ``torchstore_tpu/provision/manifest.py``. A manifest describes
what a ``put_state_dict`` will put through the store: per flat key the
shape, the dtype and the payload size of every put request the leaf
becomes, and the total. It is read from metadata only (no copy off a card,
no materialization), so it can come from a live state dict, from tensors
on the ``meta`` device, or be built by hand from a model config before any
weights exist. It is the planner's input (``provision/planner.py``) and
what ``prewarm`` takes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from torchstore_tpu_torch import sharding
from torchstore_tpu_torch.transport import landing
from torchstore_tpu_torch.transport.types import dtype_name


@dataclass(frozen=True)
class ManifestEntry:
    """One flat state-dict leaf as the data plane sees it: the key, its
    shape and dtype name, and the payload size of each put request it
    becomes (one per local shard of a DTensor or ``Shard``, one
    otherwise)."""

    key: str
    shape: tuple[int, ...]
    dtype: str
    # Bytes of each put request's payload, in the transfer dtype.
    request_nbytes: tuple[int, ...]

    @property
    def nbytes(self) -> int:
        return sum(self.request_nbytes)


@dataclass
class StateDictManifest:
    """Keys, shapes, dtypes, request sizes and total bytes of a working set:
    what the planner needs to size pools and dials before the first byte
    moves."""

    entries: list[ManifestEntry] = field(default_factory=list)
    # True when any tensor leaf lives on a card: the device engine is worth
    # making ready too.
    device_resident: bool = False
    # Flat keys in the source dict's insertion order (a model's forward
    # order, the order streamed acquires consume layers in); ``entries``
    # stays sorted by name for stable planning.
    order: tuple = ()

    @property
    def total_bytes(self) -> int:
        return sum(e.nbytes for e in self.entries)

    @property
    def key_order(self) -> list[str]:
        """Tensor-leaf flat keys in insertion order: the ``key_order`` of a
        streamed acquire."""
        if self.order:
            named = {e.key for e in self.entries}
            return [k for k in self.order if k in named]
        return [e.key for e in self.entries]

    def segment_sizes(self, arena_max_bytes: int = 0) -> dict[int, int]:
        """``{segment size: count}`` over every put request: the pool the
        shared-memory put handshake asks the volume for (size-exact
        segments; an empty tensor takes the 1-byte minimum). With
        ``arena_max_bytes`` > 0 the requests at or under it are packed as
        the transport's small-key arena packs them
        (``landing.compute_arena_layout``): one arena-sized segment."""
        sizes: dict[int, int] = {}
        small: list[int] = []
        for entry in self.entries:
            for nbytes in entry.request_nbytes:
                if 0 < arena_max_bytes and int(nbytes) <= arena_max_bytes:
                    small.append(int(nbytes))
                    continue
                size = max(int(nbytes), 1)
                sizes[size] = sizes.get(size, 0) + 1
        if len(small) >= 2:
            _, total = landing.compute_arena_layout(small)
            sizes[total] = sizes.get(total, 0) + 1
        elif small:
            size = max(small[0], 1)
            sizes[size] = sizes.get(size, 0) + 1
        return sizes

    def arena_hint(self, arena_max_bytes: int) -> Optional[dict]:
        """The shared-memory rung's arena layout of this manifest's small
        requests (``segment_sizes`` provisions its total as one segment), or
        None when nothing packs."""
        if arena_max_bytes <= 0:
            return None
        small = [
            int(n) for entry in self.entries for n in entry.request_nbytes
            if int(n) <= arena_max_bytes
        ]
        if len(small) < 2:
            return None
        offsets, total = landing.compute_arena_layout(small)
        return {"sizes": tuple(small), "offsets": offsets, "total": total}

    def max_request_nbytes(self) -> int:
        return max((n for e in self.entries for n in e.request_nbytes), default=0)

    @classmethod
    def from_state_dict(
        cls,
        state_dict: Any,
        transfer_dtype: Optional[torch.dtype] = None,
        transfer_quant: Optional[str] = None,
        quant_block: int = 256,
    ) -> "StateDictManifest":
        """A manifest of a (nested) state dict, moving no bytes. Tensors,
        DTensors and ``Shard`` leaves become entries; other leaves ride the
        RPC codec and need no provisioning. ``transfer_dtype`` weighs
        floating leaves in it; ``transfer_quant`` weighs them as the fused
        quant blobs a quantized publish puts (``landing.quant_wire_nbytes``,
        scale slot included)."""
        from torchstore_tpu_torch.state_dict_utils import flatten_state_dict

        if transfer_quant in (None, "none", ""):
            transfer_quant = None
        flat, _ = flatten_state_dict(state_dict)
        entries: list[ManifestEntry] = []
        device = False
        for key, value in sorted(flat.items()):
            entry, on_card = _entry_of(key, value, transfer_dtype, transfer_quant, quant_block)
            if entry is not None:
                entries.append(entry)
                device = device or on_card
        return cls(entries=entries, device_resident=device, order=tuple(flat))


def _is_floating_name(name: str) -> bool:
    dtype = getattr(torch, name, None)
    return isinstance(dtype, torch.dtype) and dtype.is_floating_point


def _itemsize(name: str, transfer_dtype: Optional[torch.dtype]) -> int:
    """Bytes an element of dtype ``name`` takes on the wire: floating
    leaves in ``transfer_dtype`` when given, others as they are (as
    ``cast_floating_tensors`` casts)."""
    if transfer_dtype is not None and _is_floating_name(name):
        return transfer_dtype.itemsize
    dtype = getattr(torch, name, None)
    return dtype.itemsize if isinstance(dtype, torch.dtype) else 4


def _entry_of(
    key: str,
    value: Any,
    transfer_dtype: Optional[torch.dtype],
    transfer_quant: Optional[str] = None,
    quant_block: int = 256,
) -> tuple[Optional[ManifestEntry], bool]:
    """(entry, on a card) of one flat leaf; (None, False) for a leaf that
    is not a tensor."""
    from torchstore_tpu_torch.client import Shard

    if transfer_quant is not None:
        entry, on_card = _entry_of(key, value, None)
        if entry is not None and _is_floating_name(entry.dtype):
            # One fused blob a leaf, whatever its sharding.
            nelems = math.prod(entry.shape) if entry.shape else 1
            block = quant_block if transfer_quant != "int8" else max(1, nelems)
            nbytes = landing.quant_wire_nbytes(transfer_quant, block, nelems, len(entry.shape))
            return ManifestEntry(key, entry.shape, entry.dtype, (nbytes,)), on_card
        return entry, on_card
    if isinstance(value, Shard):
        shape = tuple(int(s) for s in value.tensor_slice.local_shape)
        data = value.data
        name = dtype_name(data.dtype) if data is not None else "float32"
        nbytes = math.prod(shape) * _itemsize(name, transfer_dtype)
        return ManifestEntry(key, shape, name, (nbytes,)), bool(data is not None and data.is_cuda)
    if sharding.is_dtensor(value):
        shape = tuple(int(s) for s in value.shape)
        local = sharding.local_tensor(value)
        name = dtype_name(local.dtype)
        nbytes = local.numel() * _itemsize(name, transfer_dtype)
        return ManifestEntry(key, shape, name, (nbytes,)), local.is_cuda
    if isinstance(value, torch.Tensor):
        shape = tuple(int(s) for s in value.shape)
        name = dtype_name(value.dtype)
        nbytes = value.numel() * _itemsize(name, transfer_dtype)
        return ManifestEntry(key, shape, name, (nbytes,)), value.is_cuda
    return None, False
