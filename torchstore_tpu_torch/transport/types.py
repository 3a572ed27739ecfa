"""Wire vocabulary: ``TensorMeta``, ``TensorSlice``, ``Request``.

PyTorch port of ``torchstore_tpu/transport/types.py``. Wire dtype names are
the reference's numpy names ("float32", "bfloat16", "int64", ...), so the
two packages describe the same tensor with the same strings.
"""

from __future__ import annotations

import math
import pickle
from dataclasses import dataclass, field, replace
from typing import Any, Optional

import torch

from torchstore_tpu_torch.utils import Box


def dtype_name(dtype: torch.dtype) -> str:
    """Wire name of a torch dtype: the reference's numpy dtype name."""
    return str(dtype).removeprefix("torch.")


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a wire name (inverse of ``dtype_name``)."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise TypeError(f"no torch dtype for wire name {name!r}")
    return dtype


@dataclass(frozen=True)
class TensorMeta:
    """Shape + dtype of a tensor payload; travels on meta-only requests so
    volumes and transports can allocate without the data."""

    shape: tuple[int, ...]
    dtype: str  # wire name, e.g. "float32", "bfloat16"

    @classmethod
    def of(cls, tensor: torch.Tensor) -> "TensorMeta":
        return cls(
            shape=tuple(int(s) for s in tensor.shape), dtype=dtype_name(tensor.dtype)
        )

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def itemsize(self) -> int:
        return torch.empty((), dtype=self.torch_dtype).element_size()

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.itemsize


@dataclass(frozen=True)
class TensorSlice:
    """One shard of a global tensor: ``offsets``/``local_shape`` place it in
    ``global_shape``; ``coordinates``/``mesh_shape`` locate it in the device
    mesh."""

    offsets: tuple[int, ...]
    local_shape: tuple[int, ...]
    global_shape: tuple[int, ...]
    coordinates: tuple[int, ...]
    mesh_shape: tuple[int, ...]

    def __post_init__(self) -> None:
        for name in ("offsets", "local_shape", "global_shape", "coordinates", "mesh_shape"):
            object.__setattr__(self, name, tuple(int(x) for x in getattr(self, name)))
        if len(self.offsets) != len(self.local_shape) or len(self.offsets) != len(
            self.global_shape
        ):
            raise ValueError(f"rank mismatch in {self!r}")

    @property
    def box(self) -> Box:
        return Box(self.offsets, self.local_shape)

    @property
    def nelements(self) -> int:
        return math.prod(self.local_shape) if self.local_shape else 1

    def is_full(self) -> bool:
        return self.local_shape == self.global_shape and all(
            o == 0 for o in self.offsets
        )

    def with_box(self, box: Box) -> "TensorSlice":
        """A slice describing ``box`` of the same global tensor, at the same
        mesh position."""
        return replace(self, offsets=box.offsets, local_shape=box.shape)


def full_slice(shape) -> TensorSlice:
    """The slice covering a whole unsharded tensor of ``shape``."""
    return TensorSlice(
        offsets=(0,) * len(shape),
        local_shape=tuple(shape),
        global_shape=tuple(shape),
        coordinates=(),
        mesh_shape=(),
    )


class OpaqueBlob:
    """Client-side pickled envelope for arbitrary object values: volumes and
    transports carry opaque bytes and never unpickle user types."""

    __slots__ = ("data",)

    def __init__(self, data: bytes) -> None:
        self.data = data

    @classmethod
    def wrap(cls, obj: Any) -> "OpaqueBlob":
        return cls(pickle.dumps(obj, protocol=5))

    def unwrap(self) -> Any:
        return pickle.loads(self.data)

    def __repr__(self) -> str:
        return f"OpaqueBlob({len(self.data)} bytes)"


@dataclass
class Request:
    """One store operation on one key. ``tensor_val`` is the payload on put
    (CPU or CUDA) or the in-place destination on get; ``tensor_slice``
    places a shard in its global tensor (a sharded put, or the region a get
    wants); ``objects`` carries an ``OpaqueBlob``. ``meta_only()`` strips
    data before metadata-plane RPCs: the controller never sees tensor
    bytes."""

    key: str
    tensor_val: Optional[torch.Tensor] = None
    tensor_slice: Optional[TensorSlice] = None
    objects: Any = None
    is_object: bool = False
    tensor_meta: Optional[TensorMeta] = None
    # Client-only in-place destination for a get; never serialized.
    destination_view: Optional[torch.Tensor] = field(default=None, repr=False)

    @classmethod
    def from_tensor(cls, key: str, tensor: torch.Tensor) -> "Request":
        return cls(key=key, tensor_val=tensor)

    @classmethod
    def from_objects(cls, key: str, objects: Any) -> "Request":
        return cls(key=key, objects=objects, is_object=True)

    @classmethod
    def from_tensor_slice(
        cls, key: str, tensor_slice: TensorSlice, tensor: Optional[torch.Tensor] = None
    ) -> "Request":
        if tensor is not None and tuple(tensor.shape) != tensor_slice.local_shape:
            raise ValueError(
                f"shard data shape {tuple(tensor.shape)} != slice local_shape "
                f"{tensor_slice.local_shape} for key {key!r}"
            )
        return cls(key=key, tensor_val=tensor, tensor_slice=tensor_slice)

    @classmethod
    def meta_request(cls, key: str) -> "Request":
        return cls(key=key)

    def meta_only(self) -> "Request":
        """A copy carrying metadata only. Memoized: one request's meta rides
        the put and the notify; the copy is read only."""
        cached = self.__dict__.get("_meta_only")
        if cached is not None:
            return cached
        meta = self.tensor_meta
        if meta is None and self.tensor_val is not None:
            meta = TensorMeta.of(self.tensor_val)
        mo = Request(
            key=self.key,
            tensor_slice=self.tensor_slice,
            is_object=self.is_object,
            tensor_meta=meta,
        )
        self.__dict__["_meta_only"] = mo
        return mo

    @property
    def nbytes(self) -> int:
        if self.tensor_val is None:
            return 0
        return self.tensor_val.numel() * self.tensor_val.element_size()

    def __getstate__(self):
        state = self.__dict__.copy()
        state["destination_view"] = None
        state.pop("_meta_only", None)
        return state
