"""DTensor <-> TensorSlice bridge.

Port of ``torchstore_tpu/sharding.py``, where ``jax.sharding.NamedSharding``
places shards: here a ``torch.distributed.tensor.DTensor`` does. A rank's
local shard gets its offsets and local shape from
``compute_local_shape_and_global_offset``, its commit coordinates from
``DeviceMesh.get_coordinate()`` and the mesh shape from ``mesh.shape``
(torch's ``Shard`` splits unevenly: the last shards may be smaller or
empty, and are put all the same, so the key commits). A DTensor on a mesh
of one rank, or replicated on every mesh dimension, is stored as a plain
tensor. ``Partial`` placements (pending reductions) are refused.

One difference from the JAX package is deliberate: a resharding get fills
the target DTensor's local tensor in place (the original torchstore's
semantics) where the JAX package builds a new ``jax.Array``.
"""

from __future__ import annotations

import sys
from typing import Any, Optional

import torch

from torchstore_tpu_torch.transport.types import Request, TensorSlice, full_slice


def is_dtensor(value: Any) -> bool:
    # A DTensor exists only once its module is imported: asking
    # sys.modules spares every put and get of plain tensors that import,
    # which takes seconds.
    module = sys.modules.get("torch.distributed.tensor")
    return module is not None and isinstance(value, module.DTensor)


def _is_demotable(dt) -> bool:
    """A mesh of one rank or a placement replicated on every mesh dimension:
    every rank holds the whole tensor, stored as a plain tensor."""
    return dt.device_mesh.size() == 1 or all(p.is_replicate() for p in dt.placements)


def local_slice(dt) -> Optional[TensorSlice]:
    """The placement of this rank's local shard of ``dt``, or None when
    ``dt`` is stored as a plain tensor (``_is_demotable``)."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    partial = [p for p in dt.placements if p.is_partial()]
    if partial:
        raise ValueError(
            f"a DTensor with Partial placements {dt.placements} holds pending "
            "reductions; call .redistribute() to Shard or Replicate before storing it"
        )
    if _is_demotable(dt):
        return None
    mesh = dt.device_mesh
    coords = mesh.get_coordinate()
    if coords is None:
        raise ValueError("this rank is not in the DTensor's device mesh")
    global_shape = tuple(int(s) for s in dt.shape)
    local_shape, offsets = compute_local_shape_and_global_offset(global_shape, mesh, dt.placements)
    return TensorSlice(
        offsets=offsets,
        local_shape=local_shape,
        global_shape=global_shape,
        coordinates=tuple(coords),
        mesh_shape=tuple(mesh.shape),
    )


def local_tensor(dt) -> torch.Tensor:
    """The rank's local tensor of ``dt`` (shares its memory)."""
    with torch.no_grad():
        return dt.to_local()


def put_requests(key: str, dt) -> list[Request]:
    """The put request of this rank's local shard of ``dt``: one request,
    as a torch rank holds one shard (a JAX host puts all its addressable
    shards)."""
    ts = local_slice(dt)
    local = local_tensor(dt).detach()
    if ts is None:
        return [Request.from_tensor(key, local)]
    return [Request.from_tensor_slice(key, ts, local)]


def target_slice(dt) -> TensorSlice:
    """The region of the global tensor a resharding get lands in ``dt``'s
    local tensor: the rank's own shard, or the whole tensor when ``dt`` is
    demotable."""
    ts = local_slice(dt)
    return full_slice(tuple(int(s) for s in dt.shape)) if ts is None else ts


def plan_signature(value: Any) -> Optional[tuple]:
    """Hashable signature of a DTensor leaf including its mesh and
    placements (two DTensors of one global shape on different meshes
    decompose into different requests), or None for anything else."""
    if not is_dtensor(value):
        return None
    mesh = value.device_mesh
    return (
        "dtensor",
        tuple(int(s) for s in value.shape),
        str(value.dtype),
        mesh.device_type,
        tuple(mesh.shape),
        tuple(mesh.mesh.flatten().tolist()),
        tuple(value.placements),
    )
