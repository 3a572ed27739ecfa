"""Mesh, sharding and train-step helpers: the part of
``torchstore_tpu/parallel`` that sequence parallelism, the learner and the
generators of the RL example need.

``make_mesh`` builds a ``DeviceMesh`` over an initialized process group
(the caller gives ``init_process_group`` its address, world size and rank).
``DEFAULT_RULES`` and ``logical_to_mesh_axes`` map a parameter's logical
axes (``Llama.logical_axes``) onto mesh axes as the JAX package does, and
``shard_params`` lays a state dict out on a mesh that lives in one process:
one tree of ``Shard`` views per mesh coordinate, the boxes JAX's
``NamedSharding`` gives the same mesh. ``reshard`` and ``activation_rules``
(sharded compute) are later work (ROADMAP A9).
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(shape: dict[str, int], device_type: str) -> DeviceMesh:
    """DeviceMesh from {axis: size}, e.g. {"sp": 4}, over the ranks of the
    default process group, whose world size must be the product of the
    sizes."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group")
    world = dist.get_world_size()
    if math.prod(shape.values()) != world:
        raise ValueError(f"mesh {shape} does not cover the world size {world}")
    return init_device_mesh(device_type, tuple(shape.values()), mesh_dim_names=tuple(shape))


# Logical axis -> mesh axes, first present and unused one wins; unmatched
# axes replicate (MaxText style, as the JAX package's rules).
DEFAULT_RULES = (
    ("vocab", ("tp",)),
    ("embed", ("fsdp",)),
    ("heads", ("tp",)),
    ("kv_heads", ("tp",)),
    ("mlp", ("tp",)),
    ("expert", ("ep", "tp")),
    ("batch", ("dp", "fsdp")),
    ("seq", ("sp",)),
)


def logical_to_mesh_axes(logical_axes, mesh_axes, rules=DEFAULT_RULES) -> tuple:
    """The mesh axis (or None) of each tensor dimension: the first candidate
    of the dimension's logical axis that the mesh has and no earlier
    dimension of the tensor took. ``mesh_axes``: the mesh's axis names (a
    ``{axis: size}`` dict will do)."""
    if logical_axes is None:
        return ()
    out = []
    used = set()
    for axis in logical_axes:
        resolved = None
        for name, candidates in rules:
            if axis == name:
                resolved = next((c for c in candidates if c in mesh_axes and c not in used), None)
                break
        if resolved is not None:
            used.add(resolved)
        out.append(resolved)
    return tuple(out)


def shard_params(
    params: Any,
    mesh_shape: dict[str, int],
    logical_axes: Optional[Mapping[str, tuple]] = None,
    rules=DEFAULT_RULES,
) -> list[dict]:
    """One ``{key: Shard}`` tree per coordinate of a ``{axis: size}`` mesh
    (row-major), e.g. ``{"tp": 8}`` or ``{"fsdp": 4}``, for a mesh that one
    process holds whole. Each ``Shard``'s data is a view of the parameter
    (a column block of a row-major tensor is a strided view), so a get into
    the trees fills the parameters in place. ``params``: an ``nn.Module``
    with ``logical_axes()`` (a ``Llama``) or a flat state dict with
    ``logical_axes``; a key without axes is replicated. A split dimension
    must divide evenly, as JAX's ``NamedSharding`` requires."""
    from torchstore_tpu_torch.client import Shard
    from torchstore_tpu_torch.transport.types import TensorSlice

    if isinstance(params, torch.nn.Module):
        logical_axes = params.logical_axes() if logical_axes is None else logical_axes
        params = params.state_dict()
    names, sizes = tuple(mesh_shape), tuple(mesh_shape.values())
    specs = {k: logical_to_mesh_axes((logical_axes or {}).get(k), names, rules) for k in params}
    trees = []
    for coords in np.ndindex(*sizes):
        tree = {}
        for key, tensor in params.items():
            offsets, local = [0] * tensor.dim(), list(tensor.shape)
            for dim, axis in enumerate(specs[key]):
                if axis is None:
                    continue
                pieces = mesh_shape[axis]
                if tensor.shape[dim] % pieces:
                    raise ValueError(
                        f"{key}: dim {dim} of {tuple(tensor.shape)} does not split into "
                        f"{pieces} ({axis})"
                    )
                local[dim] = tensor.shape[dim] // pieces
                offsets[dim] = coords[names.index(axis)] * local[dim]
            ts = TensorSlice(tuple(offsets), tuple(local), tuple(tensor.shape), tuple(coords),
                             sizes)
            tree[key] = Shard(tensor[ts.box.to_index()], ts)
        trees.append(tree)
    return trees


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer):
    """A causal-LM train step: ``step(tokens) -> loss``, the next-token
    cross-entropy of ``model(tokens[:, :-1])`` against ``tokens[:, 1:]``
    (mean over tokens, in fp32), then one optimizer step on the model's
    parameters in place."""

    def train_step(tokens: torch.Tensor) -> torch.Tensor:
        logits = model(tokens[:, :-1])
        targets = tokens[:, 1:]
        loss = F.cross_entropy(
            logits.reshape(-1, logits.shape[-1]).float(), targets.reshape(-1).long()
        )
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step
