"""Mesh and train-step helpers: the part of ``torchstore_tpu/parallel``
that sequence parallelism and the learner need.

``make_mesh`` builds a ``DeviceMesh`` over an initialized process group
(the caller gives ``init_process_group`` its address, world size and rank).
Parameter sharding under logical-axis rules (``shard_params``,
``reshard``, ``activation_rules``) waits for DTensor support (ROADMAP A4).
"""

from __future__ import annotations

import math

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
