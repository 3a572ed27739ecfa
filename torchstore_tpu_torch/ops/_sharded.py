"""Shared wrapper for the sequence-parallel attention ops: the port of
``torchstore_tpu/ops/_sharded.py``.

JAX runs the bodies under ``shard_map`` on global arrays. Here every rank
holds the global (replicated) q/k/v, takes its sequence chunk by its
coordinate on the mesh's ``axis_name``, runs the body, and all-gathers the
output along the sequence. Both moves carry a gradient: taking the chunk
is undone in backward by an all-gather of the chunk gradients, and the
all-gather by taking the chunk back, so every rank ends with the full
gradient of its replicated inputs, as the global arrays have in JAX.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _gather_seq(x, group):
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=1)


def _own_chunk(x, group):
    n = dist.get_world_size(group)
    chunk = x.shape[1] // n
    return x.narrow(1, dist.get_rank(group) * chunk, chunk).contiguous()


class _TakeChunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _own_chunk(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _gather_seq(grad, ctx.group), None


class _GatherChunks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_seq(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _own_chunk(grad, ctx.group), None


def axis_size(mesh, axis_name: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis_name)]


def make_sharded_attention(body, mesh, axis_name: str, causal: bool, impl: str | None = None):
    """``fn(q, k, v)`` on global (b, s, h, d) tensors that runs ``body(q,
    k, v, group, causal=..., [impl=...])`` on each rank's sequence chunk of
    ``mesh``'s ``axis_name`` and returns the global output. ``impl``
    forwards a block-body selector to bodies that take one (ring
    attention)."""
    group = mesh.get_group(axis_name)
    n = axis_size(mesh, axis_name)
    kwargs = {"causal": causal}
    if impl is not None:
        kwargs["impl"] = impl

    def fn(q, k, v):
        for name, x in (("q", q), ("k", k), ("v", v)):
            if x.shape[1] % n != 0:
                raise ValueError(
                    f"{name} sequence length ({x.shape[1]}) is not divisible by the "
                    f"{axis_name!r} axis size ({n})"
                )
        local = [_TakeChunk.apply(x, group) for x in (q, k, v)]
        return _GatherChunks.apply(body(*local, group, **kwargs), group)

    return fn
