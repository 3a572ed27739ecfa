"""Ulysses-style (all-to-all) sequence-parallel attention: the port of
``torchstore_tpu/ops/ulysses_attention.py``.

An all-to-all re-partitions the activations from sequence-sharded to
head-sharded, each rank runs dense attention over the FULL sequence for
its share of the heads (``F.scaled_dot_product_attention``, the
counterpart of ``jax.nn.dot_product_attention``), and a second all-to-all
restores sequence sharding. The all-to-all is its own transpose, so its
backward is the same exchange of the gradients.

Requires num_heads % axis_size == 0 (q and kv heads).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from torchstore_tpu_torch.ops._sharded import axis_size, make_sharded_attention


class _AllToAll(torch.autograd.Function):
    """Chunk i of dim 0 goes to group rank i; chunk j of the result came
    from rank j."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.group), None


def _all_to_all(x, group):
    # Both buffers contiguous: the collective reads and writes flat memory.
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def ulysses_attention(q, k, v, group, causal: bool = False):
    """Per rank: q (batch, seq_local, heads, head_dim) and k/v (batch,
    seq_local, kv_heads, head_dim) sequence-sharded -> q-shaped output. GQA
    passes through (kv heads split over the group like q heads)."""
    n = dist.get_world_size(group)

    def seq_to_heads(x):  # (b, s, H, d) -> (b, n s, H / n, d)
        b, s, heads, d = x.shape
        x = x.reshape(b, s, n, heads // n, d).permute(2, 0, 1, 3, 4)
        x = _AllToAll.apply(x, group)  # chunk j: sequence chunk j
        return x.permute(1, 0, 2, 3, 4).reshape(b, n * s, heads // n, d)

    def heads_to_seq(x):  # (b, n s, H / n, d) -> (b, s, H, d)
        b, seq, heads, d = x.shape
        x = x.reshape(b, n, seq // n, heads, d).permute(1, 0, 2, 3, 4)
        x = _AllToAll.apply(x, group)  # chunk j: head group j
        return x.permute(1, 2, 0, 3, 4).reshape(b, seq // n, n * heads, d)

    qh, kh, vh = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    out = F.scaled_dot_product_attention(
        qh.transpose(1, 2), kh.transpose(1, 2), vh.transpose(1, 2),
        is_causal=causal, enable_gqa=True,
    )
    return heads_to_seq(out.transpose(1, 2))


def ulysses_attention_sharded(q, k, v, mesh, axis_name: str = "sp", causal: bool = False):
    """All-to-all attention over ``mesh``'s ``axis_name`` (a
    ``DeviceMesh``): global (batch, seq, heads, head_dim) tensors in and
    out, sequence-sharded inside. Every head axis (q AND k/v, GQA included)
    must be divisible by the axis size; repeat kv heads or use ring
    attention otherwise."""
    size = axis_size(mesh, axis_name)
    for name, arr in (("q", q), ("k", k), ("v", v)):
        if arr.shape[2] % size != 0:
            raise ValueError(
                f"ulysses attention needs {name} heads ({arr.shape[2]}) "
                f"divisible by the {axis_name!r} axis size ({size}); "
                "use ring attention for head counts below the ring size"
            )
    return make_sharded_attention(ulysses_attention, mesh, axis_name, causal)(q, k, v)
