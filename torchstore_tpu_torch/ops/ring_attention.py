"""Ring attention: sequence-parallel attention for long contexts, the port
of ``torchstore_tpu/ops/ring_attention.py``.

q/k/v are sequence-sharded over the ranks of an ``sp`` process group. Each
rank keeps its query block and passes its k/v blocks around the ring, one
hop per step (``dist.batch_isend_irecv`` to the next rank, from the
previous one), accumulating with a numerically stable online softmax.
Memory per rank is O(seq/n). A hop is a ``torch.autograd.Function`` whose
backward rotates the gradients the other way (the transpose of JAX's
``ppermute``), so the ring trains like the JAX one.

``ring_attention_sharded`` is the wrapped version on global tensors.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from torchstore_tpu_torch.ops._sharded import make_sharded_attention
from torchstore_tpu_torch.ops.flash_attention import (
    DENOM_FLOOR,
    NEG_INF,
    flash_attention_stats,
    flash_stats_eligible,
)


def _shift(tensors, group, step: int) -> list:
    """Send each tensor to group rank ``r + step`` and receive its
    counterpart from ``r - step`` (mod n)."""
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    dst = dist.get_global_rank(group, (r + step) % n)
    src = dist.get_global_rank(group, (r - step) % n)
    tensors = [t.contiguous() for t in tensors]
    outs = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, dst, group, tag) for tag, t in enumerate(tensors)]
    ops += [dist.P2POp(dist.irecv, o, src, group, tag) for tag, o in enumerate(outs)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


class _RingHop(torch.autograd.Function):
    """One hop of k and v to the next ring rank; backward sends the
    gradients back to the previous one."""

    @staticmethod
    def forward(ctx, group, k, v):
        ctx.group = group
        k_next, v_next = _shift([k, v], group, 1)
        return k_next, v_next

    @staticmethod
    def backward(ctx, g_k, g_v):
        g_k, g_v = _shift([g_k, g_v], ctx.group, -1)
        return None, g_k, g_v


def ring_attention(q, k, v, group, causal: bool = False, impl: str = "auto"):
    """Per-rank attention bodies. Shapes (per rank): q (batch, seq_local,
    heads, head_dim), k/v (batch, seq_local, kv_heads, head_dim) ->
    q-shaped output. GQA is native: the ring passes the unrepeated kv
    blocks.

    ``impl`` selects the per-hop block body:

    - ``"fused"``: the flash kernel (``flash_attention_stats``) per hop,
      merged with the online-softmax rescale;
    - ``"einsum"``: the dense block body (any shape);
    - ``"auto"``: fused when the per-rank shapes tile
      (``flash_stats_eligible``), einsum otherwise.
    """
    # The fused body's causal hop mask is all-or-nothing per hop, which is
    # exact only when q and kv blocks have EQUAL per-rank lengths.
    fused_exact = not causal or q.shape[1] == k.shape[1]
    if impl == "fused":
        if not fused_exact:
            raise ValueError(
                "impl='fused' causal ring attention requires equal q/kv "
                f"sequence lengths per device (got {q.shape[1]} vs "
                f"{k.shape[1]}); use impl='auto' or 'einsum'"
            )
        return _ring_fused(q, k, v, group, causal)
    if impl == "auto" and fused_exact and flash_stats_eligible(q.shape, k.shape):
        return _ring_fused(q, k, v, group, causal)
    return _ring_einsum(q, k, v, group, causal)


def _ring_fused(q, k, v, group, causal: bool):
    """Ring body with the flash kernel per hop, merged with the flash
    rescale. When causal, blocks from ring positions after this rank lie
    wholly in the future and are masked to (0, NEG_INF, 0) after they are
    computed, as in the JAX body: skipping them would leave this rank's
    autograd graph without those hops, so its backward would not take part
    in the other ranks' hops. The diagonal (own) block takes the in-kernel
    causal mask."""
    n = dist.get_world_size(group)
    my_idx = dist.get_rank(group)
    # Step 0: the rank's own block.
    acc, m, l = flash_attention_stats(q, k, v, causal_diag=causal)
    k_cur, v_cur = k, v
    for i in range(1, n):
        k_cur, v_cur = _RingHop.apply(group, k_cur, v_cur)
        acc_j, m_j, l_j = flash_attention_stats(q, k_cur, v_cur, causal_diag=False)
        if causal:
            # k_cur originated on ring position (my_idx - i) mod n.
            valid = torch.tensor((my_idx - i) % n < my_idx, device=q.device)
            acc_j = torch.where(valid, acc_j, 0.0)
            m_j = torch.where(valid, m_j, NEG_INF)
            l_j = torch.where(valid, l_j, 0.0)
        m_new = torch.maximum(m, m_j)
        c1 = torch.exp(m - m_new)
        c2 = torch.exp(m_j - m_new)
        acc = acc * c1[..., None] + acc_j * c2[..., None]
        l = l * c1 + l_j * c2
        m = m_new
    out = acc / l.clamp_min(DENOM_FLOOR)[..., None]  # (b, h, sq, d)
    return out.transpose(1, 2).to(q.dtype)


def _ring_einsum(q, k, v, group, causal: bool):
    """Dense (einsum) block body: grouped-GQA online softmax materializing
    one (sq, sk) score block per hop; takes any shape."""
    n = dist.get_world_size(group)
    my_idx = dist.get_rank(group)
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    if h % hk != 0:
        raise ValueError(f"q heads ({h}) must be a multiple of kv heads ({hk})")
    g = h // hk
    scale = 1.0 / math.sqrt(d)
    dev = q.device

    # Grouped layout: (b, sq, hk, g, d) so kv heads broadcast per group.
    q32 = q.float().reshape(b, sq, hk, g, d)
    q_pos = my_idx * sq + torch.arange(sq, device=dev)  # global query positions

    def accumulate(o, m, l, k_cur, v_cur, i):
        # o: (b, hk, g, sq, d); m, l: (b, hk, g, sq). k_cur came from rank
        # (my_idx - i) mod n.
        src = (my_idx - i) % n
        s = torch.einsum("bqhgd,bkhd->bhgqk", q32, k_cur.float()) * scale
        if causal:
            k_pos = src * sk + torch.arange(sk, device=dev)
            mask = q_pos[:, None] >= k_pos[None, :]  # (sq, sk)
            s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, v_cur.float())
        return o, m_new, l

    o = torch.zeros((b, hk, g, sq, d), dtype=torch.float32, device=dev)
    m = torch.full((b, hk, g, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hk, g, sq), dtype=torch.float32, device=dev)
    # Step 0: the own (unrotated) block; then n - 1 hops.
    o, m, l = accumulate(o, m, l, k, v, 0)
    k_cur, v_cur = k, v
    for i in range(1, n):
        k_cur, v_cur = _RingHop.apply(group, k_cur, v_cur)
        o, m, l = accumulate(o, m, l, k_cur, v_cur, i)
    out = o / l.clamp_min(DENOM_FLOOR)[..., None]  # (b, hk, g, sq, d)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)
    return out.to(q.dtype)


def ring_attention_sharded(
    q, k, v, mesh, axis_name: str = "sp", causal: bool = False, impl: str = "auto"
):
    """Ring attention over ``mesh``'s ``axis_name`` ring (a ``DeviceMesh``):
    global (batch, seq, heads, head_dim) tensors in and out, sequence-sharded
    inside."""
    return make_sharded_attention(ring_attention, mesh, axis_name, causal, impl=impl)(q, k, v)
