"""Blockwise (flash) attention: the port of
``torchstore_tpu/ops/flash_attention.py``.

- ``flash_attention_stats`` is ring attention's per-hop engine: the
  UNNORMALIZED fp32 accumulator plus the online-softmax running max and
  denominator of one kv block, which hops merge with the flash rescale.
- ``flash_attention`` is the same block body with one extra
  normalization, the stats op's differential twin. The model's dense path
  uses ``F.scaled_dot_product_attention``, as the JAX package's uses XLA
  attention.

On a CUDA tensor both launch the hand-written kernel in
``csrc/flash_attention.cu`` (one kernel, a compile-time stats flag) or
raise; on a CPU tensor they take the plain versions, ``stats_reference``
and ``attention_reference``. The kernel takes any sequence lengths (it
masks ragged edges) and any head_dim d <= 256 with d % 8 == 0; the JAX
kernel needed tiling lengths. ``flash_stats_eligible`` keeps the JAX
package's rule all the same, so ring attention's ``auto`` body picks the
same body for the same shapes in both packages.

Layout: q (b, sq, h, d), k/v (b, sk, hk, d), read through their strides;
GQA maps q head ``i`` to kv head ``i // (h // hk)`` with no repeat.
"""

from __future__ import annotations

import ctypes
import math

import torch

from torchstore_tpu_torch.ops._nvcc import NvccLibrary

NEG_INF = -1e30
DENOM_FLOOR = 1e-30
MAX_HEAD_DIM = 256

_KINDS = {torch.float32: 0, torch.bfloat16: 1}
# Error codes of csrc/flash_attention.cu beside CUDA's own.
_ERRORS = {-1: "input type", -2: "head_dim", -3: "shape"}


def _pick_block(s: int, cap: int = 256) -> "int | None":
    """Largest power-of-two block (>=8, <=cap) dividing ``s``."""
    blk = None
    b = 8
    while b <= cap and s % b == 0:
        blk = b
        b *= 2
    return blk


def flash_stats_eligible(q_shape, k_shape) -> bool:
    """Whether the JAX package's ``flash_attention_stats`` tiles these
    per-device shapes: ring attention's fused-body gate (``auto`` falls back
    to the einsum body otherwise)."""
    b, sq, h, d = q_shape
    sk, hk = k_shape[1], k_shape[2]
    return (
        _pick_block(sq) is not None
        and _pick_block(sk) is not None
        and h % hk == 0
        and d % 8 == 0
    )


def stats_reference(q, k, v, causal_diag: bool = False):
    """The plain version of the stats kernel (the JAX package's
    ``_stats_ref``): dense fp32 scores, the same mask constant; returns
    ``(acc, m, l)`` with acc (b, h, sq, d) and m, l (b, h, sq), all fp32.
    Differentiable with autograd: the stats op's backward recomputes
    through it."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    g = h // hk
    scale = 1.0 / math.sqrt(d)
    qf = q.transpose(1, 2).float()  # (b, h, sq, d)
    kf = k.transpose(1, 2).float().repeat_interleave(g, dim=1)
    vf = v.transpose(1, 2).float().repeat_interleave(g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    if causal_diag:
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(rows >= cols, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bhqk,bhkd->bhqd", p, vf)
    return acc, m, l


def attention_reference(q, k, v, causal: bool = False):
    """The plain version of the normalized kernel: acc / max(l, 1e-30) in
    q's dtype, (b, sq, h, d)."""
    acc, _, l = stats_reference(q, k, v, causal)
    out = acc / l.clamp_min(DENOM_FLOOR)[..., None]
    return out.transpose(1, 2).to(q.dtype)


_LIB = NvccLibrary(
    "flash_attention.cu",
    "tst_flash",
    [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 9
    + [ctypes.c_int64] * 9
    + [ctypes.c_float, ctypes.c_void_p],
)


class FlashKernel:
    """One mode of the flash kernel: ``emit_stats`` True returns
    ``(acc, m, l)``, False the normalized output. ``launches`` grows by one
    per kernel launch and nowhere else."""

    def __init__(self, emit_stats: bool) -> None:
        self.emit_stats = emit_stats
        self.launches = 0
        self.lib = _LIB

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool):
        if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _KINDS:
            raise TypeError(
                f"flash kernel takes q, k, v all float32 or all bfloat16, got "
                f"{q.dtype}, {k.dtype}, {v.dtype}"
            )
        if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
            raise ValueError(
                f"flash kernel needs q (b, sq, h, d) and k, v (b, sk, hk, d) of one "
                f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
            )
        b, sq, h, d = q.shape
        sk, hk = k.shape[1], k.shape[2]
        if k.shape[0] != b or k.shape[3] != d or h % hk != 0:
            raise ValueError(
                f"flash kernel: kv shape {tuple(k.shape)} does not fit q {tuple(q.shape)}"
            )
        if d > MAX_HEAD_DIM or d % 8 != 0:
            raise ValueError(f"flash kernel takes head_dim <= 256 with d % 8 == 0, got {d}")
        if not (q.is_cuda and k.is_cuda and v.is_cuda):
            raise ValueError("the flash kernel takes CUDA tensors")
        if not (q.device == k.device == v.device):
            raise ValueError("q, k and v must be on one device")
        if any(x.stride(3) != 1 for x in (q, k, v)):
            raise ValueError("flash kernel needs the head_dim axis contiguous (stride 1)")
        if b * sq * h == 0 or sk == 0:
            raise ValueError("flash kernel needs non-empty q and kv")
        dev = q.device
        if self.emit_stats:
            acc = torch.empty((b, h, sq, d), dtype=torch.float32, device=dev)
            m = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
            l = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
            out_ptrs = (acc.data_ptr(), m.data_ptr(), l.data_ptr())
        else:
            o = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
            out_ptrs = (o.data_ptr(), None, None)
        if self.lib.fn is None:
            self.lib.build()
        with torch.cuda.device(dev):
            err = self.lib.fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), *out_ptrs,
                _KINDS[q.dtype], int(self.emit_stats), int(causal),
                b, h, hk, sq, sk, d,
                q.stride(0), q.stride(1), q.stride(2),
                k.stride(0), k.stride(1), k.stride(2),
                v.stride(0), v.stride(1), v.stride(2),
                1.0 / math.sqrt(d),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        if err != 0:
            what = _ERRORS.get(err, f"CUDA error {err}")
            raise RuntimeError(f"flash kernel launch failed: {what}")
        self.launches += 1
        return (acc, m, l) if self.emit_stats else o


stats_kernel = FlashKernel(emit_stats=True)
attention_kernel = FlashKernel(emit_stats=False)


class _FlashStats(torch.autograd.Function):
    """Forward: the stats kernel (its plain version on the CPU). Backward:
    recompute through ``stats_reference`` with autograd, as the JAX
    package's custom VJP does; there is no backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal_diag):
        ctx.save_for_backward(q, k, v)
        ctx.causal_diag = causal_diag
        if q.is_cuda:
            return stats_kernel(q, k, v, causal_diag)
        return stats_reference(q, k, v, causal_diag)

    @staticmethod
    def backward(ctx, g_acc, g_m, g_l):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            inputs = tuple(x.detach().requires_grad_() for x in (q, k, v))
            outs = stats_reference(*inputs, ctx.causal_diag)
            grads = torch.autograd.grad(outs, inputs, (g_acc, g_m, g_l))
        return (*grads, None)


def flash_attention_stats(q, k, v, causal_diag: bool = False):
    """Unnormalized attention of one kv block: ``(acc, m, l)`` with acc
    (b, h, sq, d) fp32 = sum_k exp(s - m) v and m, l (b, h, sq) the running
    max and denominator. ``causal_diag`` masks row >= col in the block's own
    coordinates (the ring's diagonal block). Merge blocks with the flash
    rescale: ``m' = max(m1, m2); acc' = acc1 e^(m1-m') + acc2 e^(m2-m')``.
    Differentiable (see ``_FlashStats``)."""
    return _FlashStats.apply(q, k, v, causal_diag)


def flash_attention(q, k, v, causal: bool = False):
    """Attention (b, sq, h, d) in q's dtype: the normalized kernel on a
    CUDA tensor, ``attention_reference`` on a CPU one. ``causal`` masks
    row >= col. Not differentiable on the card, as in the JAX package."""
    if q.is_cuda:
        return attention_kernel(q, k, v, causal)
    return attention_reference(q, k, v, causal)
