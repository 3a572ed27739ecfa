"""Blockwise (flash) attention: the port of
``torchstore_tpu/ops/flash_attention.py``.

- ``flash_attention_stats`` is ring attention's per-hop engine: the
  UNNORMALIZED fp32 accumulator plus the online-softmax running max and
  denominator of one kv block, which hops merge with the flash rescale.
- ``flash_attention`` is the same block body with one extra
  normalization, the stats op's differential twin. The model's dense path
  uses ``F.scaled_dot_product_attention``, as the JAX package's uses XLA
  attention.

On a CUDA tensor both launch a hand-written kernel or raise; on a CPU
tensor they take the plain versions, ``stats_reference`` and
``attention_reference``. Three kernels serve both modes (a compile-time
stats flag in each), picked by shape (``sm90_eligible``, then
``sm90_fp32_eligible``), never as a fallback after a failure:

- ``csrc/flash_attention_sm90.cu`` (variant ``"sm90"``): bf16 or fp16
  q/k/v whose strides TMA accepts. ``wgmma`` in the input type for both
  products, p rounded to that type before P.V as FlashAttention and SDPA
  do, over k-tiles of ``SM90_BLOCK_K[padded_head_dim(d)]`` keys;
  ``stats_blockwise_reference`` repeats its arithmetic in plain PyTorch.
- ``csrc/flash_attention_sm90_fp32.cu`` (variant ``"sm90_fp32"``): fp32
  q/k/v whose strides TMA accepts. TF32 ``wgmma`` for both products with a
  3xTF32 split (hi = tf32(x), lo = tf32(x - hi), lo.lo dropped), over
  k-tiles of ``SM90_FP32_BLOCK_K[padded_head_dim(d)]`` keys;
  ``stats_blockwise_reference(split="tf32x3", _round_p=False)`` repeats its
  arithmetic.
- ``csrc/flash_attention.cu`` (variant ``"simt"``): the calls whose strides
  or base TMA refuses, fp32 math on the CUDA cores; it reads fp32, bf16 and
  fp16.

Every head dim d <= 256 with d % 8 == 0 runs on the two tensor-core
kernels: each has instances at 64, 128 and 256, and a call runs on the next
one up (``padded_head_dim``) with d zero-padded there (the kernel's tensor
maps read zeros past d), the scale 1/sqrt(d) of the real d.

Both take any sequence lengths (they mask ragged edges); the JAX kernel
needed tiling lengths. ``flash_stats_eligible`` keeps the JAX package's
rule all the same, so ring attention's ``auto`` body picks the same body
for the same shapes in both packages.

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

_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# Error codes of the two kernels' entry points beside CUDA's own.
_ERRORS = {
    -1: "input type", -2: "head_dim", -3: "shape", -4: "alignment or strides TMA refuses",
    -5: "tensor map refused", -6: "cuTensorMapEncodeTiled not found",
}
SM90_DTYPES = (torch.bfloat16, torch.float16)
# The head dims of each tensor-core kernel's compiled instances; other head
# dims run on the next one up (``padded_head_dim``).
SM90_HEAD_DIMS = (64, 128, 256)
# Keys per k-tile of the sm90 kernel's instance at each head_dim
# (``Tiling<D>`` in the .cu file): at d = 256 q and two stages of 128-key k
# and v tiles would not fit in a block's shared memory.
SM90_BLOCK_K = {64: 128, 128: 128, 256: 64}
SM90_FP32_HEAD_DIMS = (64, 128, 256)
# Keys per k-tile of the sm90_fp32 kernel's instances (``Tiling<D>`` in its
# .cu file): two stages of k and v^T split into hi and lo beside q fit in a
# block's shared memory only at 32 keys at d = 128; at d = 256 one stage of
# 32 keys beside 64 q rows.
SM90_FP32_BLOCK_K = {64: 64, 128: 32, 256: 32}
# Bits of an fp32 value that TF32 drops (the low 13 of the mantissa).
_TF32_DROPPED = 0x1FFF


def padded_head_dim(d: int) -> int:
    """The head dim of the tensor-core instance a call at head dim ``d``
    runs on (both kernels' ``dispatch_d``): 64 up to 64, 128 up to 128,
    else 256, d zero-padded to it. Takes d % 8 == 0, 0 < d <= 256."""
    if d <= 0 or d > MAX_HEAD_DIM or d % 8:
        raise ValueError(f"the flash kernels take head_dim <= 256 with d % 8 == 0, got {d}")
    return next(x for x in SM90_HEAD_DIMS if d <= x)


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


def _normalize(acc, l, dtype):
    """o = acc / max(l, 1e-30) in ``dtype``, (b, sq, h, d)."""
    out = acc / l.clamp_min(DENOM_FLOOR)[..., None]
    return out.transpose(1, 2).to(dtype)


def attention_reference(q, k, v, causal: bool = False):
    """The plain version of the normalized kernel: acc / max(l, 1e-30) in
    q's dtype, (b, sq, h, d)."""
    acc, _, l = stats_reference(q, k, v, causal)
    return _normalize(acc, l, q.dtype)


def _tf32(x):
    """fp32 ``x`` rounded to TF32 (10 explicit mantissa bits) to nearest,
    ties away from zero, as ``cvt.rna.tf32.f32`` rounds: the dropped 13 bits'
    half added to the magnitude bits, then cleared, on an int32 view."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + (_TF32_DROPPED + 1) // 2) & ~_TF32_DROPPED).view(torch.float32)


def tf32_split(x):
    """``x = hi + lo`` to TF32 precision: hi = tf32(x), lo = tf32(x - hi)."""
    hi = _tf32(x)
    return hi, _tf32(x.float() - hi)


def _product(eq, a, b, split):
    """``einsum(eq, a, b)`` in fp32, or with ``split="tf32x3"`` the sum the
    sm90_fp32 kernel's three TF32 passes make: a_lo.b_hi + a_hi.b_lo +
    a_hi.b_hi, a_lo.b_lo dropped."""
    if split is None:
        return torch.einsum(eq, a, b)
    (a_hi, a_lo), (b_hi, b_lo) = tf32_split(a), tf32_split(b)
    return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)
            + torch.einsum(eq, a_hi, b_hi))


def stats_blockwise_reference(q, k, v, causal_diag: bool = False,
                              block_k: "int | None" = None, *, _round_p: bool = True,
                              split: "str | None" = None, scale: "float | None" = None):
    """Plain PyTorch that repeats the sm90 kernels' arithmetic: an online
    softmax over k-tiles of ``block_k`` keys, ``l`` summed from the fp32
    ``p``, the same masks. The sm90 kernel's twin (the default): tiles of its
    own ``SM90_BLOCK_K[padded_head_dim(d)]`` keys, ``p`` rounded to q's
    dtype before P.V (``_round_p=False`` keeps it fp32, which makes this
    ``stats_reference`` summed in another order). The sm90_fp32 kernel's twin:
    ``split="tf32x3"`` with ``_round_p=False`` on fp32 inputs, tiles of
    ``SM90_FP32_BLOCK_K[padded_head_dim(d)]`` keys by default, both
    products as its three TF32 passes (``tf32_split`` of q, k, p and v).
    The default tile is the instance's at every d. ``scale`` (default
    1/sqrt(d)) is the kernels' own argument: q, k, v zero-padded to the
    instance's head dim with the real d's scale give the same values, as
    the kernels' zero padding does. Returns ``(acc, m, l)`` like
    ``stats_reference``. The tests and ``chip_smoke.py`` hold the kernels
    against it; no path uses it."""
    if split not in (None, "tf32x3"):
        raise ValueError(f"split is None or 'tf32x3', got {split!r}")
    if split is not None and _round_p:
        raise ValueError("split='tf32x3' keeps p in fp32: pass _round_p=False")
    b, sq, h, d = q.shape
    if block_k is None:
        block_k = (SM90_FP32_BLOCK_K if split else SM90_BLOCK_K)[padded_head_dim(d)]
    sk, hk = k.shape[1], k.shape[2]
    g = h // hk
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    qf = q.transpose(1, 2).float()  # (b, h, sq, d)
    kf = k.transpose(1, 2).float().repeat_interleave(g, dim=1)
    vf = v.transpose(1, 2).float().repeat_interleave(g, dim=1)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    rows = torch.arange(sq, device=q.device)[:, None]
    # Causal: k-tiles wholly above the last row are skipped, as the kernel does.
    last = min(sk, sq) if causal_diag else sk
    for k0 in range(0, last, block_k):
        s = _product("bhqd,bhkd->bhqk", qf, kf[:, :, k0:k0 + block_k], split) * scale
        if causal_diag:
            cols = torch.arange(k0, k0 + s.shape[-1], device=q.device)[None, :]
            s = torch.where(rows >= cols, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        if _round_p:
            p = p.to(q.dtype).float()
        acc = acc * corr[..., None] + _product("bhqk,bhkd->bhqd", p,
                                               vf[:, :, k0:k0 + block_k], split)
        m = m_new
    return acc, m, l


def attention_blockwise_reference(q, k, v, causal: bool = False,
                                  block_k: "int | None" = None, split: "str | None" = None):
    """The normalized twin of ``stats_blockwise_reference``, in q's dtype
    (``split="tf32x3"``: the sm90_fp32 kernel's, p unrounded)."""
    acc, _, l = stats_blockwise_reference(q, k, v, causal, block_k, _round_p=split is None,
                                          split=split)
    return _normalize(acc, l, q.dtype)


def _tma_strides(x: torch.Tensor) -> tuple:
    """(b, s, h) strides in elements as the sm90 kernel's tensor maps take
    them: a size-1 dimension, whose stride addresses nothing, gets the
    contiguous one."""
    return tuple(
        x.stride(i) if x.shape[i] != 1 else math.prod(x.shape[i + 1:]) for i in range(3)
    )


def _tma_takes(x: torch.Tensor, multiple: int) -> bool:
    """What TMA accepts: a 16-byte aligned base, a unit head_dim stride and
    every other stride a positive multiple of ``multiple`` elements (16
    bytes)."""
    if x.stride(3) != 1 or x.data_ptr() % 16:
        return False
    return all(st > 0 and st % multiple == 0 for st in _tma_strides(x))


def _tensor_core_shape(q, k, v, dtypes) -> bool:
    """q, k, v all of one type in ``dtypes``, (b, s, h, d) with kv of one
    shape, 0 < d <= 256 with d % 8 == 0 (``padded_head_dim`` takes it) and
    h % hk == 0."""
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in dtypes:
        return False
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        return False
    d = q.shape[3]
    return (0 < d <= MAX_HEAD_DIM and d % 8 == 0 and k.shape[3] == d
            and q.shape[2] % k.shape[2] == 0)


def sm90_eligible(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """The first variant rule: the sm90 kernel takes bf16 or fp16 q, k, v
    (all of one type) with head_dim d <= 256, d % 8 == 0 (on the instance of
    ``padded_head_dim(d)``), h % hk == 0, and what TMA accepts: 16-byte
    aligned base pointers, a unit head_dim stride and every other stride a
    positive multiple of 8 elements."""
    return (_tensor_core_shape(q, k, v, SM90_DTYPES)
            and all(_tma_takes(x, 8) for x in (q, k, v)))


def sm90_fp32_eligible(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """The second variant rule: the sm90_fp32 kernel takes fp32 q, k, v
    with head_dim d <= 256, d % 8 == 0 (on the instance of
    ``padded_head_dim(d)``), h % hk == 0, 16-byte aligned base pointers, a
    unit head_dim stride and every other stride a positive multiple of 4
    elements. Every call that neither rule takes runs on the simt kernel:
    within the shapes the kernels take, those whose strides or base TMA
    refuses."""
    return (_tensor_core_shape(q, k, v, (torch.float32,))
            and all(_tma_takes(x, 4) for x in (q, k, v)))


def flash_variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel a CUDA call of these tensors launches: ``"sm90"``,
    ``"sm90_fp32"`` or ``"simt"``."""
    if sm90_eligible(q, k, v):
        return "sm90"
    return "sm90_fp32" if sm90_fp32_eligible(q, k, v) else "simt"


# The three entry points: q, k, v, out, m, l; kind, emit_stats, causal, b, h, hk,
# sq, sk, d; the (b, s, h) strides of q, k, v; scale, stream.
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_int64] * 9
             + [ctypes.c_float, ctypes.c_void_p])
_LIBS = {
    "simt": NvccLibrary("flash_attention.cu", "tst_flash", _ARGTYPES),
    "sm90": NvccLibrary("flash_attention_sm90.cu", "tst_flash_sm90", _ARGTYPES),
    "sm90_fp32": NvccLibrary("flash_attention_sm90_fp32.cu", "tst_flash_sm90_fp32", _ARGTYPES),
}


class FlashKernel:
    """One mode of the flash kernels: ``emit_stats`` True returns
    ``(acc, m, l)``, False the normalized output. ``launches`` grows by one
    per kernel launch and nowhere else; ``launches_by_variant`` splits it
    by the kernel launched."""

    def __init__(self, emit_stats: bool) -> None:
        self.emit_stats = emit_stats
        self.launches = 0
        self.launches_by_variant = {name: 0 for name in _LIBS}
        self.libs = _LIBS

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                 _variant: "str | None" = None):
        """``_variant`` forces ``"simt"`` on a call the rules send to a
        tensor-core kernel, so a timing can set the two side by side;
        nothing else passes it."""
        if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _KINDS:
            raise TypeError(
                f"flash kernel takes q, k, v all float32, all bfloat16 or all float16, got "
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
        variant = flash_variant(q, k, v)
        if _variant not in (None, "simt", variant):
            raise ValueError(f"flash kernel: variant {_variant!r} does not take this call")
        variant = _variant or variant
        dev = q.device
        if self.emit_stats:
            acc = torch.empty((b, h, sq, d), dtype=torch.float32, device=dev)
            m = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
            l = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
            out_ptrs = (acc.data_ptr(), m.data_ptr(), l.data_ptr())
        else:
            o = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
            out_ptrs = (o.data_ptr(), None, None)
        lib = self.libs[variant]
        if lib.fn is None:
            lib.build()
        if variant != "simt":
            strides = (*_tma_strides(q), *_tma_strides(k), *_tma_strides(v))
        else:
            strides = tuple(x.stride(i) for x in (q, k, v) for i in range(3))
        with torch.cuda.device(dev):
            err = lib.fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), *out_ptrs,
                _KINDS[q.dtype], int(self.emit_stats), int(causal),
                b, h, hk, sq, sk, d,
                *strides,
                1.0 / math.sqrt(d),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        if err != 0:
            what = _ERRORS.get(err, f"CUDA error {err}")
            raise RuntimeError(f"flash kernel ({variant}) launch failed: {what}")
        self.launches += 1
        self.launches_by_variant[variant] += 1
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
