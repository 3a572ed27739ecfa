"""Llama-family transformer in PyTorch: the port of
``torchstore_tpu/models/llama.py``.

RoPE + GQA attention, SwiGLU (or tanh-GELU) MLP, RMSNorm, tied or untied
output head. Every parameter keeps the flax name, shape and layout
(``layer_0.attn.q_proj.kernel`` is (hidden, heads, head_dim),
``o_proj.kernel`` (heads, head_dim, hidden), ``lm_head.kernel`` (hidden,
vocab)), so a state dict has the same keys and shapes in both packages, up
to ``/`` <-> ``.``; ``params_from_flax`` carries a flax tree across.

Compute follows flax: parameters in ``param_dtype``, inputs and weights
cast to ``cfg.dtype`` for each product, RMSNorm in fp32, logits in fp32.
Attention is ``F.scaled_dot_product_attention`` (the counterpart of
``jax.nn.dot_product_attention``) unless ``cfg.mesh`` has an ``sp`` axis
larger than 1, where ring or Ulysses attention runs over it. Each
parameter carries the flax model's logical axes (``Llama.logical_axes``),
which ``parallel.shard_params`` lays out on a mesh. MoE layers
(``num_experts > 0``) and tensor-parallel compute are later slices.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torchstore_tpu_torch.logging import get_logger
from torchstore_tpu_torch.ops._sharded import axis_size, make_sharded_attention
from torchstore_tpu_torch.ops.ring_attention import ring_attention
from torchstore_tpu_torch.ops.ulysses_attention import ulysses_attention

logger = get_logger("torchstore_tpu_torch.models.llama")


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    # MoE (Mixtral-style): 0 experts = dense MLP. The port has no MoE yet.
    num_experts: int = 0
    num_experts_per_tok: int = 2
    # Qwen2-style: biases on the q/k/v projections only.
    attention_bias: bool = False
    # Gemma-style knobs: tanh-gelu MLP ("silu" | "gelu_tanh"), RMSNorm
    # scale stored as an offset applied as (1 + w), embeddings scaled by
    # sqrt(hidden) after lookup, and the lm_head tied to the embedding.
    mlp_act: str = "silu"
    rms_offset: bool = False
    scale_embeddings: bool = False
    tie_embeddings: bool = False
    # Long-context attention: "dense" | "ring" | "ulysses". The sharded
    # impls engage when ``mesh`` (a DeviceMesh) has an sp axis of size > 1.
    attn_impl: str = "dense"
    mesh: Any = field(default=None, compare=False)
    # Autoregressive decoding over a KVCache of max_cache_len (see
    # models/generate.py).
    decode: bool = False
    max_cache_len: int = 0

    @classmethod
    def llama3_8b(cls) -> "LlamaConfig":
        return cls(
            vocab_size=128256, hidden_size=4096, intermediate_size=14336,
            num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
        )

    @classmethod
    def llama3_70b(cls) -> "LlamaConfig":
        return cls(
            vocab_size=128256, hidden_size=8192, intermediate_size=28672,
            num_layers=80, num_heads=64, num_kv_heads=8, head_dim=128,
        )

    @classmethod
    def mixtral_8x7b(cls) -> "LlamaConfig":
        return cls(
            vocab_size=32000, hidden_size=4096, intermediate_size=14336,
            num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
            rope_theta=1e6, num_experts=8, num_experts_per_tok=2,
        )

    @classmethod
    def qwen2_7b(cls) -> "LlamaConfig":
        return cls(
            vocab_size=152064, hidden_size=3584, intermediate_size=18944,
            num_layers=28, num_heads=28, num_kv_heads=4, head_dim=128,
            rope_theta=1e6, rms_eps=1e-6, attention_bias=True,
        )

    @classmethod
    def gemma_7b(cls) -> "LlamaConfig":
        return cls(
            vocab_size=256000, hidden_size=3072, intermediate_size=24576,
            num_layers=28, num_heads=16, num_kv_heads=16, head_dim=256,
            rope_theta=10000.0, rms_eps=1e-6, mlp_act="gelu_tanh",
            rms_offset=True, scale_embeddings=True, tie_embeddings=True,
        )

    @classmethod
    def tiny_gemma(cls) -> "LlamaConfig":
        return cls(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=8, num_kv_heads=8, head_dim=8,
            rms_eps=1e-6, mlp_act="gelu_tanh", rms_offset=True,
            scale_embeddings=True, tie_embeddings=True,
        )

    @classmethod
    def tiny(cls, vocab_size: int = 256) -> "LlamaConfig":
        return cls(
            vocab_size=vocab_size, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=8, num_kv_heads=8, head_dim=8,
        )

    @classmethod
    def tiny_moe(cls) -> "LlamaConfig":
        return cls(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=8, num_kv_heads=8, head_dim=8,
            num_experts=4, num_experts_per_tok=2,
        )


# flax's lecun_normal: variance_scaling(1, "fan_in", "truncated_normal"),
# a normal truncated at +-2 standard units, rescaled to unit variance.
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(p: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    tmp = p if p.dtype == torch.float32 else torch.empty_like(p, dtype=torch.float32)
    nn.init.trunc_normal_(tmp, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    if tmp is not p:
        p.copy_(tmp)


class DenseGeneral(nn.Module):
    """flax ``DenseGeneral`` over the trailing ``len(in_shape)`` axes:
    ``kernel`` is in_shape + out_shape; the product runs in ``dtype``.
    ``axes``: the kernel's logical axes (the bias takes the output ones)."""

    def __init__(self, in_shape, out_shape, dtype, param_dtype, device, bias: bool = False,
                 axes: Optional[tuple] = None):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.dtype = dtype
        self.axes = axes
        kw = dict(dtype=param_dtype, device=device)
        self.kernel = nn.Parameter(torch.empty(*self.in_shape, *self.out_shape, **kw))
        self.bias = nn.Parameter(torch.empty(*self.out_shape, **kw)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        _lecun_normal_(self.kernel, math.prod(self.in_shape), generator)
        if self.bias is not None:
            self.bias.zero_()

    def param_axes(self) -> dict:
        if self.axes is None:
            return {}
        out = {"kernel": self.axes}
        if self.bias is not None:
            out["bias"] = self.axes[len(self.in_shape):]
        return out

    def forward(self, x):
        lead = x.shape[: x.dim() - len(self.in_shape)]
        n_in = math.prod(self.in_shape)
        y = x.to(self.dtype).reshape(*lead, n_in) @ self.kernel.to(self.dtype).reshape(n_in, -1)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype).reshape(-1)
        return y.reshape(*lead, *self.out_shape)


class Embed(nn.Module):
    """flax ``Embed``: lookup in the table cast to ``dtype``."""

    def __init__(self, vocab: int, hidden: int, dtype, param_dtype, device):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(vocab, hidden, dtype=param_dtype, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.embedding.normal_(0.0, 0.02, generator=generator)

    def param_axes(self) -> dict:
        return {"embedding": ("vocab", "embed")}

    def forward(self, tokens):
        return F.embedding(tokens, self.embedding).to(self.dtype)


class RMSNorm(nn.Module):
    """fp32 RMSNorm with an fp32 ``scale`` (an offset applied as 1 + w in
    the Gemma convention), cast to ``dtype``."""

    def __init__(self, dim: int, eps: float, dtype, offset: bool, device):
        super().__init__()
        self.eps, self.dtype, self.offset = eps, dtype, offset
        self.scale = nn.Parameter(torch.empty(dim, dtype=torch.float32, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.scale.fill_(0.0 if self.offset else 1.0)

    def param_axes(self) -> dict:
        return {"scale": (None,)}

    def forward(self, x):
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + self.eps)
        scale = 1.0 + self.scale if self.offset else self.scale
        return (out * scale).to(self.dtype)


def _mlp_act(cfg: LlamaConfig):
    if cfg.mlp_act == "silu":
        return F.silu
    if cfg.mlp_act == "gelu_tanh":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown mlp_act {cfg.mlp_act!r}")


def rope(q, k, positions, theta: float):
    """Rotary position embeddings applied to q/k: (..., seq, heads, head_dim)."""
    head_dim = q.shape[-1]
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=q.device) / head_dim
    freqs = 1.0 / (theta**exps)
    angles = positions[..., :, None].float() * freqs  # (b, s, hd/2)
    cos = torch.cos(angles)[..., :, None, :]  # (b, s, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]

    def rotate(x):
        x1, x2 = x.float().chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    return rotate(q).to(q.dtype), rotate(k).to(k.dtype)


@dataclass
class KVCache:
    """Per-layer k/v caches of a static length, (batch, max_cache_len,
    kv_heads, head_dim) in ``cfg.dtype``, and the next write position."""

    k: list
    v: list
    idx: int = 0

    @classmethod
    def empty(cls, cfg: LlamaConfig, batch: int, device) -> "KVCache":
        if cfg.max_cache_len <= 0:
            raise ValueError("decode=True requires max_cache_len > 0")
        shape = (batch, cfg.max_cache_len, cfg.num_kv_heads, cfg.head_dim)
        make = lambda: torch.zeros(shape, dtype=cfg.dtype, device=device)  # noqa: E731
        return cls([make() for _ in range(cfg.num_layers)], [make() for _ in range(cfg.num_layers)])


def _sdpa(q, k, v, **kw):
    """SDPA on (b, s, h, d) tensors, GQA native."""
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), enable_gqa=True, **kw
    )
    return out.transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        self.cfg = cfg
        h, hk, hd, dim = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.hidden_size
        mk = lambda out, heads: DenseGeneral(  # noqa: E731
            (dim,), out, cfg.dtype, cfg.param_dtype, device, cfg.attention_bias,
            axes=("embed", heads, None),
        )
        self.q_proj = mk((h, hd), "heads")
        self.k_proj = mk((hk, hd), "kv_heads")
        self.v_proj = mk((hk, hd), "kv_heads")
        self.o_proj = DenseGeneral((h, hd), (dim,), cfg.dtype, cfg.param_dtype, device,
                                   axes=("heads", None, "embed"))

    def forward(self, x, positions, cache: Optional[KVCache] = None, layer: int = 0):
        q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        if cache is not None:
            out = self._cached_attention(q, k, v, cache, layer)
        else:
            q, k = rope(q, k, positions, self.cfg.rope_theta)
            out = _attend(self.cfg, q, k, v)
        return self.o_proj(out)

    def _cached_attention(self, q, k, v, cache: KVCache, layer: int):
        """Decode-mode attention: write k/v into the static-length cache at
        the running index and attend over the written prefix. Handles the
        prefill call (q_len > 1) and single-token steps. The write is in
        place: the port's counterpart of the JAX package's
        ``dynamic_update_slice`` on a donated cache buffer."""
        cfg = self.cfg
        b, q_len = q.shape[0], q.shape[1]
        idx = cache.idx
        steps = idx + torch.arange(q_len, device=q.device)
        q, k = rope(q, k, steps[None, :].expand(b, q_len), cfg.rope_theta)
        cache.k[layer][:, idx : idx + q_len] = k.to(cfg.dtype)
        cache.v[layer][:, idx : idx + q_len] = v.to(cfg.dtype)
        # Causal over the WRITTEN prefix: kv position j takes part for query
        # position p iff j <= p (the unwritten tail is masked out too).
        kv_pos = torch.arange(cache.k[layer].shape[1], device=q.device)
        mask = kv_pos[None, :] <= steps[:, None]
        return _sdpa(q, cache.k[layer], cache.v[layer], attn_mask=mask)


def _attend(cfg: LlamaConfig, q, k, v):
    """Causal attention dispatch: dense SDPA, or sequence-parallel ring /
    Ulysses over the mesh's sp axis. Tensor-parallel heads wait for DTensor
    support (ROADMAP A4): every rank of the sp group runs all heads."""
    mesh = cfg.mesh
    use_sp = (
        cfg.attn_impl in ("ring", "ulysses")
        and mesh is not None
        and "sp" in (mesh.mesh_dim_names or ())
        and axis_size(mesh, "sp") > 1
    )
    if not use_sp:
        return _sdpa(q, k, v, is_causal=True)
    sp_size = axis_size(mesh, "sp")
    impl = cfg.attn_impl
    if impl == "ulysses" and (cfg.num_heads % sp_size or cfg.num_kv_heads % sp_size):
        # Indivisible head counts fall back to ring attention (which has no
        # head constraint) instead of failing the forward pass.
        logger.warning(
            "ulysses attention needs per-shard head counts (q=%d, kv=%d) "
            "divisible by the sp axis size (%d); falling back to ring "
            "attention for this config",
            cfg.num_heads,
            cfg.num_kv_heads,
            sp_size,
        )
        impl = "ring"
    body = ring_attention if impl == "ring" else ulysses_attention
    return make_sharded_attention(body, mesh, "sp", True)(q, k, v)


class MLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        dim, inter = cfg.hidden_size, cfg.intermediate_size
        mk = lambda i, o, axes: DenseGeneral(  # noqa: E731
            (i,), (o,), cfg.dtype, cfg.param_dtype, device, axes=axes
        )
        self.gate_proj = mk(dim, inter, ("embed", "mlp"))
        self.up_proj = mk(dim, inter, ("embed", "mlp"))
        self.down_proj = mk(inter, dim, ("mlp", "embed"))
        self.act = _mlp_act(cfg)

    def forward(self, x):
        return self.down_proj(self.act(self.gate_proj(x)) * self.up_proj(x))


class Block(nn.Module):
    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, cfg.dtype, cfg.rms_offset, device)
        self.attn = Attention(cfg, device)
        self.mlp_norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, cfg.dtype, cfg.rms_offset, device)
        self.mlp = MLP(cfg, device)

    def forward(self, x, positions, cache: Optional[KVCache] = None, layer: int = 0):
        x = x + self.attn(self.attn_norm(x), positions, cache, layer)
        return x + self.mlp(self.mlp_norm(x))


class Llama(nn.Module):
    """The model on ``device``. Parameters are allocated, not initialized:
    fill them with ``init_params``, ``load_state_dict`` or a pull from the
    store."""

    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        if cfg.num_experts > 0:
            raise NotImplementedError(
                "MoE layers (num_experts > 0) are not ported yet; see ROADMAP.md, "
                "queue A, item 9"
            )
        if cfg.attn_impl not in ("dense", "ring", "ulysses"):
            raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
        self.cfg = cfg
        self.embed = Embed(cfg.vocab_size, cfg.hidden_size, cfg.dtype, cfg.param_dtype, device)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", Block(cfg, device))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, cfg.dtype, cfg.rms_offset, device)
        if not cfg.tie_embeddings:
            self.lm_head = DenseGeneral(
                (cfg.hidden_size,), (cfg.vocab_size,), torch.float32, cfg.param_dtype, device,
                axes=("embed", "vocab"),
            )

    def logical_axes(self) -> dict[str, tuple]:
        """Each parameter's logical axes, by state-dict key: the ones the
        flax model boxes it with (``nn.with_logical_partitioning``), which
        ``parallel.shard_params`` maps onto a mesh."""
        out = {}
        for prefix, mod in self.named_modules():
            if hasattr(mod, "param_axes"):
                for pname, axes in mod.param_axes().items():
                    out[f"{prefix}.{pname}" if prefix else pname] = axes
        return out

    def forward(self, tokens, cache: Optional[KVCache] = None):
        """Logits (batch, seq, vocab) in fp32. With ``cache`` the attention
        runs in decode mode and the cache index advances by seq."""
        cfg = self.cfg
        x = self.embed(tokens)
        if cfg.scale_embeddings:
            # Gemma normalizer: sqrt(hidden) in the embedding dtype.
            norm = torch.sqrt(torch.tensor(float(cfg.hidden_size), dtype=torch.float32))
            x = x * norm.to(device=x.device, dtype=x.dtype)
        positions = torch.arange(tokens.shape[-1], device=tokens.device).expand(tokens.shape)
        for i in range(cfg.num_layers):
            x = getattr(self, f"layer_{i}")(x, positions, cache, i)
        x = self.final_norm(x)
        if cache is not None:
            cache.idx += tokens.shape[-1]
        if cfg.tie_embeddings:
            # In fp32, like the untied head: the big vocab product is not
            # rounded to cfg.dtype first.
            return torch.einsum("bsh,vh->bsv", x.float(), self.embed.embedding.float())
        return self.lm_head(x)


@torch.no_grad()
def init_params(cfg: LlamaConfig, generator: torch.Generator, device) -> Llama:
    """A ``Llama`` on ``device`` initialized with flax's distributions from
    ``generator``, a generator of that device (lecun-normal on fan-in for kernels, normal(0.02) for the
    embedding, ones or zeros for the norms, zeros for biases)."""
    model = Llama(cfg, device)
    for mod in model.modules():
        if hasattr(mod, "reset_parameters"):
            mod.reset_parameters(generator)
    return model


def _tensor_from_numpy(arr) -> torch.Tensor:
    arr = np.array(arr)  # an owned, writable copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_flax(tree: Mapping) -> dict[str, torch.Tensor]:
    """The JAX package's Llama param tree (nested mappings of numpy arrays,
    with or without the top-level ``params`` collection) as this module's
    state dict: ``/``-paths become ``.``-keys. The layouts are equal, so
    nothing is transposed."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str) -> None:
        for key, val in node.items():
            name = f"{prefix}.{key}" if prefix else str(key)
            if isinstance(val, Mapping):
                walk(val, name)
            else:
                out[name] = _tensor_from_numpy(val)

    walk(tree, "")
    return out
