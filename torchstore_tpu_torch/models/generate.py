"""KV-cached autoregressive generation: the port of
``torchstore_tpu/models/generate.py``.

One PREFILL over the prompt fills the per-layer k/v caches (static length
``max_len``, written in place), then one STEP per token attends over the
cached prefix. Greedy (temperature=0) and temperature sampling from an
explicit ``torch.Generator``. Works with a freshly trained ``Llama`` or one
whose weights were pulled through the store (``get_state_dict``).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Iterable, Optional

import torch

from torchstore_tpu_torch.models.llama import KVCache, Llama, LlamaConfig


def forward_key_order(keys: Iterable[str]) -> list:
    """The keys of a :class:`Llama` state dict in MODEL-FORWARD order:
    embedding, then ``layer_0 .. layer_N`` numerically, then the final
    norm, then the lm head (anything else after, lexically): the order a
    layer-streamed pull consumes layers in. Keys may be nested flat keys
    of a published tree (``params/layer_0.attn.q_proj.kernel``)."""

    def rank(key: str) -> tuple:
        for part in re.split(r"[./]", key):
            if part == "embed":
                return (0, 0)
            if part.startswith("layer_") and part[6:].isdigit():
                return (1, int(part[6:]))
            if part == "final_norm":
                return (2, 0)
            if part == "lm_head":
                return (3, 0)
        return (4, 0)

    return sorted(keys, key=lambda k: (rank(k), k))


class Decoder:
    """Prefill + per-token step over a KV cache.

    >>> dec = Decoder(cfg, max_len=128, device="cuda")
    >>> tokens = dec.generate(model, prompt, max_new_tokens=32)
    """

    def __init__(self, cfg: LlamaConfig, max_len: int, device) -> None:
        if cfg.attn_impl != "dense":
            # Sequence-parallel attention is a training-time layout; decode
            # attends over a cache and is dense by construction.
            cfg = dataclasses.replace(cfg, attn_impl="dense", mesh=None)
        self.cfg = dataclasses.replace(cfg, decode=True, max_cache_len=int(max_len))
        self.max_len = int(max_len)
        self.device = torch.device(device)

    @torch.no_grad()
    def prefill(self, model: Llama, tokens: torch.Tensor):
        """Last-position logits (batch, vocab) of the prompt and a fresh
        cache holding its k/v."""
        cache = KVCache.empty(self.cfg, tokens.shape[0], self.device)
        logits = model(tokens, cache=cache)
        return logits[:, -1, :], cache

    @torch.no_grad()
    def step(self, model: Llama, cache: KVCache, token: torch.Tensor):
        """Logits after one more token (batch, 1); the cache grows in place."""
        logits = model(token, cache=cache)
        return logits[:, -1, :], cache

    def generate(
        self,
        model: Llama,
        prompt,
        max_new_tokens: int,
        temperature: float = 0.0,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """``max_new_tokens`` continuations of ``prompt`` (batch,
        prompt_len): returns (batch, prompt_len + max_new_tokens) int64.
        temperature=0 is greedy; otherwise softmax sampling with
        ``generator`` (required, on the decoder's device)."""
        prompt = torch.as_tensor(prompt, dtype=torch.int64, device=self.device)
        if prompt.dim() != 2:
            raise ValueError(f"prompt must be (batch, len), got {tuple(prompt.shape)}")
        total = prompt.shape[1] + max_new_tokens
        if total > self.max_len:
            raise ValueError(
                f"prompt_len + max_new_tokens = {total} exceeds the cache "
                f"length {self.max_len}"
            )
        if temperature > 0.0 and generator is None:
            raise ValueError("temperature sampling requires a torch.Generator")
        logits, cache = self.prefill(model, prompt)
        out = [prompt]
        for i in range(max_new_tokens):
            if temperature <= 0.0:
                token = logits.argmax(dim=-1, keepdim=True)
            else:
                probs = torch.softmax(logits / temperature, dim=-1)
                token = torch.multinomial(probs, 1, generator=generator)
            out.append(token)
            if i + 1 < max_new_tokens:
                logits, cache = self.step(model, cache, token)
        return torch.cat(out, dim=1)
