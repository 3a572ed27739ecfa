"""The store's north-star workload: a Llama-shaped state dict.

Port of ``llama8b_state_dict`` in ``benchmarks/llama8b_sync.py``: the exact
tensor inventory of a Llama checkpoint (embed, final_norm, lm_head and, per
layer, two norms and the seven projections), as torch tensors filled from an
explicit ``torch.Generator``. At the Llama-3-8B geometry that is 291
tensors and 8.03 B parameters. ``llama_shapes`` gives the same inventory as
shapes, so a test can fill it from numpy for both packages.
"""

from __future__ import annotations

from typing import Optional

import torch

LLAMA3_8B = dict(
    hidden=4096, intermediate=14336, vocab=128256, layers=32, heads=32, kv_heads=8
)


def llama_shapes(
    hidden: int, intermediate: int, vocab: int, layers: int, heads: int, kv_heads: int
) -> dict:
    """Nested dict of tensor shapes, in the reference's key order."""
    head_dim = hidden // heads
    return {
        "embed": (vocab, hidden),
        "final_norm": (hidden,),
        "lm_head": (hidden, vocab),
        "layers": {
            str(i): {
                "attn_norm": (hidden,),
                "mlp_norm": (hidden,),
                "q_proj": (hidden, heads * head_dim),
                "k_proj": (hidden, kv_heads * head_dim),
                "v_proj": (hidden, kv_heads * head_dim),
                "o_proj": (heads * head_dim, hidden),
                "gate_proj": (hidden, intermediate),
                "up_proj": (hidden, intermediate),
                "down_proj": (intermediate, hidden),
            }
            for i in range(layers)
        },
    }


def llama_state_dict(
    generator: torch.Generator,
    device,
    dtype: torch.dtype = torch.float32,
    layers: Optional[int] = None,
    **geometry,
) -> dict:
    """Random normal weights of a Llama state dict on ``device``;
    ``geometry`` overrides ``LLAMA3_8B`` (``layers`` cuts depth only)."""
    geo = {**LLAMA3_8B, **geometry}
    if layers is not None:
        geo["layers"] = layers

    def fill(node):
        if isinstance(node, dict):
            return {k: fill(v) for k, v in node.items()}
        return torch.randn(node, generator=generator, device=device, dtype=dtype)

    return fill(llama_shapes(**geo))
