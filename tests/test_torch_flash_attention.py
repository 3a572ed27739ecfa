"""Port parity for the flash-attention ops (torchstore_tpu_torch.ops.flash_attention).

On the CPU both public ops take their plain versions; these tests hold them
against the JAX package's Pallas kernel in interpret mode (as its own tests
run it), on the same numpy inputs. Tolerances: rtol/atol 2e-5 on the fp32
stats and fp32 outputs, as tests/test_ring_attention.py uses (two fp32
implementations summing in other orders); one bf16 ulp (rtol 2**-7) on the
bf16 output, since both round an fp32 value that may differ in its last
bits; 3e-5 on gradients, as the reference's ring gradient test. The CUDA
kernel's own tests are in tests/test_torch_cuda.py (they need the card).
"""

import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

# The modules, not the functions of the same name that the packages export.
ref = importlib.import_module("torchstore_tpu.ops.flash_attention")
fa = importlib.import_module("torchstore_tpu_torch.ops.flash_attention")

HEADS = {"mha": (4, 4), "gqa": (8, 2)}
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def inputs(seed, b, s, h, hk, d, dtype="float32", sk=None):
    """(numpy fp32 rounded to ``dtype``) q, k, v for both packages."""
    rng = np.random.default_rng(seed)
    sk = s if sk is None else sk
    arrays = [
        rng.standard_normal(shape).astype(np.float32)
        for shape in ((b, s, h, d), (b, sk, hk, d), (b, sk, hk, d))
    ]
    if dtype == "bfloat16":
        arrays = [a.astype(ml_dtypes.bfloat16).astype(np.float32) for a in arrays]
    return arrays


def to_torch(arrays, dtype):
    return [torch.from_numpy(a.copy()).to(DTYPES[dtype][0]) for a in arrays]


def to_jax(arrays, dtype):
    return [jnp.asarray(a, DTYPES[dtype][1]) for a in arrays]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_stats_match_pallas_kernel(causal, heads, dtype):
    h, hk = HEADS[heads]
    arrays = inputs(1, 2, 64, h, hk, 16, dtype)
    want = ref.flash_attention_stats(*to_jax(arrays, dtype), causal_diag=causal, interpret=True)
    before = fa.stats_kernel.launches
    got = fa.flash_attention_stats(*to_torch(arrays, dtype), causal_diag=causal)
    assert fa.stats_kernel.launches == before  # the CPU path launches nothing
    for name, g, w in zip(("acc", "m", "l"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_normalized_matches_pallas_kernel(causal, heads, dtype):
    h, hk = HEADS[heads]
    # 128 tiles the reference's default 128 blocks, so it runs its kernel.
    arrays = inputs(2, 2, 128, h, hk, 16, dtype)
    want = ref.flash_attention(*to_jax(arrays, dtype), causal=causal, interpret=True)
    before = fa.attention_kernel.launches
    got = fa.flash_attention(*to_torch(arrays, dtype), causal=causal)
    assert fa.attention_kernel.launches == before
    assert got.dtype == DTYPES[dtype][0] and tuple(got.shape) == want.shape
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == "float32" else dict(rtol=2.0**-7, atol=0)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), **tol
    )


@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_stats_backward_matches_reference_vjp(causal, heads):
    h, hk = HEADS[heads]
    arrays = inputs(3, 1, 32, h, hk, 16)
    rng = np.random.default_rng(4)
    cts = [rng.standard_normal(shape).astype(np.float32)
           for shape in ((1, h, 32, 16), (1, h, 32), (1, h, 32))]
    _, vjp = jax.vjp(
        lambda a, b, c: ref.flash_attention_stats(a, b, c, causal_diag=causal, interpret=True),
        *to_jax(arrays, "float32"),
    )
    want = vjp(tuple(jnp.asarray(c) for c in cts))
    q, k, v = (t.requires_grad_() for t in to_torch(arrays, "float32"))
    outs = fa.flash_attention_stats(q, k, v, causal_diag=causal)
    got = torch.autograd.grad(outs, (q, k, v), [torch.from_numpy(c) for c in cts])
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=3e-5, atol=3e-5, err_msg=name)


def test_ragged_lengths_match_dense_attention():
    """The port takes lengths the Pallas kernel does not tile (the JAX
    kernel refuses them); its plain versions agree with dense attention."""
    arrays = inputs(5, 1, 25, 4, 2, 8, sk=37)
    q, k, v = to_torch(arrays, "float32")
    acc, m, l = fa.flash_attention_stats(q, k, v)
    out = (acc / l[..., None]).transpose(1, 2)
    want = jax.nn.dot_product_attention(*to_jax(arrays, "float32"))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(fa.flash_attention(q, k, v).numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_stats_merge_identity():
    """Two kv blocks merged with the flash rescale equal attention over the
    whole kv (the counterpart of the reference's merge-identity test)."""
    arrays = inputs(6, 1, 64, 2, 2, 16)
    q, k, v = to_torch(arrays, "float32")
    a1, m1, l1 = fa.flash_attention_stats(q, k[:, :32], v[:, :32])
    a2, m2, l2 = fa.flash_attention_stats(q, k[:, 32:], v[:, 32:])
    m = torch.maximum(m1, m2)
    c1, c2 = torch.exp(m1 - m), torch.exp(m2 - m)
    o = (a1 * c1[..., None] + a2 * c2[..., None]) / (l1 * c1 + l2 * c2)[..., None]
    want = jax.nn.dot_product_attention(*to_jax(arrays, "float32"))
    np.testing.assert_allclose(o.transpose(1, 2).numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("s", [8, 9, 16, 24, 40, 64, 100, 256, 512, 1000, 1024])
@pytest.mark.parametrize("d", [8, 10, 16])
def test_tiling_rules_match_reference(s, d):
    assert fa._pick_block(s) == ref._pick_block(s)
    shapes = ((2, s, 8, d), (2, s, 2, d))
    assert fa.flash_stats_eligible(*shapes) == ref.flash_stats_eligible(*shapes)


def test_kernel_refuses_cpu_tensors():
    q, k, v = to_torch(inputs(0, 1, 8, 2, 2, 8), "float32")
    for kernel in (fa.stats_kernel, fa.attention_kernel):
        with pytest.raises(ValueError, match="CUDA"):
            kernel(q, k, v, False)


def test_kernel_refuses_unsupported_head_dims():
    for d in (264, 12):
        q, k, v = to_torch(inputs(0, 1, 8, 2, 2, d), "float32")
        with pytest.raises(ValueError, match="head_dim"):
            fa.stats_kernel(q, k, v, False)


def test_kernel_refuses_unsupported_dtype():
    q, k, v = (t.half() for t in to_torch(inputs(0, 1, 8, 2, 2, 8), "float32"))
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        fa.attention_kernel(q, k, v, False)
