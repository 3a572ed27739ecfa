"""Port parity for the flash-attention ops (torchstore_tpu_torch.ops.flash_attention).

On the CPU both public ops take their plain versions; these tests hold them
against the JAX package's Pallas kernel in interpret mode (as its own tests
run it), on the same numpy inputs. Tolerances: rtol/atol 2e-5 on the fp32
stats and fp32 outputs, as tests/test_ring_attention.py uses (two fp32
implementations summing in other orders); one bf16 ulp (rtol 2**-7) on the
bf16 output, since both round an fp32 value that may differ in its last
bits; 3e-5 on gradients, as the reference's ring gradient test. The sm90
kernel's plain twin, ``stats_blockwise_reference``, rounds p to bf16 before
P.V; its tolerance is derived in ``test_blockwise_reference_matches_reference``.
The CUDA kernels' own tests are in tests/test_torch_cuda.py (they need the
card).
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


def p_abs_v_over_l(arrays, causal):
    """(P.|V|) / l per element of o, (b, h, sq, d), from fp32 numpy: the
    scale of the error that rounding each p to bf16 can make in o."""
    q, k, v = (a.astype(np.float64) for a in arrays)
    g = q.shape[2] // k.shape[2]
    k, v = np.repeat(k, g, axis=2), np.repeat(v, g, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[3])
    if causal:
        s = np.where(np.tril(np.ones(s.shape[-2:], bool)), s, ref.NEG_INF)
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    return np.einsum("bhqk,bkhd->bhqd", p, np.abs(v)) / p.sum(axis=-1)[..., None]


# "tiled": lengths the Pallas kernel tiles (interpret mode); "ragged": lengths
# it refuses, held against its dense twin ``_stats_ref``.
BLOCKWISE_LENGTHS = {"tiled": (128, 256), "ragged": (100, 200)}


@pytest.mark.parametrize("lengths", BLOCKWISE_LENGTHS)
@pytest.mark.parametrize("block_k", [64, 128])
@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_blockwise_reference_matches_reference(causal, heads, block_k, lengths):
    """The sm90 kernel's plain twin against the JAX package on bf16 inputs.
    m and l are sums of fp32 p, so they agree to 2e-5. o = acc / l differs by
    the bf16 rounding of each p before P.V: round-to-nearest moves p_j by at
    most 2**-8 p_j, so o moves by at most 2**-8 (P.|V|)_d / l, computed from
    the fp32 reference, plus 1e-5 for the fp32 summation order."""
    h, hk = HEADS[heads]
    sq, sk = BLOCKWISE_LENGTHS[lengths]
    arrays = inputs(7, 2, sq, h, hk, 16, "bfloat16", sk=sk)
    if lengths == "tiled":
        want = ref.flash_attention_stats(*to_jax(arrays, "float32"), causal_diag=causal,
                                         interpret=True)
    else:
        want = ref._stats_ref(*to_jax(arrays, "float32"), causal)
    want_acc, want_m, want_l = (np.asarray(w) for w in want)
    acc, m, l = fa.stats_blockwise_reference(*to_torch(arrays, "bfloat16"), causal, block_k)
    np.testing.assert_allclose(m.numpy(), want_m, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(l.numpy(), want_l, rtol=2e-5, atol=2e-5)
    o, want_o = acc.numpy() / l.numpy()[..., None], want_acc / want_l[..., None]
    bound = 1e-5 + 2.0**-8 * p_abs_v_over_l(arrays, causal)
    assert np.all(np.abs(o - want_o) <= bound), float(np.max(np.abs(o - want_o) - bound))
    assert np.any(np.abs(o - want_o) > 2e-5)  # the rounding is there


@pytest.mark.parametrize("block_k", [64, 128])
@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_blockwise_reference_unrounded_matches_stats_reference(causal, heads, block_k):
    """Without the bf16 rounding of p the blockwise structure alone remains:
    the same function as the dense plain version, summed in another order."""
    h, hk = HEADS[heads]
    q, k, v = to_torch(inputs(8, 1, 100, h, hk, 32, "bfloat16", sk=300), "bfloat16")
    got = fa.stats_blockwise_reference(q, k, v, causal, block_k, _round_p=False)
    want = fa.stats_reference(q, k, v, causal)
    for name, g, w in zip(("acc", "m", "l"), got, want):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5, msg=name)


def _packed(b, s, h, hk, d):
    qkv = torch.zeros((b, s, h + 2 * hk, d), dtype=torch.bfloat16)
    return qkv[:, :, :h], qkv[:, :, h:h + hk], qkv[:, :, h + hk:]


def _contiguous(b, s, h, hk, d, dtype=torch.bfloat16):
    return (torch.zeros((b, s, h, d), dtype=dtype), torch.zeros((b, s, hk, d), dtype=dtype),
            torch.zeros((b, s, hk, d), dtype=dtype))


def _strided_d(b, s, h, hk, d):
    return tuple(x[..., ::2] for x in _contiguous(b, s, h, hk, 2 * d))


def _seq_stride_4(b, s, h, hk, d):
    """Head dim 128 cut from rows of 132: the sequence stride is 132
    elements, not a multiple of 8."""
    return tuple(x[..., :d] for x in _contiguous(b, s, h, hk, d + 4))


ELIGIBILITY = {
    "bf16-d128-contiguous": (lambda: _contiguous(2, 64, 8, 2, 128), True),
    "bf16-d64-contiguous": (lambda: _contiguous(1, 64, 4, 4, 64), True),
    "packed-projection-view": (lambda: _packed(2, 64, 8, 2, 128), True),
    "fp32": (lambda: _contiguous(2, 64, 8, 2, 128, torch.float32), False),
    "d72": (lambda: _contiguous(2, 64, 8, 2, 72), False),
    "d256": (lambda: _contiguous(2, 64, 8, 2, 256), False),
    "d-stride-2": (lambda: _strided_d(2, 64, 8, 2, 128), False),
    "seq-stride-not-8": (lambda: _seq_stride_4(2, 64, 1, 1, 128), False),
}


@pytest.mark.parametrize("case", ELIGIBILITY)
def test_sm90_eligible(case):
    make, want = ELIGIBILITY[case]
    q, k, v = make()
    assert fa.sm90_eligible(q, k, v) is want


def test_cpu_path_counts_no_launches_by_variant():
    q, k, v = to_torch(inputs(0, 1, 128, 8, 2, 128, "bfloat16"), "bfloat16")
    assert fa.sm90_eligible(q, k, v)
    before = (dict(fa.stats_kernel.launches_by_variant), dict(fa.attention_kernel.launches_by_variant))
    fa.flash_attention_stats(q, k, v, causal_diag=True)
    fa.flash_attention(q, k, v, causal=True)
    assert (fa.stats_kernel.launches_by_variant, fa.attention_kernel.launches_by_variant) == before
    assert set(before[0]) == {"sm90", "simt"}
