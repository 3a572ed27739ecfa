"""Port parity for the flash-attention ops (torchstore_tpu_torch.ops.flash_attention).

On the CPU both public ops take their plain versions; these tests hold them
against the JAX package's Pallas kernel in interpret mode (as its own tests
run it), on the same numpy inputs. Tolerances: rtol/atol 2e-5 on the fp32
stats (from fp32, bf16 or fp16 inputs) and fp32 outputs, as
tests/test_ring_attention.py uses (two fp32 implementations summing in other
orders); one ulp of the output type on a bf16 (rtol 2**-7) or fp16 (rtol
2**-10, atol 2**-24: one subnormal ulp) output, since both round an fp32
value that may differ in its last bits; 3e-5 on gradients, as the
reference's ring gradient test. The sm90 kernel's plain twin,
``stats_blockwise_reference``, rounds p to q's dtype before P.V; its
tolerance is derived in ``test_blockwise_reference_matches_reference`` and
``test_blockwise_reference_fp16_matches_reference``. The sm90_fp32
kernel's twin, ``stats_blockwise_reference(split="tf32x3")``, is held to
chip_smoke.py's unchanged fp32 tolerances (``FLASH_TOL`` "stats" and
"o_fp32": 1e-5 + 1e-4 |want|, acc on o's scale). Both kernels run every
head dim d <= 256 with d % 8 == 0 on their instance at 64, 128 or 256
(``padded_head_dim``), d zero-padded: the twins zero-padded the same way
(with the real d's scale) equal the unpadded ones within the fp32
tolerance, and hold at d 40, 96 and 136 against the Pallas kernel.
The CUDA kernels' own tests are in tests/test_torch_cuda.py (they need the
card).
"""

import ctypes
import importlib
import math
import re
from pathlib import Path

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
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
# One ulp of each 16-bit output type: (rtol, atol). fp16's atol is one ulp
# of its subnormals (2**-24), where rtol alone would ask for less.
OUT_ULP = {"bfloat16": dict(rtol=2.0**-7, atol=0), "float16": dict(rtol=2.0**-10, atol=2.0**-24)}


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
    elif dtype == "float16":
        arrays = [a.astype(np.float16).astype(np.float32) for a in arrays]
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
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == "float32" else OUT_ULP[dtype]
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
    q, k, v = (t.double() for t in to_torch(inputs(0, 1, 8, 2, 2, 8), "float32"))
    with pytest.raises(TypeError, match="all bfloat16 or all float16"):
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


@pytest.mark.parametrize("lengths", BLOCKWISE_LENGTHS)
@pytest.mark.parametrize("block_k", [64, 128])
@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_blockwise_reference_fp16_matches_reference(causal, heads, block_k, lengths):
    """The twin on fp16 inputs rounds p to fp16 (as the sm90 kernel does for
    fp16 calls) and is held against the JAX package the same way. Rounding
    to nearest moves a normal p_j by at most 2**-11 p_j and a subnormal one
    (p_j < 2**-14) by at most 2**-25, so o moves by at most
    2**-11 (P.|V|)_d / l + 2**-25 (sum_k |v_kd|) / l, plus 1e-5 for the
    fp32 summation order."""
    h, hk = HEADS[heads]
    sq, sk = BLOCKWISE_LENGTHS[lengths]
    arrays = inputs(17, 2, sq, h, hk, 16, "float16", sk=sk)
    if lengths == "tiled":
        want = ref.flash_attention_stats(*to_jax(arrays, "float16"), causal_diag=causal,
                                         interpret=True)
    else:
        want = ref._stats_ref(*to_jax(arrays, "float32"), causal)
    want_acc, want_m, want_l = (np.asarray(w) for w in want)
    acc, m, l = fa.stats_blockwise_reference(*to_torch(arrays, "float16"), causal, block_k)
    np.testing.assert_allclose(m.numpy(), want_m, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(l.numpy(), want_l, rtol=2e-5, atol=2e-5)
    o, want_o = acc.numpy() / l.numpy()[..., None], want_acc / want_l[..., None]
    g = h // hk
    v_sum = np.repeat(np.abs(arrays[2]).sum(axis=1), g, axis=1)  # (b, h, d)
    bound = (1e-5 + 2.0**-11 * p_abs_v_over_l(arrays, causal)
             + 2.0**-25 * v_sum[:, :, None, :] / want_l[..., None])
    assert np.all(np.abs(o - want_o) <= bound), float(np.max(np.abs(o - want_o) - bound))
    # The rounding is there: the unrounded twin sums the same tiles without it.
    unrounded = fa.stats_blockwise_reference(*to_torch(arrays, "float16"), causal, block_k,
                                             _round_p=False)
    assert not torch.equal(acc, unrounded[0])


@pytest.mark.parametrize("d", fa.SM90_HEAD_DIMS + (40, 96, 136))
def test_blockwise_reference_defaults_to_kernel_block_k(d):
    """Without ``block_k`` the twin tiles k as the sm90 kernel does at this
    head_dim (64 keys on the d = 256 instance, 128 below; a head dim between
    the instances takes the one it runs on), so the chip checks hold each
    instance against its own arithmetic."""
    q, k, v = to_torch(inputs(18, 1, 40, 2, 2, d, "bfloat16", sk=300), "bfloat16")
    block_k = fa.SM90_BLOCK_K[fa.padded_head_dim(d)]
    got = fa.stats_blockwise_reference(q, k, v)
    want = fa.stats_blockwise_reference(q, k, v, False, block_k)
    other = fa.stats_blockwise_reference(q, k, v, False, 192 - block_k)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not torch.equal(got[0], other[0])
    assert torch.equal(fa.attention_blockwise_reference(q, k, v),
                       fa._normalize(want[0], want[2], q.dtype))


def _kernel_source(name):
    return (Path(fa.__file__).parent.parent / "csrc" / name).read_text()


def _dispatch_rule(src):
    """The head dim of the instance ``dispatch_d`` launches for a call at
    ``d``: ``if (c.d > a) return launch<..., A, ...>`` arms in order, then
    the last ``return launch<..., B, ...>``."""
    body = re.search(r"int dispatch_d\(.*?\n\}", src, re.S)
    assert body is not None
    arms = [(int(a), int(x)) for a, x in
            re.findall(r"if \(c\.d > (\d+)\) return launch<(?:T, )?(\d+),", body.group(0))]
    last = re.findall(r"\n  return launch<(?:T, )?(\d+),", body.group(0))
    assert arms and len(last) == 1
    return lambda d: next((x for a, x in arms if d > a), int(last[0]))


def _head_dim_check(src):
    """(largest head dim, multiple) of the entry point's kBadHeadDim check,
    ``if (d <= 0 || d > N || d % M != 0) return kBadHeadDim;``."""
    found = re.search(r"if \(d <= 0 \|\| d > (\d+) \|\| d % (\d+) != 0\) return kBadHeadDim;",
                      src)
    assert found is not None
    return tuple(int(x) for x in found.groups())


@pytest.mark.parametrize("source", ["flash_attention_sm90.cu", "flash_attention_sm90_fp32.cu"])
def test_padded_dispatch_matches_kernel_source(source):
    """Both tensor-core kernels take every d % 8 == 0 up to 256 at their
    entry point and launch the instance ``padded_head_dim`` names."""
    src = _kernel_source(source)
    assert _head_dim_check(src) == (fa.MAX_HEAD_DIM, 8)
    rule = _dispatch_rule(src)
    assert {d: rule(d) for d in range(8, 257, 8)} == \
        {d: fa.padded_head_dim(d) for d in range(8, 257, 8)}


def test_sm90_block_k_matches_kernel_source():
    """SM90_BLOCK_K repeats the kernel's Tiling<D>::kBK, at the instances
    its entry point's head-dim check and padded dispatch reach."""
    src = _kernel_source("flash_attention_sm90.cu")
    found = re.search(r"kBK = D == (\d+) \? (\d+) : (\d+);", src)
    assert found is not None
    at, then, other = (int(x) for x in found.groups())
    assert {d: then if d == at else other for d in fa.SM90_HEAD_DIMS} == fa.SM90_BLOCK_K
    largest, multiple = _head_dim_check(src)
    rule = _dispatch_rule(src)
    assert {rule(d) for d in range(multiple, largest + 1, multiple)} == set(fa.SM90_HEAD_DIMS)


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "float*": ctypes.c_void_p,
            "int": ctypes.c_int, "int64_t": ctypes.c_int64, "float": ctypes.c_float}


@pytest.mark.parametrize("variant", ["simt", "sm90", "sm90_fp32"])
def test_ctypes_signature_matches_kernel_source(variant):
    """Each library's argtypes follow its C entry point's parameter list."""
    lib = fa._LIBS[variant]
    src = lib.source.read_text()
    found = re.search(r'extern "C" int ' + lib.symbol + r"\(([^)]*)\)", src)
    assert found is not None
    params = [" ".join(p.split()[:-1]) for p in found.group(1).split(",")]
    params = [p.replace(" *", "*") for p in params]
    assert [_C_TYPES[p] for p in params] == lib.argtypes


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


def _seq_stride_4(b, s, h, hk, d, dtype=torch.bfloat16):
    """Head dim 128 cut from rows of 132: the sequence stride is 132
    elements, not a multiple of 8."""
    return tuple(x[..., :d] for x in _contiguous(b, s, h, hk, d + 4, dtype))


ELIGIBILITY = {
    "bf16-d128-contiguous": (lambda: _contiguous(2, 64, 8, 2, 128), True),
    "bf16-d64-contiguous": (lambda: _contiguous(1, 64, 4, 4, 64), True),
    "packed-projection-view": (lambda: _packed(2, 64, 8, 2, 128), True),
    "fp32": (lambda: _contiguous(2, 64, 8, 2, 128, torch.float32), False),
    "d72": (lambda: _contiguous(2, 64, 8, 2, 72), True),
    "d256": (lambda: _contiguous(2, 64, 8, 2, 256), True),
    "d-stride-2": (lambda: _strided_d(2, 64, 8, 2, 128), False),
    "seq-stride-not-8": (lambda: _seq_stride_4(2, 64, 1, 1, 128), False),
    "fp16-d256": (lambda: _contiguous(1, 64, 16, 16, 256, torch.float16), True),
    "fp16-d64": (lambda: _contiguous(2, 64, 8, 2, 64, torch.float16), True),
    "fp16-d72": (lambda: _contiguous(2, 64, 8, 2, 72, torch.float16), True),
    "fp16-seq-stride-not-8": (
        lambda: _seq_stride_4(2, 64, 1, 1, 128, torch.float16), False),
    "mixed-bf16-fp16": (
        lambda: (*_contiguous(2, 64, 8, 2, 128)[:2],
                 _contiguous(2, 64, 8, 2, 128, torch.float16)[2]),
        False),
}


@pytest.mark.parametrize("case", ELIGIBILITY)
def test_sm90_eligible(case):
    make, want = ELIGIBILITY[case]
    q, k, v = make()
    assert fa.sm90_eligible(q, k, v) is want


def test_cpu_path_counts_no_launches_by_variant():
    before = (dict(fa.stats_kernel.launches_by_variant), dict(fa.attention_kernel.launches_by_variant))
    for dtype, variant in (("bfloat16", "sm90"), ("float32", "sm90_fp32")):
        q, k, v = to_torch(inputs(0, 1, 128, 8, 2, 128, dtype), dtype)
        assert fa.flash_variant(q, k, v) == variant
        fa.flash_attention_stats(q, k, v, causal_diag=True)
        fa.flash_attention(q, k, v, causal=True)
    assert (fa.stats_kernel.launches_by_variant, fa.attention_kernel.launches_by_variant) == before
    assert set(before[0]) == set(before[1]) == {"sm90", "sm90_fp32", "simt"}


def _misaligned(b, s, h, hk, d, dtype=torch.float32):
    """Contiguous views one element past a 16-byte aligned base: 4 bytes
    off in fp32."""
    shapes = ((b, s, h, d), (b, s, hk, d), (b, s, hk, d))
    return tuple(torch.zeros(math.prod(shape) + 1, dtype=dtype)[1:].view(shape)
                 for shape in shapes)


def _seq_stride_2(b, s, h, hk, d, dtype=torch.float32):
    """Head dim ``d`` cut from rows of d + 2 (130 at d = 128): with one head
    the sequence stride is d + 2 elements, not a multiple of 4."""
    return tuple(x[..., :d] for x in _contiguous(b, s, h, hk, d + 2, dtype))


# case: (make, the variant the three-way rule picks).
ROUTES = {
    "fp32-d128-gqa": (lambda: _contiguous(2, 64, 8, 2, 128, torch.float32), "sm90_fp32"),
    "fp32-d64-mha": (lambda: _contiguous(1, 64, 4, 4, 64, torch.float32), "sm90_fp32"),
    "fp32-packed-projection-view": (
        lambda: (lambda qkv: (qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]))(
            torch.zeros((2, 64, 12, 128))), "sm90_fp32"),
    "fp32-seq-stride-132": (lambda: _seq_stride_4(2, 64, 1, 1, 128, torch.float32), "sm90_fp32"),
    "fp32-d256": (lambda: _contiguous(1, 64, 16, 16, 256, torch.float32), "sm90_fp32"),
    "fp32-d256-gqa": (lambda: _contiguous(2, 64, 8, 2, 256, torch.float32), "sm90_fp32"),
    "fp32-d256-packed-projection-view": (
        lambda: (lambda qkv: (qkv[:, :, :16], qkv[:, :, 16:32], qkv[:, :, 32:]))(
            torch.zeros((1, 64, 48, 256))), "sm90_fp32"),
    "fp32-d72": (lambda: _contiguous(2, 64, 8, 2, 72, torch.float32), "sm90_fp32"),
    "fp32-d96": (lambda: _contiguous(2, 64, 8, 2, 96, torch.float32), "sm90_fp32"),
    "fp32-seq-stride-130": (lambda: _seq_stride_2(2, 64, 1, 1, 128), "simt"),
    "fp32-d256-seq-stride-258": (lambda: _seq_stride_2(1, 64, 1, 1, 256), "simt"),
    "fp32-d256-misaligned-base": (lambda: _misaligned(1, 64, 16, 16, 256), "simt"),
    "fp32-misaligned-base": (lambda: _misaligned(1, 64, 4, 4, 64), "simt"),
    "fp32-d-stride-2": (
        lambda: tuple(x[..., ::2] for x in _contiguous(2, 64, 8, 2, 256, torch.float32)), "simt"),
    "bf16-d128": (lambda: _contiguous(2, 64, 8, 2, 128), "sm90"),
    "bf16-d256": (lambda: _contiguous(2, 64, 8, 2, 256), "sm90"),
    "bf16-d72": (lambda: _contiguous(2, 64, 8, 2, 72), "sm90"),
    "bf16-d96": (lambda: _contiguous(1, 64, 32, 32, 96), "sm90"),
    "fp16-d64": (lambda: _contiguous(2, 64, 8, 2, 64, torch.float16), "sm90"),
    "fp16-seq-stride-not-8": (lambda: _seq_stride_4(2, 64, 1, 1, 128, torch.float16), "simt"),
    "mixed-fp32-bf16": (
        lambda: (*_contiguous(2, 64, 8, 2, 128, torch.float32)[:2],
                 _contiguous(2, 64, 8, 2, 128)[2]), "simt"),
    # Head dims between the instances, zero-padded onto the next one up;
    # the same head dims with strides or a base TMA refuses stay on simt.
    **{f"{name}-d{d}": (lambda d=d, dtype=dtype: _contiguous(2, 64, 8, 2, d, dtype), variant)
       for name, dtype, variant in (("fp32", torch.float32, "sm90_fp32"),
                                    ("bf16", torch.bfloat16, "sm90"),
                                    ("fp16", torch.float16, "sm90"))
       for d in (8, 40, 136, 248)},
    "fp32-d96-seq-stride-98": (lambda: _seq_stride_2(1, 64, 1, 1, 96), "simt"),
    "bf16-d96-seq-stride-98": (lambda: _seq_stride_2(1, 64, 1, 1, 96, torch.bfloat16), "simt"),
    "fp16-d40-seq-stride-44": (lambda: _seq_stride_4(1, 64, 1, 1, 40, torch.float16), "simt"),
    "fp32-d40-misaligned-base": (lambda: _misaligned(1, 64, 4, 4, 40), "simt"),
    "bf16-d96-misaligned-base": (lambda: _misaligned(1, 64, 4, 4, 96, torch.bfloat16), "simt"),
}


@pytest.mark.parametrize("case", ROUTES)
def test_flash_variant_three_way_route(case):
    """sm90 first, then sm90_fp32, else simt; each rule alone agrees."""
    make, want = ROUTES[case]
    q, k, v = make()
    assert fa.flash_variant(q, k, v) == want
    assert fa.sm90_eligible(q, k, v) is (want == "sm90")
    assert fa.sm90_fp32_eligible(q, k, v) is (want == "sm90_fp32")


@pytest.mark.parametrize("d", range(8, 257, 8))
def test_padded_head_dim(d):
    """The instance a head dim runs on: the next of 64, 128 and 256."""
    want = 64 if d <= 64 else 128 if d <= 128 else 256
    assert fa.padded_head_dim(d) == want
    assert fa._tensor_core_shape(*_contiguous(1, 8, 2, 2, d), fa.SM90_DTYPES)


def test_padded_head_dim_refuses_what_no_kernel_takes():
    for d in (0, 4, 12, 100, 264):
        with pytest.raises(ValueError, match="head_dim"):
            fa.padded_head_dim(d)
        assert not fa._tensor_core_shape(*_contiguous(1, 8, 2, 2, d), fa.SM90_DTYPES)


def _zero_padded(x, width):
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))


# (dtype, split): the sm90 twin in bf16 (p rounded to bf16), its unrounded
# fp32 form, and the sm90_fp32 twin (3xTF32).
PADDED_TWINS = {"bf16": ("bfloat16", None), "fp32": ("float32", None),
                "fp32-tf32x3": ("float32", "tf32x3")}


@pytest.mark.parametrize("d", [8, 40, 72, 96, 136, 200, 248])
@pytest.mark.parametrize("twin", PADDED_TWINS)
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_zero_padded_twin_equals_unpadded(causal, twin, d):
    """The kernels' padded arithmetic on the CPU: q, k, v zero-padded to the
    instance's head dim, with the real d's scale, give the unpadded twin's
    m and l and, sliced back to d, its acc, within the fp32 tolerance
    (1e-5 + 1e-4 |want|, acc on o's scale); the padded columns of acc are
    zero."""
    dtype, split = PADDED_TWINS[twin]
    q, k, v = to_torch(inputs(40 + d, 1, 70, 8, 2, d, dtype, sk=150), dtype)
    width = fa.padded_head_dim(d)
    kwargs = {"_round_p": split is None and dtype != "float32", "split": split}
    want = fa.stats_blockwise_reference(q, k, v, causal, **kwargs)
    got = fa.stats_blockwise_reference(*(_zero_padded(x, width) for x in (q, k, v)), causal,
                                       scale=1.0 / math.sqrt(d), **kwargs)
    assert got[0].shape[-1] == width
    assert not got[0][..., d:].any()
    scale = want[2][..., None].numpy()
    assert _fp32_within(got[0][..., :d].numpy(), want[0].numpy(), scale) == 0
    assert _fp32_within(got[1].numpy(), want[1].numpy()) == 0
    assert _fp32_within(got[2].numpy(), want[2].numpy()) == 0


@pytest.mark.parametrize("d", [40, 96, 136])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_padded_twin_matches_pallas_kernel(causal, dtype, d):
    """At head dims the kernels pad, each kernel's twin against the JAX
    package's Pallas kernel in interpret mode: the sm90 twin on bf16 inputs
    within the bound of ``test_blockwise_reference_matches_reference`` (p
    rounded to bf16), the sm90_fp32 twin (3xTF32) on fp32 inputs within the
    fp32 tolerances."""
    h, hk = HEADS["gqa"]
    arrays = inputs(50 + d, 2, 128, h, hk, d, dtype)
    q, k, v = to_torch(arrays, dtype)
    want = [np.asarray(w) for w in ref.flash_attention_stats(
        *to_jax(arrays, "float32"), causal_diag=causal, interpret=True)]
    if dtype == "float32":
        got = fa.stats_blockwise_reference(q, k, v, causal, _round_p=False, split="tf32x3")
        assert _fp32_within(got[0].numpy(), want[0], want[2][..., None]) == 0
        assert _fp32_within(got[1].numpy(), want[1]) == 0
        assert _fp32_within(got[2].numpy(), want[2]) == 0
        return
    acc, m, l = fa.stats_blockwise_reference(q, k, v, causal)
    np.testing.assert_allclose(m.numpy(), want[1], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(l.numpy(), want[2], rtol=2e-5, atol=2e-5)
    o, want_o = acc.numpy() / l.numpy()[..., None], want[0] / want[2][..., None]
    bound = 1e-5 + 2.0**-8 * p_abs_v_over_l(arrays, causal)
    assert np.all(np.abs(o - want_o) <= bound), float(np.max(np.abs(o - want_o) - bound))


def test_tf32_split_rounds_to_nearest_ties_away():
    """``_tf32`` keeps 10 explicit mantissa bits, rounding to nearest with
    ties away from zero (cvt.rna.tf32.f32), and hi + lo restores x to
    within 2**-22 |x|."""
    bits = np.array([0x3F800000, 0x3F801000, 0x3F800FFF, 0x3F803000, 0xBF801000, 0xBF800FFF,
                     0x00001000, 0x7F7FE000], dtype=np.uint32)
    want = np.array([0x3F800000, 0x3F802000, 0x3F800000, 0x3F804000, 0xBF802000, 0xBF800000,
                     0x00002000, 0x7F7FE000], dtype=np.uint32)
    x = torch.from_numpy(bits.view(np.float32).copy())
    got = fa._tf32(x).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    y = torch.from_numpy(np.random.default_rng(19).standard_normal(4096).astype(np.float32))
    hi, lo = fa.tf32_split(y)
    for part in (hi, lo):
        assert not (part.numpy().view(np.uint32) & 0x1FFF).any()
    assert bool(((hi + lo - y).abs() <= 2.0**-22 * y.abs()).all())
    assert bool(((hi - y).abs() > 2.0**-22 * y.abs()).any())  # hi alone is not enough


def _fp32_within(got, want, scale=None):
    """Values outside chip_smoke.py's fp32 tolerance, 1e-5 + 1e-4 |want|,
    each side divided by ``scale`` first where given."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if scale is not None:
        got, want = got / scale, want / scale
    return int(np.sum(np.abs(got - want) > 1e-5 + 1e-4 * np.abs(want)))


@pytest.mark.parametrize("d", fa.SM90_FP32_HEAD_DIMS)
@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("mode", ["stats", "normalized"])
def test_tf32x3_twin_matches_pallas_kernel(mode, causal, heads, d):
    """The sm90_fp32 kernel's plain twin on fp32 inputs against the JAX
    package's Pallas kernel in interpret mode: within the unchanged fp32
    tolerances, though q, k, p and v each pass through the TF32 split."""
    h, hk = HEADS[heads]
    arrays = inputs(20 + d, 2, 128, h, hk, d)
    q, k, v = to_torch(arrays, "float32")
    if mode == "stats":
        want = [np.asarray(w) for w in ref.flash_attention_stats(
            *to_jax(arrays, "float32"), causal_diag=causal, interpret=True)]
        got = fa.stats_blockwise_reference(q, k, v, causal, _round_p=False, split="tf32x3")
        scale = want[2][..., None]
        assert _fp32_within(got[0].numpy(), want[0], scale) == 0
        assert _fp32_within(got[1].numpy(), want[1]) == 0
        assert _fp32_within(got[2].numpy(), want[2]) == 0
    else:
        want = np.asarray(ref.flash_attention(*to_jax(arrays, "float32"), causal=causal,
                                              interpret=True))
        got = fa.attention_blockwise_reference(q, k, v, causal, split="tf32x3")
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        assert _fp32_within(got.numpy(), want) == 0


@pytest.mark.parametrize("d", fa.SM90_FP32_HEAD_DIMS)
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_tf32x3_twin_with_split_off_equals_unrounded_blockwise(causal, d, monkeypatch):
    """With the split off (hi = x, lo = 0) the twin's three passes add exact
    zeros to one fp32 product, so it equals the unrounded blockwise twin at
    the same k-tile bit for bit; with the split on it differs."""
    q, k, v = to_torch(inputs(21, 1, 100, 8, 2, d, sk=300), "float32")
    block_k = fa.SM90_FP32_BLOCK_K[d]
    split_on = fa.stats_blockwise_reference(q, k, v, causal, _round_p=False, split="tf32x3")
    want = fa.stats_blockwise_reference(q, k, v, causal, block_k, _round_p=False)
    monkeypatch.setattr(fa, "tf32_split", lambda x: (x.float(), torch.zeros_like(x.float())))
    got = fa.stats_blockwise_reference(q, k, v, causal, _round_p=False, split="tf32x3")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not torch.equal(split_on[0], want[0])


def test_tf32x3_twin_refuses_rounded_p_and_unknown_splits():
    q, k, v = to_torch(inputs(0, 1, 8, 2, 2, 64), "float32")
    with pytest.raises(ValueError, match="_round_p=False"):
        fa.stats_blockwise_reference(q, k, v, split="tf32x3")
    with pytest.raises(ValueError, match="split"):
        fa.stats_blockwise_reference(q, k, v, _round_p=False, split="tf32x2")


def _conditional_chain(src, name):
    """``name = D == a ? x : D == b ? y : z;`` in ``src`` as a function of
    D."""
    found = re.search(name + r" = ((?:D == \d+ \? \d+ : )+)(\d+);", src)
    assert found is not None, name
    arms = [(int(a), int(x)) for a, x in re.findall(r"D == (\d+) \? (\d+)", found.group(1))]
    return lambda d: next((x for a, x in arms if a == d), int(found.group(2)))


def test_sm90_fp32_tiling_matches_kernel_source():
    """SM90_FP32_BLOCK_K repeats the fp32 kernel's Tiling<D>::kBK, and
    SM90_FP32_HEAD_DIMS the instances its entry point's head-dim check
    (every d % 8 == 0 up to 256) and padded dispatch reach; the twin's
    default k-tile is the kernel's at each of them and at the head dims
    padded to them."""
    src = _kernel_source("flash_attention_sm90_fp32.cu")
    block_k = _conditional_chain(src, "kBK")
    assert {d: block_k(d) for d in fa.SM90_FP32_HEAD_DIMS} == fa.SM90_FP32_BLOCK_K
    largest, multiple = _head_dim_check(src)
    assert (largest, multiple) == (fa.MAX_HEAD_DIM, 8)
    rule = _dispatch_rule(src)
    assert {rule(d) for d in range(multiple, largest + 1, multiple)} == \
        set(fa.SM90_FP32_HEAD_DIMS)
    for d in fa.SM90_FP32_HEAD_DIMS + (40, 96, 136):
        q, k, v = to_torch(inputs(18, 1, 40, 2, 2, d, sk=300), "float32")
        got = fa.stats_blockwise_reference(q, k, v, _round_p=False, split="tf32x3")
        want = fa.stats_blockwise_reference(q, k, v, False, fa.SM90_FP32_BLOCK_K[rule(d)],
                                            _round_p=False, split="tf32x3")
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_sm90_fp32_q_tile_matches_kernel_source():
    """The kernel's q-tile rows, registers and stages per head dim
    (Tiling<D>): at d = 256 one consumer warpgroup of 64 rows with 240
    registers over one stage refilled by halves; the d = 64 and 128
    instances keep their 128-row tiles, 232 registers and two stages."""
    src = (Path(fa.__file__).parent.parent / "csrc" / "flash_attention_sm90_fp32.cu").read_text()
    tiling = {name: _conditional_chain(src, name) for name in ("kBQ", "kConsumerRegs", "kStages")}
    got = {d: tuple(f(d) for f in tiling.values()) for d in fa.SM90_FP32_HEAD_DIMS}
    assert got == {64: (128, 232, 2), 128: (128, 232, 2), 256: (64, 240, 1)}


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("mode", ["stats", "normalized"])
def test_tf32x3_twin_at_d256_ragged_matches_pallas_kernel(mode, causal):
    """At d = 256 the twin's 32-key tiles leave a ragged last tile (296 keys)
    and the kernel's 64-row q-tiles a ragged last one (136 rows); the twin
    stays within the fp32 tolerances of the JAX kernel in interpret mode,
    GQA and all."""
    arrays = inputs(31, 1, 136, 4, 2, 256, sk=136 if causal else 296)
    q, k, v = to_torch(arrays, "float32")
    assert fa.flash_variant(q, k, v) == "sm90_fp32"
    if mode == "stats":
        want = [np.asarray(w) for w in ref.flash_attention_stats(
            *to_jax(arrays, "float32"), causal_diag=causal, interpret=True)]
        got = fa.stats_blockwise_reference(q, k, v, causal, _round_p=False, split="tf32x3")
        assert _fp32_within(got[0].numpy(), want[0], want[2][..., None]) == 0
        assert _fp32_within(got[1].numpy(), want[1]) == 0
        assert _fp32_within(got[2].numpy(), want[2]) == 0
    else:
        want = np.asarray(ref.flash_attention(*to_jax(arrays, "float32"), causal=causal,
                                              block_q=8, block_k=8, interpret=True))
        got = fa.attention_blockwise_reference(q, k, v, causal, split="tf32x3")
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        assert _fp32_within(got.numpy(), want) == 0
