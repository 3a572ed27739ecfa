"""The port's flash kernel against its plain versions on an NVIDIA GPU.

This file imports torch, numpy and the port only (no JAX), so it runs on a
machine with the card:

    python -m pytest -o addopts="" -m cuda tests/test_torch_cuda.py -q

Without a card every test skips. Tolerances as chip_smoke.py's
flash_parity phase: m, l and o within 1e-5 + 1e-4 |want| (o in bf16 within
1e-5 + 2**-7 |want|, about two bf16 ulps), acc the same after dividing by
the plain version's l (acc sums sk terms whose magnitudes add up to ~l).
"""

import importlib

import numpy as np
import pytest
import torch

fa = importlib.import_module("torchstore_tpu_torch.ops.flash_attention")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def qkv(seed, b, sq, sk, h, hk, d, dtype, device):
    rng = np.random.default_rng(seed)
    shapes = ((b, sq, h, d), (b, sk, hk, d), (b, sk, hk, d))
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(device, dtype)
            for s in shapes]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("shape", [(1, 200, 333, 8, 2, 64), (2, 130, 130, 4, 4, 256),
                                   (1, 77, 40, 6, 3, 72)])
def test_kernel_matches_plain_version_on_cuda(cuda, shape, causal, dtype):
    b, sq, sk, h, hk, d = shape
    q, k, v = qkv(9, b, sq, sk, h, hk, d, dtype, cuda)
    before = (fa.stats_kernel.launches, fa.attention_kernel.launches)
    acc, m, l = fa.flash_attention_stats(q, k, v, causal_diag=causal)
    want_acc, want_m, want_l = fa.stats_reference(q, k, v, causal)
    o = fa.flash_attention(q, k, v, causal=causal)
    want_o = fa.attention_reference(q, k, v, causal)
    assert (fa.stats_kernel.launches, fa.attention_kernel.launches) == (before[0] + 1,
                                                                          before[1] + 1)
    norm = want_l[..., None]
    torch.testing.assert_close(acc / norm, want_acc / norm, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(m, want_m, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(l, want_l, rtol=1e-4, atol=1e-5)
    assert o.dtype == dtype and o.shape == q.shape
    rtol = 1e-4 if dtype == torch.float32 else 2.0**-7
    torch.testing.assert_close(o.float(), want_o.float(), rtol=rtol, atol=1e-5)


@pytest.mark.cuda
def test_stats_backward_recomputes_through_plain_version(cuda):
    q, k, v = (t.requires_grad_() for t in qkv(3, 1, 96, 96, 4, 2, 32, torch.float32, cuda))
    outs = fa.flash_attention_stats(q, k, v, causal_diag=True)
    cts = [torch.randn_like(t) for t in outs]
    got = torch.autograd.grad(outs, (q, k, v), cts)
    want = torch.autograd.grad(fa.stats_reference(q, k, v, True), (q, k, v), cts)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_kernel_refuses_strided_head_dim(cuda):
    q, k, v = qkv(0, 1, 16, 16, 2, 2, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fa.stats_kernel(q[..., ::2], k[..., ::2], v[..., ::2], False)
