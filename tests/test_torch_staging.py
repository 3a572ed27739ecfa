"""Port parity for the transfer-dtype cast (torchstore_tpu_torch.ops.staging).

On the CPU ``device_cast`` takes its plain version; these tests hold it
against the reference's Pallas kernel ``pallas_cast`` (interpret mode, as
the reference's own tests run it) at 1024-aligned sizes, and against the
reference's ``device_cast`` at sizes the Pallas kernel does not tile.
Tolerance: bit-equal outside NaN, NaN positions equal (NaN payloads differ
between frameworks). The CUDA kernel's own tests need a GPU and skip here.
"""

import math
import os
import shutil

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from torchstore_tpu.ops import device_cast as ref_device_cast
from torchstore_tpu.ops import pallas_cast
from torchstore_tpu_torch.ops import staging

JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}
NP = {torch.float32: np.float32, torch.bfloat16: ml_dtypes.bfloat16, torch.float16: np.float16}
BITS = {4: (torch.int32, np.uint32), 2: (torch.int16, np.uint16)}

F32_SPECIAL = [
    0.0, -0.0, math.inf, -math.inf, math.nan, 1e-45, -1e-45, 1e-40, 1.17549435e-38,
    3.4028235e38, -3.4028235e38, 65504.0, 65519.0, 65520.0, -65520.0, 65536.0,
    6.1035156e-05, 6.0e-05, 5.9604645e-08, 2.9802322e-08, 1e-8, 1.0 + 2.0**-11,
    1.0 + 3 * 2.0**-11, 3.3895314e38, 3.3961775e38, 1.0, -1.0, 0.1,
]
# Exact bf16 rounding ties, NaN payloads, the largest finite value.
F32_SPECIAL_BITS = [
    0x3F808000, 0x3F818000, 0x3F80C000, 0x00008000, 0x7F7F8000, 0x7F7FFFFF,
    0x7FC00000, 0xFFC00000, 0x7F800001,
]


def f32_inputs(n: int, seed: int) -> np.ndarray:
    """``n`` float32 values: the special values first, then random bit
    patterns (every class of float32 appears)."""
    rng = np.random.default_rng(seed)
    out = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32).view(np.float32)
    special = np.concatenate(
        [np.array(F32_SPECIAL, np.float32), np.array(F32_SPECIAL_BITS, np.uint32).view(np.float32)]
    )
    k = min(n, special.size)
    out[:k] = special[:k]
    return out


def all_16bit(dtype: torch.dtype) -> np.ndarray:
    return np.arange(1 << 16, dtype=np.uint32).astype(np.uint16).view(NP[dtype])


def assert_cast_equal(port: torch.Tensor, ref: np.ndarray) -> None:
    """Bit-equal outside NaN; NaN positions equal."""
    int_t, np_bits = BITS[port.element_size()]
    port_bits = port.contiguous().view(int_t).numpy().view(np_bits).reshape(-1)
    ref = np.asarray(ref).reshape(-1)
    ref_bits = ref.view(np_bits)
    port_nan = torch.isnan(port.float()).numpy().reshape(-1)
    ref_nan = np.isnan(ref.astype(np.float32))
    np.testing.assert_array_equal(port_nan, ref_nan)
    keep = ~ref_nan
    mism = np.nonzero(port_bits[keep] != ref_bits[keep])[0]
    assert mism.size == 0, (
        f"{mism.size} bit mismatches, first at {mism[:5]}: "
        f"port {port_bits[keep][mism[:5]]} ref {ref_bits[keep][mism[:5]]}"
    )


@pytest.mark.parametrize("dst", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("n", [1024, 8 * 1024])
def test_cpu_cast_matches_pallas_kernel(dst, n):
    x = f32_inputs(n, seed=n)
    ref = np.asarray(pallas_cast(jnp.asarray(x.reshape(-1, 128)), JNP[dst], interpret=True))
    before = staging.cast_kernel.launches
    port = staging.device_cast(torch.from_numpy(x.copy()).reshape(-1, 128), dst)
    assert staging.cast_kernel.launches == before  # the CPU path launches nothing
    assert port.dtype == dst and tuple(port.shape) == ref.shape
    assert_cast_equal(port, ref)


@pytest.mark.parametrize("n", [1, 7, 1023, 1025])
@pytest.mark.parametrize("src,dst", staging.PAIRS, ids=str)
def test_cpu_cast_matches_reference_device_cast(src, dst, n):
    if src == torch.float32:
        x = f32_inputs(n, seed=n)
    else:
        x = all_16bit(src)[np.random.default_rng(n).permutation(1 << 16)[:n]]
    ref = np.asarray(ref_device_cast(jnp.asarray(x), NP[dst]))
    src_t = torch.from_numpy(np.ascontiguousarray(x).view(BITS[x.itemsize][1]).copy())
    src_t = src_t.view(BITS[x.itemsize][0]).view(src)
    assert_cast_equal(staging.device_cast(src_t, dst), ref)


@pytest.mark.parametrize("src,dst", [p for p in staging.PAIRS if p[0] != torch.float32], ids=str)
def test_cpu_cast_every_16bit_pattern(src, dst):
    x = all_16bit(src)
    ref = np.asarray(pallas_cast(jnp.asarray(x.reshape(-1, 128)), JNP[dst], interpret=True))
    src_t = torch.from_numpy(x.view(np.uint16).copy()).view(torch.int16).view(src)
    assert_cast_equal(staging.device_cast(src_t.reshape(-1, 128), dst), ref)


def test_kernel_refuses_uncovered_pair():
    with pytest.raises(TypeError, match="does not cover"):
        staging.cast_kernel(torch.zeros(4, dtype=torch.float64), torch.float32)


def test_kernel_refuses_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA"):
        staging.cast_kernel(torch.zeros(4), torch.bfloat16)


def test_build_without_nvcc_raises():
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is present: the build would succeed")
    with pytest.raises(RuntimeError, match="nvcc"):
        staging.CastKernel().build()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_kernel_refuses_non_contiguous_cuda_input(cuda):
    x = torch.zeros(8, 8, device=cuda).t()
    with pytest.raises(ValueError, match="contiguous"):
        staging.device_cast(x, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("src,dst", staging.PAIRS, ids=str)
def test_kernel_matches_plain_version_on_cuda(cuda, src, dst):
    if src == torch.float32:
        x = torch.from_numpy(f32_inputs(4096 * 1024 + 3, seed=3))
    else:
        x = torch.from_numpy(all_16bit(src).view(np.uint16).copy()).view(torch.int16).view(src)
    x = x.to(cuda)
    before = staging.cast_kernel.launches
    for view in (x, x[1:]):  # aligned, then misaligned
        got = staging.device_cast(view, dst)
        want = staging.cast_reference(view, dst)
        assert_cast_equal(got.cpu(), want.cpu().numpy() if dst != torch.bfloat16 else
                          want.cpu().view(torch.int16).numpy().view(ml_dtypes.bfloat16))
    assert staging.cast_kernel.launches == before + 2
