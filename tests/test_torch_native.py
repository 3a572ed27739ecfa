"""The port's native host copies (csrc/host_copy.cc, built by g++ at first
use) against the JAX package's native library and against Tensor.copy_,
on the same seeded numpy bytes: the native half of test_native_and_ops.py.
Also the no-broadcast refusal, host landings on the pool path, the
prefault of fresh receive buffers and provisioned segments, and that a
failed build raises while the gate is on (and that only turning the gate
off gives the torch copies)."""

import asyncio

import numpy as np
import pytest
import torch

from torchstore_tpu import native as ref_native
from torchstore_tpu_torch import config as port_config
from torchstore_tpu_torch import native
from torchstore_tpu_torch.observability import metrics
from torchstore_tpu_torch.transport import bulk, landing
from torchstore_tpu_torch.transport.shared_memory import ShmSegment


def calls(op=None) -> float:
    c = metrics.counter("ts_native_calls_total")
    return c.total() if op is None else c.value(op=op)


def seeded(shape, dtype=np.float32, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(dtype)


def test_built_from_the_port_source_into_build_dir():
    lib = native.get_lib()
    assert lib is not None and lib.ts_version() == 3
    path = native.lib_path()
    assert path.parent == native.BUILD_DIR and path.exists()
    assert native.SOURCE.name == "host_copy.cc" and native.SOURCE.parent.name == "csrc"
    assert "libtsnative" not in path.name


@pytest.mark.parametrize("n", [4 * 1024 * 1024, 16, 3 * 1024 * 1024 + 7],
                         ids=["16MB", "small", "ragged"])
def test_fast_copy_equals_reference_and_copy_(n):
    src_np = seeded(n)
    ref_dst = np.empty_like(src_np)
    ref_native.fast_copy(ref_dst, src_np)
    before = calls("parallel_memcpy")
    src = torch.from_numpy(src_np.copy())
    dst = torch.empty_like(src)
    native.fast_copy(dst, src)
    assert np.array_equal(dst.numpy().view(np.uint32), ref_dst.view(np.uint32))
    plain = torch.empty_like(src)
    plain.copy_(src)
    assert torch.equal(dst, plain)
    big = n * 4 >= native.PARALLEL_THRESHOLD
    assert calls("parallel_memcpy") - before == (1 if big else 0)


def test_fast_copy_dtype_mismatch_casts_like_the_reference():
    src_np = np.arange(16, dtype=np.int64)
    ref_dst = np.zeros(16, dtype=np.float64)
    ref_native.fast_copy(ref_dst, src_np)
    dst = torch.zeros(16, dtype=torch.float64)
    native.fast_copy(dst, torch.from_numpy(src_np))
    assert np.array_equal(dst.numpy(), ref_dst)


@pytest.mark.parametrize("fn", ["fast_copy", "copy_into"])
def test_landing_copy_never_broadcasts(fn):
    with pytest.raises(ValueError, match="shape mismatch") as ref_err:
        getattr(ref_native, fn)(np.zeros((4, 4)), np.zeros((4,)))
    with pytest.raises(ValueError, match="shape mismatch") as port_err:
        getattr(native, fn)(torch.zeros(4, 4), torch.zeros(4))
    assert str(port_err.value) == str(ref_err.value)


def test_copy_2d_strided_equals_reference():
    base_np = seeded((4096, 1024))
    ref_base = np.zeros_like(base_np)
    ref_native.fast_copy_2d(ref_base[:, :512], base_np[:, :512])
    base = torch.from_numpy(base_np.copy())
    dst_base = torch.zeros_like(base)
    before = calls("copy_2d")
    assert native.fast_copy_2d(dst_base[:, :512], base[:, :512])
    assert calls("copy_2d") - before == 1
    assert np.array_equal(dst_base.numpy(), ref_base)
    assert dst_base[:, 512:].abs().sum() == 0  # untouched outside the block
    # copy_into takes the strided path for the same pair.
    again = torch.zeros_like(base)
    native.copy_into(again[:, :512], base[:, :512])
    assert torch.equal(again, dst_base)
    # Below the size threshold the 2D path declines, as the reference's.
    small = torch.zeros(8, 8)
    assert native.fast_copy_2d(small[:, :4], base[:8, :4]) is False
    assert ref_native.fast_copy_2d(np.zeros((8, 8))[:, :4], base_np[:8, :4]) is False


def test_copy_batch_equals_reference():
    rng = np.random.default_rng(3)
    sizes = [int(s) for s in rng.integers(1, 200_000, size=37)]
    srcs_np = [rng.integers(0, 255, size=s, dtype=np.uint8) for s in sizes]
    ref_dsts = [np.zeros(s, np.uint8) for s in sizes]
    addr = lambda a: a.__array_interface__["data"][0]  # noqa: E731
    assert ref_native.copy_batch(
        np.array([addr(d) for d in ref_dsts], np.uint64),
        np.array([addr(s) for s in srcs_np], np.uint64),
        np.array(sizes, np.uint64), 4)
    srcs = [torch.from_numpy(s.copy()) for s in srcs_np]
    dsts = [torch.zeros(s, dtype=torch.uint8) for s in sizes]
    before = calls("copy_batch")
    assert native.copy_batch([d.data_ptr() for d in dsts], [s.data_ptr() for s in srcs],
                             sizes, 4)
    assert calls("copy_batch") - before == 1
    for d, r in zip(dsts, ref_dsts):
        assert np.array_equal(d.numpy(), r)


def test_prefault_equals_reference():
    n = (8 << 20) + 123
    ref_buf = np.full(n, 7, np.uint8)
    assert ref_native.prefault(ref_buf.__array_interface__["data"][0], n, 2)
    buf = torch.full((n,), 7, dtype=torch.uint8)
    before = calls("prefault")
    assert native.prefault(buf.data_ptr(), n, 2)
    assert calls("prefault") - before == 1
    assert np.array_equal(buf.numpy(), ref_buf)  # one zero written per page
    assert native.prefault(buf.data_ptr(), 0)


def test_bulk_receive_buffers_are_prefaulted_natively():
    before = calls("prefault")
    buf = bulk._fresh_buffer(bulk.PREFAULT_MIN_BYTES)
    assert buf.numel() == bulk.PREFAULT_MIN_BYTES
    assert calls("prefault") - before == 1
    bulk._fresh_buffer(4096)  # a small one is not worth the call
    assert calls("prefault") - before == 1


def test_provisioned_segments_are_prefaulted_natively():
    # The cold-start provisioning (the reference's create_provisioned).
    before = calls("prefault")
    seg = ShmSegment.create_provisioned(3 << 20, 2)
    try:
        view = torch.frombuffer(seg.mmap, dtype=torch.uint8)
        assert int(view.sum()) == 0
        assert calls("prefault") - before == 1
    finally:
        seg.unlink()


def test_warm_segments_are_populated_in_the_mmap():
    # The pool's rotation warm-ups populate in the mmap call, as the
    # reference's do: no native prefault.
    before = calls()
    seg = ShmSegment.create_warm(3 << 20)
    try:
        view = torch.frombuffer(seg.mmap, dtype=torch.uint8)
        assert int(view.sum()) == 0
        assert calls() == before
    finally:
        seg.unlink()


def test_host_landings_take_the_pool_path():
    # Measured on the card's host (chip_smoke.py's landing phase), the
    # landing pool's row blocks move 16 GB no slower than one native
    # copy_batch, so host landings keep the pool alone.
    srcs = [torch.randn(n, generator=torch.Generator().manual_seed(n)) for n in (7, 300_000,
                                                                                 5_000_000)]
    dsts = [torch.empty_like(s) for s in srcs]
    odd_dst = torch.zeros(4, 6)
    odd_src = torch.randn(6, 4).t()
    before = calls()
    asyncio.run(landing.land_async(list(zip(dsts, srcs)) + [(odd_dst, odd_src)]))
    assert calls() == before
    for d, s in zip(dsts, srcs):
        assert torch.equal(d, s)
    assert torch.equal(odd_dst, odd_src)


@pytest.fixture
def fresh_native(monkeypatch, tmp_path):
    """A library state of its own: the build goes to ``tmp_path`` and the
    process's library is loaded again after the test."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    native.reset()
    yield tmp_path
    native.reset()
    monkeypatch.undo()
    port_config._default_config = None
    native.get_lib()


def test_failed_build_raises_with_the_gate_on(fresh_native, monkeypatch):
    bad = fresh_native / "host_copy.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(port_config, "_default_config", None)
    monkeypatch.delenv(port_config.ENV_USE_NATIVE, raising=False)
    with pytest.raises(native.NativeLibraryError, match="g\\+\\+ failed"):
        native.get_lib()
    # No quiet fallback: a copy that would take the native path raises too.
    big = torch.zeros(native.PARALLEL_THRESHOLD // 4)
    with pytest.raises(native.NativeLibraryError):
        native.fast_copy(torch.empty_like(big), big)
    # The gate off is the only way to the torch copies.
    monkeypatch.setenv(port_config.ENV_USE_NATIVE, "0")
    port_config._default_config = None
    assert native.get_lib() is None and not native.available()
    src = torch.randn(big.numel(), generator=torch.Generator().manual_seed(1))
    dst = torch.empty_like(src)
    native.fast_copy(dst, src)
    assert torch.equal(dst, src)
    assert native.copy_batch([dst.data_ptr()], [src.data_ptr()], [4]) is False
    assert native.prefault(dst.data_ptr(), 16) is False


def test_missing_compiler_raises_with_the_gate_on(fresh_native, monkeypatch):
    monkeypatch.setenv("CXX", "no-such-compiler-tst")
    monkeypatch.setattr(port_config, "_default_config", None)
    monkeypatch.delenv(port_config.ENV_USE_NATIVE, raising=False)
    with pytest.raises(native.NativeLibraryError, match="compiler"):
        native.get_lib()


def _gate_off_landing() -> None:
    src = torch.randn(5_000_000, generator=torch.Generator().manual_seed(2))
    dst = torch.empty_like(src)
    asyncio.run(landing.land_async([(dst, src)]))
    assert torch.equal(dst, src)


def _gate_off_fresh_buffer() -> None:
    assert bulk._fresh_buffer(bulk.PREFAULT_MIN_BYTES).numel() == bulk.PREFAULT_MIN_BYTES


def _gate_off_fast_copy() -> None:
    src = torch.randn(native.PARALLEL_THRESHOLD // 4, generator=torch.Generator().manual_seed(3))
    dst = torch.empty_like(src)
    native.copy_into(dst, src)
    assert torch.equal(dst, src)


@pytest.mark.parametrize("path", [_gate_off_landing, _gate_off_fresh_buffer, _gate_off_fast_copy],
                         ids=["landing", "bulk_receive_buffer", "copy_into"])
def test_gate_off_makes_no_native_call(fresh_native, monkeypatch, path):
    # One switch, process-wide: the environment (which spawned volumes
    # inherit). Off, no path builds, loads or calls the library.
    assert not hasattr(port_config.StoreConfig(), "use_native")
    monkeypatch.setenv(port_config.ENV_USE_NATIVE, "0")

    def no_build(_path):
        raise AssertionError("built with the gate off")

    monkeypatch.setattr(native, "_build", no_build)
    monkeypatch.setattr(native, "_bind", no_build)
    before = calls()
    path()
    assert calls() == before and not native.enabled()
