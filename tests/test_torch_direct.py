"""Port parity for direct (one-hop) weight sync: the port's source and dest
against the reference's (host path) on the same numpy inputs, over shared
memory and TCP, with refresh, transfer-dtype cast, copy-free staging
buffers and torn-pull detection. Results are compared bit for bit."""

import anyio
import ml_dtypes
import numpy as np
import pytest
import torch

from torchstore_tpu.direct_weight_sync import (
    DirectWeightSyncDest as RefDest,
    DirectWeightSyncSource as RefSource,
)
from torchstore_tpu_torch import direct_weight_sync as port_dws
from torchstore_tpu_torch.direct_weight_sync import (
    DirectWeightSyncDest,
    DirectWeightSyncSource,
    PullRaceError,
)
from torchstore_tpu_torch.transport import shared_memory as port_shm

TIMEOUT_S = 60


@pytest.fixture
async def pair(request):
    use_shm = getattr(request, "param", True)
    source = DirectWeightSyncSource(use_shm=use_shm)
    dest = DirectWeightSyncDest()
    yield source, dest
    await dest.close()
    await source.close()


async def reference_pull(tree, targets, transfer_dtype=None, update=None):
    # The reference over TCP: its results do not depend on the rung, and it
    # adds no ts_shm_* segments to the reference's own machine-wide counts.
    source = RefSource(use_shm=False, device=False)
    dest = RefDest()
    try:
        handles = await source.register(tree, transfer_dtype=transfer_dtype)
        out = await dest.pull(handles, targets)
        first = {k: np.array(v) for k, v in out.items() if isinstance(v, np.ndarray)}
        if update is None:
            return first, None
        source.update_sources(update)
        await source.refresh()
        out = await dest.pull(handles, targets)
        return first, {k: np.array(v) for k, v in out.items() if isinstance(v, np.ndarray)}
    finally:
        await dest.close()
        await source.close()


def np_tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((16, 8)).astype(np.float32),
        "b": rng.standard_normal(8).astype(np.float32),
        "steps": np.arange(4, dtype=np.int64),
    }


def as_port(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def assert_bits_equal(port: torch.Tensor, ref: np.ndarray, key: str):
    if port.dtype == torch.bfloat16:
        np.testing.assert_array_equal(
            port.view(torch.int16).numpy().view(np.uint16), ref.view(np.uint16), err_msg=key
        )
    else:
        np.testing.assert_array_equal(port.numpy(), ref, err_msg=key)


@pytest.mark.parametrize("pair", [True, False], ids=["shm", "tcp"], indirect=True)
async def test_pull_and_refresh_match_reference(pair):
    source, dest = pair
    tree, update = np_tree(0), np_tree(1)
    with anyio.fail_after(TIMEOUT_S):
        ref_first, ref_second = await reference_pull(
            tree, {k: np.zeros_like(v) for k, v in tree.items()}, update=update
        )
        src = as_port(tree)
        handles = await source.register(src)
        assert all((h[0].shm_name is not None) == source.use_shm for h in handles.values())
        targets = {k: torch.zeros_like(v) for k, v in src.items()}
        out = await dest.pull(handles, targets)
        assert all(out[k] is targets[k] for k in targets)  # filled in place
        for k, v in ref_first.items():
            assert_bits_equal(out[k], v, k)
        source.update_sources(as_port(update))
        await source.refresh()
        out = await dest.pull(handles, targets)
        for k, v in ref_second.items():
            assert_bits_equal(out[k], v, k)


async def test_transfer_dtype_cast_matches_reference(pair):
    source, dest = pair
    tree = np_tree(2)
    bf16 = ml_dtypes.bfloat16
    with anyio.fail_after(TIMEOUT_S):
        ref, _ = await reference_pull(
            tree,
            {k: np.zeros(v.shape, bf16 if v.dtype == np.float32 else v.dtype)
             for k, v in tree.items()},
            transfer_dtype=bf16,
        )
        handles = await source.register(as_port(tree), transfer_dtype=torch.bfloat16)
        assert handles["w"][0].meta.dtype == "bfloat16"
        assert handles["steps"][0].meta.dtype == "int64"  # non-floating: no cast
        targets = {
            k: torch.zeros(v.shape, dtype=torch.bfloat16 if v.dtype == np.float32 else torch.int64)
            for k, v in tree.items()
        }
        out = await dest.pull(handles, targets)
    for k, v in ref.items():
        assert_bits_equal(out[k], v, k)


async def test_non_tensor_leaves_skipped(pair):
    source, dest = pair
    with anyio.fail_after(TIMEOUT_S):
        handles = await source.register({"w": torch.ones(4), "cfg": {"lr": 1e-3}})
        assert "cfg/lr" not in handles
        out = await dest.pull(handles, {"w": torch.zeros(4), "cfg": {"lr": 0.0}})
    assert torch.equal(out["w"], torch.ones(4))
    assert out["cfg"]["lr"] == 0.0  # untouched by the direct path


async def test_staging_buffers_make_publishes_copy_free(pair):
    source, dest = pair
    with anyio.fail_after(TIMEOUT_S):
        handles = await source.register({"w": torch.zeros(6), "step": 3})
        staging = source.staging_state_dict()
        assert staging["step"] == 3
        staging["w"].fill_(5.0)  # the trainer writes straight into the buffer
        source.update_sources(staging)
        await source.refresh()  # nothing to copy: the buffer is the source
        out = await dest.pull(handles, {"w": torch.zeros(6)})
    assert torch.equal(out["w"], torch.full((6,), 5.0))


async def test_non_contiguous_target_and_errors(pair):
    source, dest = pair
    w = torch.arange(12.0).reshape(3, 4)
    with anyio.fail_after(TIMEOUT_S):
        handles = await source.register({"w": w})
        target = torch.zeros(4, 3).t()  # non-contiguous, filled through a stand-in
        out = await dest.pull(handles, {"w": target})
        assert out["w"] is target and torch.equal(target, w)
        with pytest.raises(KeyError, match="published no handle"):
            await dest.pull(handles, {"other": torch.zeros(1)})
        with pytest.raises(ValueError, match="source shape"):
            await dest.pull(handles, {"w": torch.zeros(4, 3)})
        source.update_sources({"w": torch.zeros(2, 2)})
        with pytest.raises(ValueError, match="re-register"):
            await source.refresh()


async def test_pull_waits_out_a_refresh_then_gives_up(pair, monkeypatch):
    source, dest = pair
    with anyio.fail_after(TIMEOUT_S):
        handles = await source.register({"w": torch.ones(4)})
        source._set_busy(True)  # a refresh that never finishes
        monkeypatch.setattr(port_dws, "SETTLE_TIMEOUT_S", 0.2)
        with pytest.raises(PullRaceError, match="never settled"):
            await dest.pull(handles, {"w": torch.zeros(4)})
        source._set_busy(False)
        out = await dest.pull(handles, {"w": torch.zeros(4)})
    assert torch.equal(out["w"], torch.ones(4))


async def test_close_unlinks_staging_segments():
    source = DirectWeightSyncSource(use_shm=True)
    handles = await source.register({"w": torch.ones(1024)})
    name = handles["w"][0].shm_name
    assert name.startswith(port_shm.PREFIX)
    assert name in port_shm.os.listdir(port_shm.SHM_DIR)
    await source.close()
    assert name not in port_shm.os.listdir(port_shm.SHM_DIR)
