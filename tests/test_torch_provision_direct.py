"""Port parity for the direct path's provisioning (the twin of the
local-pool half of ``tests/test_provision.py``): ``prewarm(acquire_key=)``
builds the dest's transfer plan ahead (its first pull counts a plan-cache
hit), ``prewarm(direct=True)`` fills the client-local staging pool that a
direct source's ``register`` draws. The plan report is held against the
JAX package's ``DirectWeightSyncDest.preplan`` on the same inputs (its
source over TCP, so it makes no ``ts_shm_*`` segment, which the JAX
package's own tests count machine-wide); the pool against the counts the
JAX package's test of it asserts."""

import uuid

import anyio
import numpy as np
import pytest
import torch

import torchstore_tpu_torch as tst
from torchstore_tpu.direct_weight_sync import (
    DirectWeightSyncDest as RefDest,
    DirectWeightSyncSource as RefSource,
)
from torchstore_tpu_torch import direct_weight_sync as dws
from torchstore_tpu_torch.provision.pool import LocalSegmentPool, local_pool

TIMEOUT_S = 60


@pytest.fixture
async def store():
    name = f"pv_{uuid.uuid4().hex[:8]}"
    await tst.initialize(store_name=name)
    yield name
    await tst.shutdown(name)


async def reference_preplan(w: np.ndarray) -> dict:
    source, dest = RefSource(use_shm=False, device=False), RefDest()
    try:
        handles = await source.register({"w": w})
        return await dest.preplan(handles, {"w": np.zeros_like(w)})
    finally:
        await dest.close()
        await source.close()


async def test_prewarm_direct_acquire_precomputes_plan(store):
    w = np.random.default_rng(0).random(4096).astype(np.float32)
    with anyio.fail_after(TIMEOUT_S):
        ref = await reference_preplan(w)
        await tst.put_state_dict("d/sd", {"w": torch.from_numpy(w.copy())}, direct=True,
                                 store_name=store)
        user = {"w": torch.zeros(4096)}
        report = await tst.prewarm(user, store_name=store, acquire_key="d/sd")
        assert report["ok"] and report["errors"] == {}
        for k in ("plan_ops", "plan_reused", "dials", "dial_errors"):
            assert report[k] == ref[k], k
        # One same-host staging segment attached (the JAX package's test
        # asserts the same count for its shared-memory source).
        assert report["plan_ops"] == 1 and report["segments_attached"] == 1
        before = dws.PLAN_PREWARM_HITS.total()
        out = await tst.get_state_dict("d/sd", user, direct=True, store_name=store)
        assert torch.equal(out["w"], torch.from_numpy(w))
        assert dws.PLAN_PREWARM_HITS.total() == before + 1  # the first pull hit it
        await tst.get_state_dict("d/sd", user, direct=True, store_name=store)
        assert dws.PLAN_PREWARM_HITS.total() == before + 1  # only the first


async def test_prewarm_direct_source_draws_local_staging(store):
    w = np.random.default_rng(1).random(65536).astype(np.float32)
    sd = {"w": torch.from_numpy(w.copy())}
    with anyio.fail_after(TIMEOUT_S):
        local_pool().clear()
        report = await tst.prewarm(sd, store_name=store, direct=True)
        # The counts the JAX package's twin of this test asserts.
        assert report["ok"] and report["local_segments"] == 1
        assert local_pool().pooled_bytes == 262144
        # The first direct publish (register) draws the provisioned segment.
        await tst.put_state_dict("d/sd", sd, direct=True, store_name=store)
        assert local_pool().pooled_bytes == 0
        out = await tst.get_state_dict("d/sd", {"w": torch.zeros(65536)}, direct=True,
                                       store_name=store)
        assert torch.equal(out["w"], sd["w"])


@pytest.mark.parametrize("sizes", [{4096: 2, 1: 1}, {262144: 1, 8192: 3}, {}], ids=str)
def test_local_pool_provisions_and_takes(sizes):
    """The JAX package's pool semantics: segments counted against the want
    (a second provision creates none), exact-size takes, ``clear``."""
    pool = LocalSegmentPool()
    want = sum(size * count for size, count in sizes.items())
    try:
        got = pool.provision(sizes)
        assert (got["created"], got["bytes"], got["clamped_bytes"]) == (
            sum(sizes.values()), want, 0)
        assert pool.pooled_bytes == want
        assert pool.provision(sizes)["created"] == 0
        for size in sizes:
            seg = pool.take(size)
            assert seg is not None and seg.size >= size
            seg.unlink()
        assert pool.take(12345) is None
    finally:
        pool.clear()
    assert pool.pooled_bytes == 0


async def test_prewarm_weighs_the_transfer_dtype_and_skips_the_device_rung(store, monkeypatch):
    sd = {"w": torch.zeros(1000), "steps": torch.arange(10), "lr": 0.1}
    local_pool().clear()
    try:
        report = await tst.prewarm(sd, store_name=store, direct=True,
                                   transfer_dtype=torch.bfloat16)
        assert report["local_segments"] == 2 and report["bytes"] == 2000 + 80
        local_pool().clear()
        monkeypatch.setattr(dws, "device_rung_eligible", lambda shards, config: True)
        report = await tst.prewarm(sd, store_name=store, direct=True)
        assert report["device"] and report["local_segments"] == 0
        assert local_pool().pooled_bytes == 0
    finally:
        local_pool().clear()


async def test_prewarm_is_advisory_and_direct_only(store):
    report = await tst.prewarm({"w": torch.zeros(4)}, store_name=store, acquire_key="never")
    assert report["ok"] is False and "preplan" in report["errors"]
    with pytest.raises(NotImplementedError, match="A11"):
        await tst.prewarm({"w": torch.zeros(4)}, store_name=store)
