"""Colocated (in-process) volumes: this process's calls on its own volume
are direct (no RPC, no serialization), other processes still reach it over
its actor server, and values keep their semantics despite the by-reference
dispatch, on the shm and the rpc rung. The seven cases of
tests/test_colocated.py; the state-dict case holds the port against the JAX
package's colocated store on the same inputs (exact), the oracle kept off
shared memory."""

import os
import uuid

import ml_dtypes
import numpy as np
import pytest
import torch

import torchstore_tpu as ts_ref
import torchstore_tpu_torch as ts
from torchstore_tpu import config as ref_config
from torchstore_tpu.config import StoreConfig as RefStoreConfig
from torchstore_tpu.transport import shared_memory as ref_shm
from torchstore_tpu_torch import api
from torchstore_tpu_torch.runtime import Actor, endpoint, spawn_actors
from torchstore_tpu_torch.runtime import actors as actors_mod


@pytest.fixture(params=[None, "rpc"], ids=["shm", "rpc"])
async def colo(request):
    name = f"tst_colo_{uuid.uuid4().hex[:6]}"
    strategy = ts.SingletonStrategy(default_transport_type=request.param)
    await ts.initialize(store_name=name, strategy=strategy, colocated=True)
    yield name
    await ts.shutdown(name)


async def test_roundtrip_and_inproc_dispatch(colo):
    client = ts.client(colo)
    await client._ensure_setup()
    (volume,) = client._volume_refs.values()
    assert volume.is_inproc()  # direct calls, not RPC
    x = torch.arange(64.0).reshape(8, 8)
    await ts.put("k", x, store_name=colo)
    assert torch.equal(await ts.get("k", store_name=colo), x)
    await ts.put("obj", {"step": 7}, store_name=colo)
    assert await ts.get("obj", store_name=colo) == {"step": 7}
    # No connection of this process's pool leads to its own volume.
    assert not [k for k in actors_mod._conn_pools if k[1:] == (volume.actor.host,
                                                                volume.actor.port)]


async def test_value_semantics_despite_reference_dispatch(colo):
    """A later in-place update of the caller's tensor (an optimizer step)
    never reaches the stored value, and mutating a fetched tensor never
    corrupts the store, whole or sharded."""
    x = torch.ones(32)
    await ts.put("k", x, store_name=colo)
    x.fill_(-5.0)
    out = await ts.get("k", store_name=colo)
    assert torch.equal(out, torch.ones(32))
    out.fill_(99.0)
    assert torch.equal(await ts.get("k", store_name=colo), torch.ones(32))
    big = torch.arange(1 << 18, dtype=torch.float32)  # past the inline size
    await ts.put("big", big, store_name=colo)
    big.zero_()
    got = await ts.get("big", store_name=colo)
    assert torch.equal(got, torch.arange(1 << 18, dtype=torch.float32))
    dest = torch.zeros(1 << 18)
    await ts.get("big", dest, store_name=colo)
    dest.add_(1)
    again = await ts.get("big", store_name=colo)
    assert torch.equal(again, torch.arange(1 << 18, dtype=torch.float32))
    slices = [ts.TensorSlice(offsets=(4 * i,), local_shape=(4,), global_shape=(8,),
                             coordinates=(i,), mesh_shape=(2,)) for i in range(2)]
    shards = [torch.full((4,), 2.0 + i) for i in range(2)]
    for shard, sl in zip(shards, slices):
        await ts.put("sh", ts.Shard(shard, sl), store_name=colo)
        shard.zero_()
    assert torch.equal(await ts.get("sh", slices[1], store_name=colo), torch.full((4,), 3.0))
    assert torch.equal(await ts.get("sh", store_name=colo),
                       torch.tensor([2.0] * 4 + [3.0] * 4))


async def test_object_value_semantics(colo):
    """Objects are copied on store and on serve despite the direct call."""
    cfg = {"lr": 0.1, "betas": [0.9, 0.95]}
    await ts.put("cfg", cfg, store_name=colo)
    cfg["lr"] = 0.0
    out = await ts.get("cfg", store_name=colo)
    assert out["lr"] == 0.1
    out["betas"].append(123)
    assert await ts.get("cfg", store_name=colo) == {"lr": 0.1, "betas": [0.9, 0.95]}


def own_segments() -> set[str]:
    """This process's tst_shm_ segments (a colocated volume's carry this
    pid): other tests' stores on the machine are not counted."""
    prefix = f"tst_shm_{os.getpid()}_"
    return {n for n in os.listdir("/dev/shm") if n.startswith(prefix)}


@pytest.mark.skipif(not os.path.isdir("/dev/shm"), reason="needs /dev/shm")
async def test_shutdown_releases_segments():
    before = own_segments()
    await ts.initialize(store_name="tst_colo3", colocated=True)
    await ts.put("big", torch.rand(1 << 18), store_name="tst_colo3")
    await ts.get("big", store_name="tst_colo3")
    await ts.put("small", {"a": torch.ones(4), "b": torch.ones(8)}, store_name="tst_colo3")
    assert own_segments() - before  # the volume's segments live in this process
    await ts.shutdown("tst_colo3")
    assert own_segments() <= before


class _Reader(Actor):
    @endpoint
    async def read(self, store_name: str):
        out = await ts.get("shared", store_name=store_name)
        return float(out[0])


async def test_remote_process_reaches_colocated_volume(colo):
    """A spawned actor (its own process) fetches from the colocated volume
    over its server while this process's loop keeps serving."""
    await ts.put("shared", torch.full((4,), 8.25), store_name=colo)
    readers = await spawn_actors(1, _Reader, "tst_reader")
    try:
        assert await readers.read.call(colo) == [8.25]
    finally:
        await readers.stop()


async def reference_state_dict(sd_np: dict, monkeypatch) -> dict:
    """The JAX package's colocated store on the same numpy state dict, over
    its RPC rung (its SHM rung and one-sided planes off, so it adds no
    ts_shm_ segment beside the reference's own leak tests)."""
    monkeypatch.setattr(ref_config, "_default_config", None)
    monkeypatch.setattr(ref_shm, "is_available", lambda: False)
    monkeypatch.setenv("TORCHSTORE_TPU_META_STAMPED", "0")
    monkeypatch.setenv("TORCHSTORE_TPU_ONE_SIDED", "0")
    name = f"ref_colo_{uuid.uuid4().hex[:6]}"
    await ts_ref.initialize(
        store_name=name, colocated=True,
        strategy=ts_ref.SingletonStrategy(default_transport_type="rpc"),
        config=RefStoreConfig(shm_enabled=False, bulk_tcp_enabled=False, use_native=False),
    )
    try:
        await ts_ref.put_state_dict("m", sd_np, transfer_dtype=ml_dtypes.bfloat16,
                                    store_name=name)
        return await ts_ref.get_state_dict("m", store_name=name)
    finally:
        await ts_ref.shutdown(name)


async def test_state_dict_roundtrip_colocated(colo, monkeypatch):
    rng = np.random.default_rng(0)
    sd_np = {"layer": {"w": rng.standard_normal(256).astype(np.float32),
                       "b": rng.standard_normal((4, 8)).astype(np.float32)}, "step": 3}
    sd = {"layer": {k: torch.from_numpy(v.copy()) for k, v in sd_np["layer"].items()},
          "step": 3}
    await ts.put_state_dict("m", sd, transfer_dtype=torch.bfloat16, store_name=colo)
    for v in sd["layer"].values():
        v.zero_()  # the trainer's next step
    out = await ts.get_state_dict("m", store_name=colo)
    ref = await reference_state_dict(sd_np, monkeypatch)
    assert out["step"] == ref["step"] == 3
    for k in ("w", "b"):
        got = out["layer"][k].view(torch.int16).numpy()
        want = np.asarray(ref["layer"][k]).view(np.int16)
        np.testing.assert_array_equal(got, want, err_msg=k)


async def test_colocated_rejects_multiple_volumes():
    with pytest.raises(ValueError, match="exactly one volume"):
        await ts.initialize(num_storage_volumes=2, store_name="tst_colo2", colocated=True)
    assert "tst_colo2" not in api._stores
