"""Large tensors through every rung of the port, against the JAX package:
test_large_tensors.py's sweep at its sizes (4 and 64 MB; 512 MB and 2 GB
with TORCHSTORE_TPU_ENABLE_SLOW_TESTS, as there), a put, a get and an
in-place get per transport (shm, bulk, rpc), and its 16 MB reshard (8 row
shards read back on a (4, 2) mesh with the axes swapped). The JAX package
runs the same seeded data on its bulk and rpc rungs (off shared memory);
every result is compared bit for bit."""

import asyncio
import contextlib
import os
import uuid

import numpy as np
import pytest
import torch

import torchstore_tpu as ts_ref
import torchstore_tpu_torch as tst
from torchstore_tpu import config as ref_config
from torchstore_tpu.config import StoreConfig as RefStoreConfig
from torchstore_tpu.transport import shared_memory as ref_shm

SIZES_MB = [4, 64]
if os.environ.get("TORCHSTORE_TPU_ENABLE_SLOW_TESTS"):
    SIZES_MB += [512, 2048]
TRANSPORTS = ("shm", "bulk", "rpc")
REF_TRANSPORTS = ("bulk", "rpc")  # the JAX oracle stays off shared memory
RESHARD = (2048, 2048)  # 16 MB of float32


def array(size_mb: int) -> np.ndarray:
    n = size_mb * 1024 * 1024 // 4
    return np.random.default_rng(size_mb).random((1024, n // 1024)).astype(np.float32)


def reshard_array() -> np.ndarray:
    return np.random.default_rng(16).random(RESHARD).astype(np.float32)


def boxes(mesh_shape, dim_axes):
    """(coordinates, index) of a RESHARD tensor on ``mesh_shape``;
    ``dim_axes[d]`` is the mesh axis splitting tensor dim d (None: whole)."""
    out = []
    for coords in np.ndindex(*mesh_shape):
        index = []
        for d, axis in enumerate(dim_axes):
            if axis is None:
                index.append(slice(0, RESHARD[d]))
                continue
            size = RESHARD[d] // mesh_shape[axis]
            index.append(slice(coords[axis] * size, (coords[axis] + 1) * size))
        out.append((coords, tuple(index)))
    return out


@contextlib.contextmanager
def reference_off_shm():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_config, "_default_config", None)
        mp.setattr(ref_shm, "is_available", lambda: False)
        mp.setenv("TORCHSTORE_TPU_META_STAMPED", "0")
        mp.setenv("TORCHSTORE_TPU_ONE_SIDED", "0")
        yield RefStoreConfig(shm_enabled=False)


async def reference_session() -> dict:
    import jax
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    out: dict = {}
    for transport in REF_TRANSPORTS:
        store = f"ref_big_{uuid.uuid4().hex[:6]}"
        with reference_off_shm() as config:
            await ts_ref.initialize(store_name=store, config=config, strategy=ts_ref
                                    .SingletonStrategy(default_transport_type=transport))
            try:
                for size in SIZES_MB:
                    x = array(size)
                    await ts_ref.put("big", x, store_name=store)
                    got = np.asarray(await ts_ref.get("big", store_name=store))
                    dest = np.zeros_like(x)
                    same = await ts_ref.get("big", like=dest, store_name=store) is dest
                    out[(transport, size)] = (got, dest, same)
                    await ts_ref.delete("big", store_name=store)
                g = reshard_array()
                devs = np.array(jax.devices())
                await ts_ref.put("s", jax.device_put(g, NamedSharding(Mesh(devs.reshape(8), ("x",)),
                                                                      P("x"))), store_name=store)
                like = jax.device_put(np.zeros_like(g), NamedSharding(
                    Mesh(devs.reshape(4, 2), ("a", "b")), P("b", "a")))
                out[(transport, "reshard")] = np.asarray(await ts_ref.get("s", like=like,
                                                                          store_name=store))
            finally:
                await ts_ref.shutdown(store)
    return out


async def port_session() -> dict:
    out: dict = {}
    for transport in TRANSPORTS:
        store = f"port_big_{uuid.uuid4().hex[:6]}"
        await tst.initialize(store_name=store,
                             strategy=tst.SingletonStrategy(default_transport_type=transport))
        try:
            for size in SIZES_MB:
                x = torch.from_numpy(array(size))
                await tst.put("big", x, store_name=store)
                got = (await tst.get("big", store_name=store)).numpy().copy()
                dest = torch.zeros_like(x)
                same = await tst.get("big", like=dest, store_name=store) is dest
                out[(transport, size)] = (got, dest.numpy(), same)
                await tst.delete("big", store_name=store)
            g = torch.from_numpy(reshard_array())
            for coords, index in boxes((8,), (0, None)):
                sl = tst.TensorSlice(tuple(s.start for s in index),
                                     tuple(s.stop - s.start for s in index), RESHARD, coords, (8,))
                await tst.put("s", tst.Shard(g[index].clone(), sl), store_name=store)
            result = torch.zeros(RESHARD)
            for coords, index in boxes((4, 2), (1, 0)):  # P("b", "a") on mesh (a=4, b=2)
                sl = tst.TensorSlice(tuple(s.start for s in index),
                                     tuple(s.stop - s.start for s in index), RESHARD, coords,
                                     (4, 2))
                await tst.get("s", tst.Shard(result[index], sl), store_name=store)
            out[(transport, "reshard")] = result.numpy()
        finally:
            await tst.shutdown(store)
    return out


@pytest.fixture(scope="module")
def sessions():
    return asyncio.run(reference_session()), asyncio.run(port_session())


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("size_mb", SIZES_MB)
@pytest.mark.parametrize("transport", TRANSPORTS)
def test_large_roundtrip(sessions, transport, size_mb):
    ref, port = sessions
    got, dest, same = port[(transport, size_mb)]
    x = array(size_mb)
    assert same
    assert np.array_equal(_bits(got), _bits(x)) and np.array_equal(_bits(dest), _bits(x))
    ref_got, ref_dest, ref_same = ref[(transport if transport in REF_TRANSPORTS else "bulk",
                                       size_mb)]
    assert ref_same
    assert np.array_equal(_bits(got), _bits(ref_got))
    assert np.array_equal(_bits(dest), _bits(ref_dest))


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_large_sharded_reshard(sessions, transport):
    ref, port = sessions
    got = port[(transport, "reshard")]
    assert np.array_equal(_bits(got), _bits(reshard_array()))
    for ref_transport in REF_TRANSPORTS:
        assert np.array_equal(_bits(got), _bits(ref[(ref_transport, "reshard")]))
