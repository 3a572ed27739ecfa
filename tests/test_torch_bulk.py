"""The bulk TCP rung of the port against the JAX package's: every case of
test_bulk_transport.py runs first on a JAX store forced to bulk, then on
the port's, on the same seeded state, and the results are compared bit for
bit. Also: the wire (frame header, stripe subheader, control indices,
_stripe_ranges) byte-equal to the reference's, the pickled buffer carrying
no tensor and no socket, a failed put that does not poison the connection
cache (and aborts what landed), the unforced choice of bulk for a volume
on another emulated host, and the card staging pipeline driven on CPU
tensors, its page-locked buffers unlocked when their connection closes."""

import asyncio
import contextlib
import pickle
import uuid

import numpy as np
import pytest
import torch

import torchstore_tpu as ts_ref
import torchstore_tpu_torch as tst
from torchstore_tpu import config as ref_config
from torchstore_tpu.config import StoreConfig as RefStoreConfig
from torchstore_tpu.transport import bulk as ref_bulk
from torchstore_tpu.transport import shared_memory as ref_shm
from torchstore_tpu.transport.bulk import BulkClientCache as RefBulkClientCache
from torchstore_tpu_torch.observability import metrics
from torchstore_tpu_torch.transport import bulk
from torchstore_tpu_torch.transport.bulk import BulkClientCache, BulkTransportBuffer
from torchstore_tpu_torch.transport.factory import TransportType, demotion_ladder

BIG_SHAPE = (4096, 6144)  # 96 MB of float32: above the 64 MiB stripe threshold
DCN_SHAPE = (3072, 8192)


def seeded(shape, seed, dtype=np.float32) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def big_array() -> np.ndarray:
    x = np.arange(int(np.prod(BIG_SHAPE)), dtype=np.float32).reshape(BIG_SHAPE)
    x[0, 0] = 7.5
    return x


def run(coro_fn, *args):
    return asyncio.run(coro_fn(*args))


@contextlib.contextmanager
def reference_on_bulk(**env):
    # The reference forced onto its bulk rung, without its stamped metadata
    # and one-sided planes (so it adds no ts_shm_* segment to the
    # machine-wide counts of its own tests). Its process default config is
    # read from the environment once: it must not be first read here.
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_config, "_default_config", None)
        mp.setattr(ref_shm, "is_available", lambda: False)
        mp.setenv("TORCHSTORE_TPU_META_STAMPED", "0")
        mp.setenv("TORCHSTORE_TPU_ONE_SIDED", "0")
        for k, v in env.items():
            mp.setenv(k, v)
        yield RefStoreConfig(shm_enabled=False)


def host_reshard_slices(mesh_shape, dims):
    """(coordinates, TensorSlice box) of an 8x8 global tensor laid out on a
    2D mesh, ``dims[d]`` naming the mesh axis that splits tensor dim d."""
    out = []
    for coords in np.ndindex(*mesh_shape):
        offsets, local = [], []
        for d in range(2):
            axis = dims[d]
            parts = mesh_shape[axis]
            size = 8 // parts
            offsets.append(coords[axis] * size)
            local.append(size)
        out.append((coords, tuple(offsets), tuple(local)))
    return out


# --------------------------------------------------------------------------
# the two sessions: every case of test_bulk_transport.py
# --------------------------------------------------------------------------


async def _reference_cases(store: str) -> dict:
    out: dict = {}
    x = seeded((64, 64), 0)
    await ts_ref.put("w", x, store_name=store)
    out["roundtrip"] = np.asarray(await ts_ref.get("w", store_name=store))
    await ts_ref.put_batch({"t": np.arange(8.0), "o": {"cfg": True}, "t2": np.ones((3, 3))},
                           store_name=store)
    got = await ts_ref.get_batch({"t": None, "o": None, "t2": None}, store_name=store)
    out["mixed"] = (np.asarray(got["t"]), got["o"], np.asarray(got["t2"]))
    client = ts_ref.client(store)
    await client.put("a", np.ones(4))
    cache = client._ctx.get_cache(RefBulkClientCache)
    conn = next(iter(cache.connections.values()))
    await client.put("b", np.ones(4))
    await client.get("a")
    out["promoted"] = (len(cache.connections), next(iter(cache.connections.values())) is conn)
    big8 = seeded((2048, 1024), 1)
    await ts_ref.put("big8", big8, store_name=store)
    out["large"] = np.asarray(await ts_ref.get("big8", store_name=store))

    async def one(i):
        v = np.full((256,), float(i), np.float32)
        await ts_ref.put(f"c/{i}", v, store_name=store)
        return np.asarray(await ts_ref.get(f"c/{i}", store_name=store))

    out["concurrent"] = await asyncio.gather(*(one(i) for i in range(8)))
    await client.put("good", np.ones(4))
    with pytest.raises(ValueError, match="already stored"):
        await client.put("good", {"now": "object"})
    out["after_failed_put"] = (np.asarray(await client.get("good")),)
    await client.put("after", np.full(2, 5.0))
    out["after_failed_put"] += (np.asarray(await client.get("after")),)
    # The sharded case: an 8x8 tensor on a (4, 2) mesh, read back on a
    # (2, 4) mesh with the axes swapped (JAX arrays, as the reference test).
    import jax
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    g = np.arange(64.0, dtype=np.float32).reshape(8, 8)
    mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("x", "y"))
    await ts_ref.put("s", jax.device_put(g, NamedSharding(mesh, P("x", "y"))), store_name=store)
    like = jax.device_put(np.zeros_like(g), NamedSharding(
        Mesh(np.array(jax.devices()).reshape(2, 4), ("a", "b")), P("b", "a")))
    out["sharded"] = np.asarray(await ts_ref.get("s", like=like, store_name=store))
    xi = np.arange(12.0).reshape(3, 4)
    await ts_ref.put("x", xi, store_name=store)
    dest = np.zeros((3, 4))
    got = await ts_ref.get("x", like=dest, store_name=store)
    out["inplace"] = (got is dest, dest.copy())
    small = seeded((1024,), 2)
    await ts_ref.put("small", small, store_name=store)
    out["small"] = np.asarray(await ts_ref.get("small", store_name=store))
    out["small_striped"] = any(cache.stripe_conns.values())
    big = big_array()
    await ts_ref.put("big", big, store_name=store)
    out["striped_engaged"] = any(cache.stripe_conns.values())
    out["striped"] = np.asarray(await ts_ref.get("big", store_name=store))
    dest = np.zeros_like(big)
    got = await ts_ref.get("big", like=dest, store_name=store)
    out["striped_inplace"] = (got is dest, dest)
    return out


async def reference_session() -> dict:
    store = f"ref_blk_{uuid.uuid4().hex[:6]}"
    with reference_on_bulk() as config:
        await ts_ref.initialize(store_name=store, config=config,
                                strategy=ts_ref.SingletonStrategy(default_transport_type="bulk"))
        try:
            out = await _reference_cases(store)
        finally:
            await ts_ref.shutdown(store)
    store = f"ref_dcn_{uuid.uuid4().hex[:6]}"
    with reference_on_bulk(TORCHSTORE_TPU_BIND_HOST="0.0.0.0",
                           TORCHSTORE_TPU_ADVERTISE_HOST="127.0.0.1") as config:
        await ts_ref.initialize(store_name=store, config=config,
                                strategy=ts_ref.SingletonStrategy(default_transport_type="bulk"))
        try:
            x = seeded(DCN_SHAPE, 3)
            await ts_ref.put("w", x, store_name=store)
            out["dcn"] = np.asarray(await ts_ref.get("w", store_name=store))
        finally:
            await ts_ref.shutdown(store)
    return out


async def _port_cases(store: str) -> dict:
    out: dict = {}
    t = torch.from_numpy
    await tst.put("w", t(seeded((64, 64), 0)), store_name=store)
    out["roundtrip"] = (await tst.get("w", store_name=store)).numpy()
    await tst.put_batch({"t": torch.arange(8.0, dtype=torch.float64), "o": {"cfg": True},
                         "t2": torch.ones(3, 3, dtype=torch.float64)}, store_name=store)
    got = await tst.get_batch({"t": None, "o": None, "t2": None}, store_name=store)
    out["mixed"] = (got["t"].numpy(), got["o"], got["t2"].numpy())
    client = tst.client(store)
    await client.put("a", torch.ones(4, dtype=torch.float64))
    cache = client._ctx.get_cache(BulkClientCache)
    conn = next(iter(cache.connections.values()))
    dials = cache.dials
    await client.put("b", torch.ones(4, dtype=torch.float64))
    await client.get("a")
    out["promoted"] = (len(cache.connections), next(iter(cache.connections.values())) is conn)
    out["warm_dials"] = cache.dials - dials
    await tst.put("big8", t(seeded((2048, 1024), 1)), store_name=store)
    out["large"] = (await tst.get("big8", store_name=store)).numpy()

    async def one(i):
        v = torch.full((256,), float(i), dtype=torch.float32)
        await tst.put(f"c/{i}", v, store_name=store)
        return (await tst.get(f"c/{i}", store_name=store)).numpy()

    out["concurrent"] = await asyncio.gather(*(one(i) for i in range(8)))
    out["sharded"] = await _port_sharded(store)
    xi = torch.arange(12.0, dtype=torch.float64).reshape(3, 4)
    await tst.put("x", xi, store_name=store)
    dest = torch.zeros(3, 4, dtype=torch.float64)
    got = await tst.get("x", like=dest, store_name=store)
    out["inplace"] = (got is dest, dest.numpy().copy())
    await tst.put("small", t(seeded((1024,), 2)), store_name=store)
    out["small"] = (await tst.get("small", store_name=store)).numpy()
    out["small_striped"] = any(cache.stripe_conns.values())
    put_stripes = metrics.counter("ts_bulk_striped_transfers_total").value(direction="put")
    big = t(big_array())
    await tst.put("big", big, store_name=store)
    out["striped_engaged"] = any(cache.stripe_conns.values())
    out["striped_put_counted"] = metrics.counter(
        "ts_bulk_striped_transfers_total").value(direction="put") - put_stripes
    out["striped"] = (await tst.get("big", store_name=store)).numpy()
    dest = torch.zeros_like(big)
    got = await tst.get("big", like=dest, store_name=store)
    out["striped_inplace"] = (got is dest, dest.numpy())
    stats = await client.controller.stats.call_one(include_volumes=True)
    (vstats,) = stats["volumes"].values()
    out["volume_bulk"] = vstats["bulk"]
    return out


async def _port_sharded(store: str) -> np.ndarray:
    """The reference's sharded case with ``Shard`` values: (4, 2) mesh,
    x splits dim 0 and y dim 1; read back on a (2, 4) mesh whose b axis
    splits dim 0 and a dim 1."""
    g = torch.arange(64.0, dtype=torch.float32).reshape(8, 8)
    for coords, offsets, local in host_reshard_slices((4, 2), (0, 1)):
        sl = tst.TensorSlice(offsets, local, (8, 8), coords, (4, 2))
        idx = tuple(slice(o, o + n) for o, n in zip(offsets, local))
        await tst.put("s", tst.Shard(g[idx].clone(), sl), store_name=store)
    out = torch.zeros(8, 8)
    for coords, offsets, local in host_reshard_slices((2, 4), (1, 0)):
        sl = tst.TensorSlice(offsets, local, (8, 8), coords, (2, 4))
        idx = tuple(slice(o, o + n) for o, n in zip(offsets, local))
        await tst.get("s", tst.Shard(out[idx], sl), store_name=store)
    return out.numpy()


async def port_session() -> dict:
    store = f"port_blk_{uuid.uuid4().hex[:6]}"
    await tst.initialize(store_name=store, strategy=tst.SingletonStrategy(
        default_transport_type="bulk"))
    try:
        out = await _port_cases(store)
    finally:
        await tst.shutdown(store)
    store = f"port_dcn_{uuid.uuid4().hex[:6]}"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TORCHSTORE_TORCH_BIND_HOST", "0.0.0.0")
        mp.setenv("TORCHSTORE_TORCH_ADVERTISE_HOST", "127.0.0.1")
        await tst.initialize(store_name=store, strategy=tst.SingletonStrategy(
            default_transport_type="bulk"))
    try:
        x = torch.from_numpy(seeded(DCN_SHAPE, 3))
        await tst.put("w", x, store_name=store)
        out["dcn"] = (await tst.get("w", store_name=store)).numpy()
        client = tst.client(store)
        out["dcn_address"] = next(iter(client._volume_refs.values())).actor.host
    finally:
        await tst.shutdown(store)
    return out


@pytest.fixture(scope="module")
def sessions():
    return run(reference_session), run(port_session)


def _eq(a, b):
    return np.array_equal(np.asarray(a).view(np.uint8), np.asarray(b).view(np.uint8))


def test_forced_bulk_roundtrip(sessions):
    ref, port = sessions
    assert _eq(port["roundtrip"], ref["roundtrip"])


def test_objects_and_tensors_mixed_batch(sessions):
    ref, port = sessions
    assert _eq(port["mixed"][0], ref["mixed"][0]) and _eq(port["mixed"][2], ref["mixed"][2])
    assert port["mixed"][1] == ref["mixed"][1] == {"cfg": True}


def test_connection_promoted_and_reused(sessions):
    ref, port = sessions
    assert port["promoted"] == ref["promoted"] == (1, True)
    assert port["warm_dials"] == 0


def test_large_tensor_bulk(sessions):
    ref, port = sessions
    assert _eq(port["large"], ref["large"])


def test_concurrent_bulk_ops(sessions):
    ref, port = sessions
    for p, r in zip(port["concurrent"], ref["concurrent"]):
        assert _eq(p, r)


def test_sharded_reshard_over_bulk(sessions):
    ref, port = sessions
    assert _eq(port["sharded"], ref["sharded"])


def test_inplace_bulk_get(sessions):
    ref, port = sessions
    assert port["inplace"][0] and ref["inplace"][0]
    assert _eq(port["inplace"][1], ref["inplace"][1])


def test_striped_put_get_roundtrip(sessions):
    ref, port = sessions
    assert port["striped_engaged"] and ref["striped_engaged"]
    assert port["striped_put_counted"] == 1
    assert _eq(port["striped"], ref["striped"])
    assert port["striped_inplace"][0] and ref["striped_inplace"][0]
    assert _eq(port["striped_inplace"][1], ref["striped_inplace"][1])
    vb = port["volume_bulk"]
    assert vb["striped_in"] >= 1 and vb["striped_out"] >= 2 and vb["pending_payloads"] == 0


def test_striped_cross_host_emulation(sessions):
    ref, port = sessions
    assert _eq(port["dcn"], ref["dcn"])
    assert port["dcn_address"] == "127.0.0.1"  # advertised, not the 0.0.0.0 bind


def test_small_transfers_not_striped(sessions):
    ref, port = sessions
    assert _eq(port["small"], ref["small"])
    assert not port["small_striped"] and not ref["small_striped"]


# --------------------------------------------------------------------------
# wire, pickling, failures, the unforced choice, card staging
# --------------------------------------------------------------------------


@pytest.mark.parametrize("total", [1, 7, 64, 1000, 96 << 20, (96 << 20) + 13])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_stripe_ranges_equal_reference(total, n):
    for k in range(n):
        assert bulk._stripe_ranges(total, n, k) == ref_bulk._stripe_ranges(total, n, k)
    covered = sorted(r for k in range(n) for r in bulk._stripe_ranges(total, n, k))
    assert sum(hi - lo for lo, hi in covered) == total


def test_wire_format_equals_reference():
    for name in ("IDX_HELLO", "IDX_ABORT", "IDX_SESSION_OPEN", "IDX_STRIPED", "IDX_PACKED",
                 "STRIPE_CONNS"):
        assert getattr(bulk, name) == getattr(ref_bulk, name), name
    assert bulk._FRAME.format == ref_bulk._FRAME.format == "<QIQ"
    assert bulk._STRIPE.format == ref_bulk._STRIPE.format
    header = (0x1234567890ABCDEF, bulk.IDX_STRIPED, 96 << 20)
    assert bulk._FRAME.pack(*header) == ref_bulk._FRAME.pack(*header)
    assert bulk._STRIPE.pack(3, 1 << 30, 5 << 30) == ref_bulk._STRIPE.pack(3, 1 << 30, 5 << 30)
    assert bulk._CONTROL_IDXS == ref_bulk._CONTROL_IDXS
    assert bulk.STRIPE_THRESHOLD == ref_bulk.STRIPE_THRESHOLD == 64 << 20


def test_pickled_buffer_carries_no_tensor_and_no_socket():
    buf = BulkTransportBuffer()
    buf._conn = object()
    buf._entry = object()
    buf._session_carriers = [object()]
    state = buf.__getstate__()
    assert state["_conn"] is None and state["_entry"] is None
    assert state["_session_carriers"] == [] and state["_card_devices"] == set()
    restored = pickle.loads(pickle.dumps(buf))
    assert restored._conn is None and restored.session == buf.session

    def walk(obj, seen=None):
        seen = seen if seen is not None else set()
        if id(obj) in seen:
            return
        seen.add(id(obj))
        assert not isinstance(obj, (torch.Tensor, __import__("socket").socket)), type(obj)
        if isinstance(obj, dict):
            for v in obj.values():
                walk(v, seen)
        elif isinstance(obj, (list, tuple, set)):
            for v in obj:
                walk(v, seen)

    walk(restored.__dict__)


def counter(name, **labels):
    c = metrics.counter(name)
    return c.value(**labels) if labels else c.total()


async def _failed_put_case() -> dict:
    store = f"port_blkfail_{uuid.uuid4().hex[:6]}"
    await tst.initialize(store_name=store, strategy=tst.SingletonStrategy(
        default_transport_type="bulk"))
    out = {}
    try:
        client = tst.client(store)
        cache = client._ctx.get_cache(BulkClientCache)
        # A first put whose request fails after its bytes were sent: its
        # connection is scoped to the request and never promoted.
        await tst.inject_fault("volume.put", "raise", count=1, store_name=store)
        retries = counter("ts_client_put_retries_total", transport="rpc")
        x = torch.randn(300_000, generator=torch.Generator().manual_seed(5))
        await client.put("first", x)
        out["first_demoted"] = counter("ts_client_put_retries_total", transport="rpc") - retries
        out["promoted_after_failure"] = len(cache.connections)
        await client.put("good", torch.ones(4))  # now a connection is promoted
        conn = next(iter(cache.connections.values()))
        await tst.inject_fault("volume.put", "raise", count=1, store_name=store)
        await client.put("big", x)  # fails on bulk, lands on rpc
        out["same_conn"] = next(iter(cache.connections.values())) is conn and not conn.closed
        out["values"] = [torch.equal(await client.get("first"), x),
                         torch.equal(await client.get("big"), x),
                         torch.equal(await client.get("good"), torch.ones(4))]
        await client.put("after", torch.full((2,), 5.0))
        out["values"].append(torch.equal(await client.get("after"), torch.full((2,), 5.0)))
        await asyncio.sleep(0.2)  # the abort frame rides a background task
        stats = await client.controller.stats.call_one(include_volumes=True)
        (vstats,) = stats["volumes"].values()
        out["volume_bulk"] = vstats["bulk"]
    finally:
        await tst.shutdown(store)
    return out


def test_failed_put_does_not_poison_cache():
    # The reference's case raises a type confusion after the bytes were
    # sent; the port replaces a key across kinds (a documented difference),
    # so an injected fault makes the put fail after its bytes were sent.
    out = run(_failed_put_case)
    assert out["first_demoted"] == 1
    assert out["promoted_after_failure"] == 0  # the failed request's connection closed
    assert out["same_conn"]
    assert all(out["values"])
    vb = out["volume_bulk"]
    assert vb["aborts"] == 2 and vb["pending_payloads"] == 0 and vb["assembling"] == 0


async def _cross_host_case() -> dict:
    store = f"port_xhost_{uuid.uuid4().hex[:6]}"
    await tst.initialize(store_name=store,
                         volume_env_fn=lambda rank: {"TORCHSTORE_TORCH_HOSTNAME": "tst-other-host"})
    out = {}
    try:
        client = tst.client(store)
        await client._ensure_setup()
        (volume,) = client._volume_refs.values()
        out["same_host"] = volume.is_same_host()
        out["ladder"] = [r.value for r in demotion_ladder(volume, client.config)]
        x = torch.randn(1000, generator=torch.Generator().manual_seed(9))
        ops = counter("ts_transport_ops_total", transport="bulk", op="put")
        await tst.put("k", x, store_name=store)
        out["put_on_bulk"] = counter("ts_transport_ops_total", transport="bulk", op="put") - ops
        out["value"] = torch.equal(await tst.get("k", store_name=store), x)
        out["hostname"] = volume.hostname
    finally:
        await tst.shutdown(store)
    return out


def test_another_host_picks_bulk_unforced():
    out = run(_cross_host_case)
    assert out["hostname"] == "tst-other-host" and not out["same_host"]
    assert out["ladder"] == ["bulk", "rpc"]
    assert out["put_on_bulk"] == 1 and out["value"]


async def _staged_case() -> dict:
    store = f"port_stage_{uuid.uuid4().hex[:6]}"
    await tst.initialize(store_name=store, strategy=tst.SingletonStrategy(
        default_transport_type="bulk"))
    out = {}
    try:
        gen = torch.Generator().manual_seed(11)
        big = torch.randn(3 * bulk.STAGE_CHUNK // 4 + 5, generator=gen)  # 4 staging chunks
        small = torch.randn(1000, generator=gen).to(torch.bfloat16)
        await tst.put_batch({"big": big, "small": small}, store_name=store)
        dests = {"big": torch.zeros_like(big), "small": torch.zeros_like(small)}
        got = await tst.get_batch(dests, store_name=store)
        out["in_place"] = all(got[k] is dests[k] for k in dests)
        out["equal"] = (torch.equal(dests["big"], big)
                        and torch.equal(dests["small"].view(torch.int16), small.view(torch.int16)))
    finally:
        await tst.shutdown(store)
    return out


def fake_locks(monkeypatch) -> tuple[list, list]:
    """Page-locking recorded instead of done (no card here): the pointers
    locked and unlocked."""
    locked, unlocked = [], []
    monkeypatch.setattr(bulk, "host_register",
                        lambda t: locked.append(t.data_ptr()) or t.data_ptr())
    monkeypatch.setattr(bulk, "host_unregister", lambda ptrs: unlocked.extend(ptrs))
    return locked, unlocked


def locked_bytes() -> float:
    return metrics.gauge("ts_bulk_staging_locked_bytes").value()


def test_card_staging_pipeline_on_cpu(monkeypatch):
    # Every payload takes the card path (host staging, chunked frames),
    # with host copies in place of the card's: the pipeline's order and
    # chunking are the ones a card runs.
    monkeypatch.setattr(bulk, "_on_card", lambda t: True)
    monkeypatch.setattr(bulk, "STAGE_CHUNK", 1 << 20)
    locked, unlocked = fake_locks(monkeypatch)
    before = locked_bytes()
    out = run(_staged_case)
    assert out["in_place"] and out["equal"]
    # Both rings of the connections that carried card payloads were locked,
    # and shutdown unlocked every buffer.
    assert locked and sorted(unlocked) == sorted(locked)
    assert locked_bytes() == before


def test_staging_ring_locks_each_buffer_once_and_unlocks_on_release(monkeypatch):
    locked, unlocked = fake_locks(monkeypatch)
    monkeypatch.setattr(bulk, "STAGE_CHUNK", 4096)
    before = locked_bytes()
    ring = bulk._StagingRing()
    a, b = ring.buffer(0), ring.buffer(1)
    assert ring.buffer(0) is a and ring.buffer(1) is b
    assert locked == [a.data_ptr(), b.data_ptr()]
    assert locked_bytes() - before == 2 * 4096
    ring.release()
    assert unlocked == locked and locked_bytes() == before
    with pytest.raises(ConnectionError):
        ring.buffer(0)  # a send racing the close makes no new buffer
    assert len(locked) == 2


async def _conn_close_case(how: str) -> tuple[list, bool]:
    import socket

    mine, peer = socket.socketpair()
    mine.setblocking(False)
    conn = bulk.BulkClientConn(mine)
    ring = conn.ring("send")
    ring.buffer(0)
    conn.ring("recv").buffer(1)
    if how == "peer_closes":
        peer.close()
    elif how == "close_now":
        conn.close_now()
    else:  # the client's cache is cleared (store shutdown)
        cache = BulkClientCache()
        cache.connections["v"] = conn
        cache.clear()
    await asyncio.wait_for(conn._reader_task, 5)
    peer.close()
    with pytest.raises(ConnectionError):
        conn.ring("other")
    return ring.released, conn.closed


@pytest.mark.parametrize("how", ["peer_closes", "close_now", "cache_cleared"])
def test_connection_close_releases_staging(monkeypatch, how):
    locked, unlocked = fake_locks(monkeypatch)
    monkeypatch.setattr(bulk, "STAGE_CHUNK", 4096)
    before = locked_bytes()
    released, closed = run(_conn_close_case, how)
    assert released and closed
    assert len(locked) == 2 and sorted(unlocked) == sorted(locked)
    assert locked_bytes() == before


async def _failed_staged_put_case() -> dict:
    store = f"port_stgfail_{uuid.uuid4().hex[:6]}"
    await tst.initialize(store_name=store, strategy=tst.SingletonStrategy(
        default_transport_type="bulk"))
    out = {}
    try:
        client = tst.client(store)
        x = torch.randn(300_000, generator=torch.Generator().manual_seed(6))
        before = locked_bytes()
        await tst.inject_fault("volume.put", "raise", count=1, store_name=store)
        await client.put("failed", x)  # fails on bulk after its bytes went, lands on rpc
        await asyncio.sleep(0.2)  # the scoped connection closes in a background task
        out["after_failure"] = locked_bytes() - before
        await client.put("good", x)
        out["after_good"] = locked_bytes() - before
        out["values"] = [torch.equal(await client.get("failed"), x),
                         torch.equal(await client.get("good"), x)]
    finally:
        await tst.shutdown(store)
    out["after_shutdown"] = locked_bytes() - before
    return out


def test_failed_put_releases_staging(monkeypatch):
    # A failed, never promoted connection unlocks its staging; a promoted
    # one keeps it until the store shuts down.
    monkeypatch.setattr(bulk, "_on_card", lambda t: True)
    monkeypatch.setattr(bulk, "STAGE_CHUNK", 1 << 20)
    locked, unlocked = fake_locks(monkeypatch)
    out = run(_failed_staged_put_case)
    assert all(out["values"])
    assert out["after_failure"] == 0
    assert out["after_good"] > 0
    assert out["after_shutdown"] == 0 and sorted(unlocked) == sorted(locked)


@pytest.mark.parametrize("forced", [None, "shm", "bulk", "rpc"])
@pytest.mark.parametrize("same_host", [True, False], ids=["same_host", "other_host"])
@pytest.mark.parametrize("cfg", [{}, {"shm_enabled": False}, {"bulk_tcp_enabled": False}],
                         ids=["default", "no_shm", "no_bulk"])
def test_demotion_ladder_equals_reference(forced, same_host, cfg):
    from torchstore_tpu.strategy import StorageVolumeRef as RefVolumeRef
    from torchstore_tpu.transport.buffers import TransportContext as RefContext
    from torchstore_tpu.transport.factory import demotion_ladder as ref_ladder
    from torchstore_tpu.utils import get_hostname as ref_hostname
    from torchstore_tpu_torch.config import StoreConfig
    from torchstore_tpu_torch.strategy import StorageVolumeRef
    from torchstore_tpu_torch.transport.buffers import TransportContext
    from torchstore_tpu_torch.utils import get_hostname

    port_vol = StorageVolumeRef(actor=None, volume_id="0", transport_context=TransportContext(),
                                hostname=get_hostname() if same_host else "elsewhere",
                                transport_type=forced)
    ref_vol = RefVolumeRef(actor=None, volume_id="0", transport_context=RefContext(),
                           hostname=ref_hostname() if same_host else "elsewhere",
                           transport_type=forced)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_shm, "is_available", lambda: True)
        want = [r.value for r in ref_ladder(ref_vol, RefStoreConfig(**cfg))]
    assert [r.value for r in demotion_ladder(port_vol, StoreConfig(**cfg))] == want
    assert TransportType(want[0]).value == want[0]


async def _lease_case() -> dict:
    from torchstore_tpu_torch.transport.buffers import Served, TransportContext
    from torchstore_tpu_torch.transport.bulk import BulkServerCache
    from torchstore_tpu_torch.transport.shared_memory import ShmSegment, ShmServerCache
    from torchstore_tpu_torch.transport.types import Request, TensorMeta

    ctx = TransportContext()
    shm = ctx.get_cache(ShmServerCache)
    meta = TensorMeta((1024,), "float32")
    seg = ShmSegment.create(meta.nbytes)
    view = seg.view(meta)
    shm.put("k", None, seg, meta, 0, view)
    gate = asyncio.Event()
    server = ctx.get_cache(BulkServerCache).server
    server.send_background = lambda cid, session, payloads: [asyncio.ensure_future(gate.wait())]
    out = {}
    try:
        await BulkTransportBuffer().handle_get_request(
            ctx, [Request(key="k", tensor_meta=meta)], [Served(view, ("k", None))])
        out["leased"] = shm.grants.get(seg.name)
        seg2 = ShmSegment.create(meta.nbytes)
        shm.put("k", None, seg2, meta, 0, seg2.view(meta))  # a same-layout re-put
        out["retired_while_sent"] = seg.name in shm.retired and seg.name not in shm.free
        gate.set()
        for _ in range(3):
            await asyncio.sleep(0)
        out["pooled_after"] = seg.name in shm.free and seg.name not in shm.grants
    finally:
        shm.clear()
    return out


def test_bulk_send_of_a_segment_holds_a_lease():
    # A volume serving an shm-landed segment over bulk (a reader on another
    # host) leases it for the send: a re-put of the key cannot reuse it
    # under the bytes on the wire.
    assert run(_lease_case) == {"leased": 1, "retired_while_sent": True, "pooled_after": True}
