"""Port parity for the rest of direct weight sync (the twin of the rest of
``tests/test_direct_weight_sync.py``): the TCP path, ranged TCP reads into a
``Shard`` target, buffer-less ``Shard`` targets, buffer ids of two ranks
colliding, a dead buffer, pulls against concurrent refreshes, the
generation seqlock, the state-dict layer's one retry, and the ordered
one-hop pull (``key_order`` / ``on_layer``) held against the JAX package's
order and values. The same seeded numpy inputs go through both packages;
results are compared bit for bit.

The device rung ignores ordering in both packages; ``MemClient`` (an
in-memory stand-in for a store client) lets both packages' state-dict
layers run that case without store processes. The JAX package's sources
run without shared memory (over TCP): its results do not depend on the
rung, and it adds no ``ts_shm_*`` segments to the machine-wide counts of
its own tests."""

import asyncio
import uuid

import anyio
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

import torchstore_tpu as ts_ref
import torchstore_tpu_torch as tst
from torchstore_tpu import state_dict_utils as ref_sdu
from torchstore_tpu.config import StoreConfig as RefStoreConfig
from torchstore_tpu.direct_weight_sync import (
    DirectWeightSyncDest as RefDest,
    DirectWeightSyncSource as RefSource,
    _row_range as ref_row_range,
)
from torchstore_tpu_torch import direct_weight_sync as dws
from torchstore_tpu_torch import state_dict_utils as port_sdu
from torchstore_tpu_torch.config import StoreConfig
from torchstore_tpu_torch.direct_weight_sync import (
    DirectWeightSyncDest,
    DirectWeightSyncSource,
    PullRaceError,
)

TIMEOUT_S = 60


def rows(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def as_port(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.fixture
async def pair(request):
    use_shm = getattr(request, "param", True)
    source = DirectWeightSyncSource(use_shm=use_shm, device=False)
    dest = DirectWeightSyncDest()
    yield source, dest
    await dest.close()
    await source.close()


@pytest.fixture
async def port_store():
    name = f"ext_{uuid.uuid4().hex[:8]}"
    await tst.initialize(store_name=name)
    yield name
    await tst.shutdown(name)


async def test_tcp_path():
    w = rows(0, (64,))
    with anyio.fail_after(TIMEOUT_S):
        ref_source, ref_dest = RefSource(use_shm=False, device=False), RefDest()
        try:
            ref_handles = await ref_source.register({"w": w})
            ref = await ref_dest.pull(ref_handles, {"w": np.zeros_like(w)})
        finally:
            await ref_dest.close()
            await ref_source.close()
        source, dest = DirectWeightSyncSource(use_shm=False, device=False), DirectWeightSyncDest()
        try:
            handles = await source.register({"w": torch.from_numpy(w.copy())})
            assert handles["w"][0].shm_name is None
            out = await dest.pull(handles, {"w": torch.zeros(64)})
            np.testing.assert_array_equal(out["w"].numpy(), ref["w"])
        finally:
            await dest.close()
            await source.close()


@pytest.mark.parametrize("lo,hi", [(16, 24), (0, 8), (56, 64)])
async def test_ranged_tcp_reads_with_shard_target(lo, hi):
    """A Shard target pulls only its rows over TCP (a ranged read, fewer
    bytes on the wire) into the buffer it provides; both packages plan the
    same row range."""
    w = np.arange(64 * 8, dtype=np.float32).reshape(64, 8)
    with anyio.fail_after(TIMEOUT_S):
        ref_source, ref_dest = RefSource(use_shm=False, device=False), RefDest()
        try:
            ref_handles = await ref_source.register({"w": w})
            sl = ts_ref.TensorSlice((lo, 0), (hi - lo, 8), (64, 8), (0,), (1,))
            ref_target = np.zeros((hi - lo, 8), np.float32)
            await ref_dest.pull(ref_handles, {"w": ts_ref.Shard(ref_target, sl)})
            ref_range = ref_row_range(ref_handles["w"][0], ref_dest._plan)
        finally:
            await ref_dest.close()
            await ref_source.close()
        source, dest = DirectWeightSyncSource(use_shm=False, device=False), DirectWeightSyncDest()
        try:
            handles = await source.register({"w": torch.from_numpy(w.copy())})
            sl = tst.TensorSlice((lo, 0), (hi - lo, 8), (64, 8), (0,), (1,))
            target = torch.zeros(hi - lo, 8)
            read = []
            real = dest._read_shard

            async def counting(handle, pin=False, row_range=None):
                arr, row0 = await real(handle, pin, row_range)
                read.append((row0, arr.shape[0]))
                return arr, row0

            dest._read_shard = counting
            out = await dest.pull(handles, {"w": tst.Shard(target, sl)})
            assert out["w"] is target
            np.testing.assert_array_equal(target.numpy(), ref_target)
            assert dws._row_range(handles["w"][0], dest._plan) == ref_range == (lo, hi)
            assert read == [(lo, hi - lo)]  # only the planned rows crossed
        finally:
            await dest.close()
            await source.close()


@pytest.mark.parametrize("pair", [True, False], ids=["shm", "tcp"], indirect=True)
async def test_bufferless_shard_target(pair):
    source, dest = pair
    w = np.arange(32.0, dtype=np.float32).reshape(8, 4)
    with anyio.fail_after(TIMEOUT_S):
        ref_source, ref_dest = RefSource(use_shm=False, device=False), RefDest()
        try:
            ref_handles = await ref_source.register({"w": w})
            sl = ts_ref.TensorSlice((2, 0), (4, 4), (8, 4), (0,), (1,))
            ref = await ref_dest.pull(ref_handles, {"w": ts_ref.Shard(None, sl)})
        finally:
            await ref_dest.close()
            await ref_source.close()
        handles = await source.register({"w": torch.from_numpy(w.copy())})
        sl = tst.TensorSlice((2, 0), (4, 4), (8, 4), (0,), (1,))
        out = await dest.pull(handles, {"w": tst.Shard(None, sl)})
        assert out["w"].dtype == torch.float32 and out["w"].shape == (4, 4)
        np.testing.assert_array_equal(out["w"].numpy(), ref["w"])


async def test_multi_rank_buffer_id_collision():
    """Two sources number their buffers from 0: the dest keys reads by
    (host, port, id), never the bare id, or the ranks' shards collapse."""
    w = np.arange(64.0, dtype=np.float32).reshape(8, 8)
    s0, s1 = (DirectWeightSyncSource(use_shm=False, device=False) for _ in range(2))
    dest = DirectWeightSyncDest()
    try:
        h0 = await s0.register({"w": tst.Shard(torch.from_numpy(w[:4].copy()),
                                               tst.TensorSlice((0, 0), (4, 8), (8, 8), (0,), (2,)))})
        h1 = await s1.register({"w": tst.Shard(torch.from_numpy(w[4:].copy()),
                                               tst.TensorSlice((4, 0), (4, 8), (8, 8), (1,), (2,)))})
        assert h0["w"][0].buffer_id == h1["w"][0].buffer_id  # the collision
        out = await dest.pull({"w": [h0["w"][0], h1["w"][0]]}, {"w": torch.zeros(8, 8)})
        np.testing.assert_array_equal(out["w"].numpy(), w)
    finally:
        await dest.close()
        await s0.close()
        await s1.close()


async def test_dead_buffer_raises(pair):
    source, dest = pair
    gone = DirectWeightSyncSource(use_shm=False, device=False)
    handles = await gone.register({"w": torch.ones(4)})
    await gone.close()
    other = DirectWeightSyncSource(use_shm=False, device=False)
    await other.register({"other": torch.ones(2)})
    try:
        (h,) = handles["w"]
        bad = {"w": [dws.WeightHandle(**{**h.__dict__, "port": other.server.port,
                                         "buffer_id": 999})]}
        with pytest.raises(KeyError, match="no longer has buffer"):
            await dest.pull(bad, {"w": torch.zeros(4)})
        with pytest.raises(KeyError, match="is gone"):
            await dest.pull(handles, {"w": torch.zeros(4)})  # its server stopped
    finally:
        await other.close()


async def test_concurrent_refresh_pull_is_consistent():
    """A pull concurrent with refreshes returns one publish: every tensor of
    the same step, never a mix (or it raises, detected)."""
    source = DirectWeightSyncSource(use_shm=False, device=False)
    dest = DirectWeightSyncDest()
    try:
        live = {"a": torch.zeros(256), "b": torch.zeros(256)}
        handles = await source.register(live)
        stop = asyncio.Event()

        async def refresher():
            step = 0
            while not stop.is_set():
                step += 1
                for t in live.values():
                    t.fill_(float(step))
                await source.refresh()
                await asyncio.sleep(0.003)

        task = asyncio.create_task(refresher())
        delivered = 0
        try:
            with anyio.fail_after(TIMEOUT_S):
                for _ in range(20):
                    try:
                        out = await dest.pull(handles, {"a": torch.zeros(256),
                                                        "b": torch.zeros(256)})
                    except PullRaceError as exc:
                        assert "torn" in str(exc)
                        continue
                    delivered += 1
                    assert out["a"][0] == out["b"][0]
                    assert bool((out["a"] == out["a"][0]).all() and (out["b"] == out["b"][0]).all())
        finally:
            stop.set()
            await task
        assert delivered > 0
    finally:
        await dest.close()
        await source.close()


@pytest.mark.parametrize("rung", ["host", "device"])
async def test_gen_bumps_by_two_per_publish(monkeypatch, rung):
    if rung == "device":
        monkeypatch.setattr(dws, "device_rung_eligible", lambda shards, config: True)
    ref = RefSource(device=False, use_shm=False)
    source = DirectWeightSyncSource(use_shm=False)
    try:
        await ref.register({"w": np.zeros(8, np.float32)})
        await source.register({"w": torch.zeros(8)})
        assert (source.device_info is not None) == (rung == "device")
        assert source._gen == ref._gen == 0
        ref.update_sources({"w": np.ones(8, np.float32)})
        await ref.refresh()
        source.update_sources({"w": torch.ones(8)})
        await source.refresh()
        assert source._gen == ref._gen == 2 and source._read_gen() == 2
    finally:
        await source.close()
        await ref.close()


async def test_pull_detects_and_retries_once(pair, monkeypatch):
    """A generation change between the pre- and post-read: the pull
    retries once, counted, and the stable second attempt returns."""
    source, dest = pair
    w = torch.arange(64.0)
    handles = await source.register({"w": w})
    real_read = dest._read_gen
    calls = {"n": 0}

    async def flaky_read(host, port):
        calls["n"] += 1
        if calls["n"] == 2:  # the post-read of attempt 1
            return 1_000_000
        return await real_read(host, port)

    monkeypatch.setattr(dest, "_read_gen", flaky_read)
    retries = dws.PULL_RETRIES.total()
    out = await dest.pull(handles, {"w": torch.zeros(64)})
    assert torch.equal(out["w"], w)
    assert calls["n"] >= 3 and dws.PULL_RETRIES.total() == retries + 1


async def test_state_dict_layer_retries_pull_race(port_store, monkeypatch):
    """A PullRaceError does not reach the caller on the first bounce: the
    state-dict layer drops its cached handles and retries once."""
    sd = {"w": torch.arange(32.0)}
    await tst.put_state_dict("m", sd, direct=True, store_name=port_store)
    real_pull = DirectWeightSyncDest.pull
    calls = {"n": 0}

    async def flaky_pull(self, handles, dest, key_order=None, on_layer=None):
        calls["n"] += 1
        if calls["n"] == 1:
            raise PullRaceError("source refresh never settled")
        return await real_pull(self, handles, dest, key_order, on_layer)

    monkeypatch.setattr(DirectWeightSyncDest, "pull", flaky_pull)
    out = await tst.get_state_dict("m", {"w": torch.zeros(32)}, direct=True,
                                   store_name=port_store)
    assert torch.equal(out["w"], sd["w"]) and calls["n"] == 2


# --------------------------------------------------------------------------
# the ordered one-hop pull
# --------------------------------------------------------------------------

KEYS = ("embed", "layers/0/w", "layers/1/w", "final_norm", "lm_head")
ORDER = ["embed", "layers/0/w", "absent", "layers/1/w", "lm_head"]  # final_norm: the tail


def ordered_tree(seed):
    return {k: rows(seed + i, (4 + i, 3)) for i, k in enumerate(KEYS)}


def nest(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


@pytest.mark.parametrize("use_shm", [True, False], ids=["shm", "tcp"])
@pytest.mark.parametrize("asynchronous", [False, True], ids=["sync", "async"])
async def test_ordered_waves_match_the_reference(use_shm, asynchronous):
    """``key_order`` / ``on_layer`` on the host rung: keys land and are
    served in the given order (keys it leaves out after it), each read
    once, with the values the JAX package serves in the same order."""
    tree = ordered_tree(10)
    targets_np = nest({k: np.zeros_like(v) for k, v in tree.items()})

    def recorder(log):
        if asynchronous:
            async def on_layer(key, value):
                log.append((key, np.array(value)))
        else:
            def on_layer(key, value):
                log.append((key, np.array(value)))
        return on_layer

    with anyio.fail_after(TIMEOUT_S):
        ref_log: list = []
        ref_source, ref_dest = RefSource(use_shm=False, device=False), RefDest()
        try:
            ref_handles = await ref_source.register(nest(tree))
            await ref_dest.pull(ref_handles, targets_np, key_order=ORDER,
                                on_layer=recorder(ref_log))
        finally:
            await ref_dest.close()
            await ref_source.close()
        log: list = []
        source, dest = DirectWeightSyncSource(use_shm=use_shm, device=False), DirectWeightSyncDest()
        try:
            handles = await source.register(nest(as_port(tree)))
            reads = []
            real = dest._read_shard

            async def counting(handle, pin=False, row_range=None):
                reads.append(handle.buffer_id)
                return await real(handle, pin, row_range)

            dest._read_shard = counting
            targets = nest({k: torch.zeros(v.shape) for k, v in tree.items()})
            await dest.pull(handles, targets, key_order=ORDER, on_layer=recorder(log))
        finally:
            await dest.close()
            await source.close()
    assert [k for k, _ in log] == [k for k, _ in ref_log] == [
        "embed", "layers/0/w", "layers/1/w", "lm_head", "final_norm"]
    for (k, got), (_, want) in zip(log, ref_log):
        np.testing.assert_array_equal(got, want, err_msg=k)
    assert sorted(reads) == sorted(h.buffer_id for hs in handles.values() for h in hs)


async def test_ordered_pull_through_the_store(port_store):
    """``get_state_dict(direct=True, key_order=..., on_layer=...)`` serves
    keys in order on the host rung (it raised before the ordered pull was
    ported)."""
    tree = as_port(ordered_tree(20))
    await tst.put_state_dict("o", nest(tree), direct=True, store_name=port_store)
    served = []
    targets = nest({k: torch.zeros(v.shape) for k, v in tree.items()})
    out = await tst.get_state_dict("o", targets, direct=True, key_order=ORDER,
                                   on_layer=lambda k, v: served.append(k),
                                   store_name=port_store)
    assert served == ["embed", "layers/0/w", "layers/1/w", "lm_head", "final_norm"]
    for k, v in tree.items():
        node = out
        for part in k.split("/"):
            node = node[part]
        assert torch.equal(node, v), k


class MemClient:
    """A store client's put/get in process memory (both packages' direct
    state-dict layers use only these and their config)."""

    def __init__(self, config):
        self.kv = {}
        self.config = self._config = config

    async def put(self, key, value):
        self.kv[key] = value

    async def get(self, key):
        return self.kv[key]


async def test_device_rung_ignores_ordering_in_both_packages(monkeypatch):
    """The device rung pulls every key at once: ``key_order`` / ``on_layer``
    are dropped, in the JAX package (its ``pull_device`` takes none) and in
    the port alike; the values still match."""
    tree = ordered_tree(30)
    monkeypatch.setattr(dws, "device_rung_eligible", lambda shards, config: True)
    ref_client, port_client = MemClient(RefStoreConfig()), MemClient(StoreConfig())
    ref_log, port_log = [], []
    sh = NamedSharding(Mesh(np.array(jax.devices()[:1], dtype=object), ("x",)), P())
    try:
        with anyio.fail_after(TIMEOUT_S):
            await ref_sdu.put_state_dict(
                ref_client, "d", nest({k: jax.device_put(v, sh) for k, v in tree.items()}),
                direct=True)
            assert (await ref_client.get("d/rank_0"))["device"] is not None
            ref_out = await ref_sdu.get_state_dict(
                ref_client, "d", nest({k: np.zeros_like(v) for k, v in tree.items()}),
                direct=True, key_order=ORDER, on_layer=lambda k, v: ref_log.append(k))
            await port_sdu.put_state_dict(port_client, "d", nest(as_port(tree)), direct=True)
            assert (await port_client.get("d/rank_0"))["device"] is not None
            port_out = await port_sdu.get_state_dict(
                port_client, "d", nest({k: torch.zeros(v.shape) for k, v in tree.items()}),
                direct=True, key_order=ORDER, on_layer=lambda k, v: port_log.append(k))
    finally:
        await ref_sdu.close_direct_caches(ref_client)
        await port_sdu.close_direct_caches(port_client)
    assert ref_log == port_log == []
    for k in KEYS:
        ref_node, port_node = ref_out, port_out
        for part in k.split("/"):
            ref_node, port_node = ref_node[part], port_node[part]
        np.testing.assert_array_equal(port_node.numpy(), np.asarray(ref_node), err_msg=k)


async def test_strict_checks_device_entries(monkeypatch):
    """``strict`` holds a device-rung pull to every published key, as the
    host rung's; ``strict=False`` pulls a subset."""
    monkeypatch.setattr(dws, "device_rung_eligible", lambda shards, config: True)
    client = MemClient(StoreConfig())
    try:
        await port_sdu.put_state_dict(client, "s", {"a": torch.ones(3), "b": torch.ones(2)},
                                      direct=True)
        with pytest.raises(ValueError, match="missing in user dict"):
            await port_sdu.get_state_dict(client, "s", {"a": torch.zeros(3)}, direct=True)
        out = await port_sdu.get_state_dict(client, "s", {"a": torch.zeros(3)}, direct=True,
                                            strict=False)
        assert torch.equal(out["a"], torch.ones(3))
    finally:
        await port_sdu.close_direct_caches(client)
