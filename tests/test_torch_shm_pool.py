"""The port's pooled shared-memory segments, read leases, put handshake and
the store's waits, stats and replicated puts, held to the JAX package.

- Pure functions (arena layout, the default pool cap, the replica sets of
  ``select_put_volume_ids``) are compared with the JAX package's exactly.
- The pool's behaviour is held to the assertions of the reference's own
  tests (``tests/test_shared_memory.py``, ``tests/test_zero_copy.py``,
  ``tests/test_store.py``, ``tests/test_weight_channel.py``), run on the
  port alone: the reference's copies count every ``ts_shm_*`` segment on
  the machine, so the reference never runs its shared-memory rung here.
- A multi-round RL loop (put, get, in-place update, re-put, get) runs
  through both packages from one numpy seed, the reference with its
  shared-memory rung off, and the results are compared bit for bit at bf16.

Each package runs one store session for its cases (the module fixtures
below); the tests hold the recorded results. Leases and pinning are also
checked on the caches directly, with ``cudart`` stubbed.
"""

import asyncio
import contextlib
import gc
import inspect
import multiprocessing
import os
import random
import threading
import time
import uuid

import ml_dtypes
import numpy as np
import pytest
import torch

import torchstore_tpu as ts_ref
import torchstore_tpu_torch as tst
from torchstore_tpu import config as ref_config
from torchstore_tpu import strategy as ref_strategy
from torchstore_tpu.config import StoreConfig as RefStoreConfig
from torchstore_tpu.transport import landing as ref_landing
from torchstore_tpu.transport import shared_memory as ref_shm
from torchstore_tpu_torch import config as port_config
from torchstore_tpu_torch import strategy as port_strategy
from torchstore_tpu_torch.client import LocalClient
from torchstore_tpu_torch.controller import Controller
from torchstore_tpu_torch.runtime import spawn_actors
from torchstore_tpu_torch.runtime.actors import get_or_spawn_singleton, stop_singleton
from torchstore_tpu_torch.storage_volume import StorageVolume
from torchstore_tpu_torch.transport import landing, shared_memory as shm
from torchstore_tpu_torch.transport.rpc import RPCTransportBuffer
from torchstore_tpu_torch.transport.types import Request, TensorMeta, TensorSlice

ROUNDS = 3
# Over the inline size, so every put pays the handshake: the embedding gets
# a segment of its own, the rest share the arena.
LOOP_SHAPES = {"embed": (640, 256), "w1": (256, 384), "w2": (384, 256), "norm": (256,)}


def run(coro_fn, *args):
    return asyncio.run(asyncio.wait_for(coro_fn(*args), timeout=240))


def own_segments(pids) -> set[str]:
    out = set()
    for name in os.listdir(shm.SHM_DIR):
        if name.startswith(shm.PREFIX) and int(name[len(shm.PREFIX):].split("_")[0]) in pids:
            out.add(name)
    return out


def loop_tree(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in LOOP_SHAPES.items()}


def bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16).copy()
    return np.asarray(x).view(np.uint16).copy()


async def volume_stats(client) -> dict:
    stats = await client.controller.stats.call_one(include_volumes=True)
    (vstats,) = stats["volumes"].values()
    return vstats


async def settle(client) -> dict:
    """The volume's stats once no warm-up is in flight (the gap a training
    step leaves between two puts)."""
    for _ in range(200):
        vstats = await volume_stats(client)
        if vstats.get("shm", {}).get("warming", 0) == 0:
            return vstats
        await asyncio.sleep(0.05)
    raise TimeoutError("pool warm-ups still in flight")


def pool_counts(vstats: dict, client) -> dict:
    cache = client._ctx.peek(shm.ShmClientCache)
    return {
        **vstats["shm"]["offers"],
        "created": vstats["shm"]["segments_created"],
        "recycled": vstats["shm"]["segments_recycled"],
        "cold_create": 0 if cache is None else cache.counts["cold_create"],
    }


def delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


# --------------------------------------------------------------------------
# pure functions against the JAX package
# --------------------------------------------------------------------------


@pytest.mark.parametrize(
    "sizes",
    [[1], [0, 0, 3], [64, 64, 64], [1, 63, 65, 127, 129], [8192] * 7 + [5, 4096],
     [3, 1 << 18, 0, 17, 255, 256, 257], list(range(0, 600, 37))],
)
def test_arena_layout_matches_reference(sizes):
    assert landing.ARENA_ALIGN == ref_landing.ARENA_ALIGN
    assert landing.compute_arena_layout(sizes) == ref_landing.compute_arena_layout(sizes)
    for n in sizes:
        assert landing.align_up(n) == ref_landing.align_up(n)


@pytest.mark.parametrize("avail", [0, 1 << 30, 16 << 30, 100 << 30, 256 << 30, 1 << 40, None])
def test_default_pool_cap_matches_reference(avail, monkeypatch):
    def statvfs(path):
        assert path == "/dev/shm"
        if avail is None:
            raise OSError("no /dev/shm")
        return os.statvfs_result((4096, 4096, 0, 0, avail // 4096, 0, 0, 0, 0, 255))

    monkeypatch.setattr(os, "statvfs", statvfs)
    assert port_config._default_shm_pool_cap() == ref_config._default_shm_pool_cap()


@pytest.mark.parametrize("replication", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_select_put_volume_ids_matches_reference(replication, seed):
    ids = [str(i) for i in range(5)] + ["host-a", "host-b"]
    random.Random(seed).shuffle(ids)
    port = port_strategy.LocalRankStrategy(replication=replication)
    ref = ref_strategy.LocalRankStrategy(replication=replication)
    for client_id in ["0", "3", "4"]:
        got = port.select_put_volume_ids(client_id, ids)
        assert got == ref.select_put_volume_ids(client_id, ids)
        assert got[0] == client_id and len(set(got)) == replication
    single = port_strategy.SingletonStrategy(replication=1)
    assert single.select_put_volume_ids("x", ["0"]) == ["0"]
    with pytest.raises(ValueError, match="exceeds"):
        port_strategy.LocalRankStrategy(replication=len(ids) + 1).select_put_volume_ids("0", ids)
    with pytest.raises(ValueError, match=">= 1"):
        port_strategy.LocalRankStrategy(replication=0)


def test_host_strategy_reads_the_port_hostname(monkeypatch):
    monkeypatch.setenv("TORCHSTORE_TPU_HOSTNAME", "reference-host")
    monkeypatch.setenv("TORCHSTORE_TORCH_HOSTNAME", "port-host")
    strategy = tst.HostStrategy()
    assert strategy.get_volume_id() == strategy.get_client_id() == "port-host"


# --------------------------------------------------------------------------
# the caches on their own
# --------------------------------------------------------------------------


@pytest.fixture
def server_cache():
    cache = shm.ShmServerCache()
    yield cache
    cache.clear()


def test_release_batches_apply_exactly_once(server_cache):
    seg = shm.ShmSegment.create(4096)
    tmeta = TensorMeta((1024,), "float32")
    view = seg.view(tmeta)
    server_cache.put("k", None, seg, tmeta, 0, view)
    server_cache.grant(seg.name)
    server_cache.grant(seg.name)
    # Replaced while two leases are out: retired, not pooled.
    other = shm.ShmSegment.create(4096)
    server_cache.put("k", None, other, tmeta, 0, other.view(tmeta))
    assert seg.name in server_cache.retired and not server_cache.free
    one = {"client": "c", "batches": [(1, {seg.name: 1})]}
    server_cache.apply_releases(one)
    server_cache.apply_releases(one)  # sent again: applied once
    assert server_cache.grants[seg.name] == 1 and seg.name in server_cache.retired
    server_cache.apply_releases({"client": "c", "batches": [(1, {seg.name: 1}),
                                                            (2, {seg.name: 1})]})
    assert seg.name not in server_cache.grants
    assert list(server_cache.free) == [seg.name]  # released: back in the pool
    assert server_cache.take_free(4096) is seg and seg.was_live
    server_cache.note_reuse(seg)  # a put takes it: recycled
    fresh = shm.ShmSegment.create(4096)
    server_cache.note_reuse(fresh)  # never backed an entry: not recycled
    assert server_cache.counts["recycled"] == 1
    fresh.unlink()
    seg.unlink()  # taken out of the pool: the cache no longer owns it


def test_pool_cap_evicts_oldest_first(server_cache):
    server_cache.pool_cap = 3 * 4096
    segs = [shm.ShmSegment.create(4096) for _ in range(5)]
    for seg in segs:
        server_cache._add_free(seg)
    assert list(server_cache.free) == [s.name for s in segs[2:]]
    assert server_cache.free_bytes == 3 * 4096
    for seg in segs[:2]:
        assert not os.path.exists(shm.ShmSegment.path(seg.name))
    assert server_cache.take_free(4096) is segs[-1]  # the warmest
    assert server_cache.take_free(8192) is None
    segs[-1].unlink()


class Cudart:
    def __init__(self):
        self.registered: list = []
        self.unregistered: list = []

    def cudaHostRegister(self, ptr, size, flags):
        self.registered.append((ptr, size))
        return 0

    def cudaHostUnregister(self, ptr):
        self.unregistered.append(ptr)
        return 0


def test_client_pins_reused_attachments_and_unpins_them(monkeypatch):
    cudart = Cudart()
    monkeypatch.setattr(torch.cuda, "cudart", lambda: cudart)
    cache = shm.ShmClientCache()
    spares = [shm.ShmSegment.create(4096) for _ in range(3)]

    async def scenario():
        a, b = shm.ShmSegment.create(8192), shm.ShmSegment.create(4096)
        cache.add_cold(a, "a")
        cache.add_cold(b, "b")
        cache.note_card_use([a, b])  # a cold put pays no lock
        await cache.wait_pinned()
        assert not cudart.registered
        await cache.begin_landing()  # a copy in flight: locking waits for it
        cache.note_card_use([a])  # reused: queued
        await asyncio.sleep(0.05)
        assert not cudart.registered
        cache.end_landing()
        await cache.wait_pinned()
        assert cudart.registered == [(a.pinned, 8192)] and cache.pin_seconds > 0
        cache.note_card_use([a, b])
        await cache.wait_pinned()
        assert len(cudart.registered) == 2  # b now, a was locked already
        # Spares a put from the host announced are attached only; from a
        # card, locked too.
        cache.pre_attach([(s.name, s.size) for s in spares], pin=False)
        await asyncio.gather(*list(cache._pre_attach_tasks))
        assert all(s.name in cache.segments for s in spares) and len(cudart.registered) == 2
        cache.pre_attach([(s.name, s.size) for s in spares], pin=True)
        await asyncio.gather(*list(cache._pre_attach_tasks))
        await cache.wait_pinned()
        assert len(cudart.registered) == 5 and cache.counts["pinned"] == 5
        # A failed lock is raised to the caller, not swallowed.
        c = shm.ShmSegment.create(4096)
        cache.add_cold(c, "c")
        monkeypatch.setattr(cudart, "cudaHostRegister", lambda ptr, size, flags: 2)
        cache.note_card_use([c])
        cache.note_card_use([c])
        with pytest.raises(RuntimeError, match="cudaHostRegister"):
            await cache.wait_pinned()
        c.unlink()
        return a, b

    try:
        a, b = asyncio.run(scenario())
        cache.delete_key("a")  # unpinned before the mapping goes
        assert cudart.unregistered == [cudart.registered[0][0]]
        b.unlink()
        cache.evict_unlinked()  # the volume unlinked b
        assert len(cudart.unregistered) == 2 and b.name not in cache.segments
        # Dropped while a copy runs through it: unpinned when that ends.
        seg = cache.segments[spares[0].name]
        seg.busy += 1
        cache._drop(seg.name)
        assert seg.pinned is not None and len(cudart.unregistered) == 2
        seg.idle()
        assert seg.pinned is None and len(cudart.unregistered) == 3
        cache.clear()  # close and shutdown unpin every attachment
        assert len(cudart.unregistered) == 5 and not cache.segments
        a.unlink()
    finally:
        cache.clear()
        for s in spares:
            s.unlink()


def test_landing_waits_for_the_registration_in_progress(monkeypatch):
    # cudaHostRegister serializes with the copies in the driver: a landing
    # that finds a registration running waits for it (and counts the wait),
    # and no registration starts while a landing is in flight.
    cudart = Cudart()
    started, release = threading.Event(), threading.Event()
    register = cudart.cudaHostRegister

    def slow_register(ptr, size, flags):
        started.set()
        release.wait(10)
        return register(ptr, size, flags)

    cudart.cudaHostRegister = slow_register
    monkeypatch.setattr(torch.cuda, "cudart", lambda: cudart)
    cache = shm.ShmClientCache()
    segs = [shm.ShmSegment.create(4096) for _ in range(2)]

    async def scenario():
        cache.schedule_pin([segs[0]])
        assert await asyncio.get_running_loop().run_in_executor(None, started.wait, 10)
        landing = asyncio.ensure_future(cache.begin_landing())
        await asyncio.sleep(0.1)
        assert not landing.done()  # held behind the registration
        release.set()
        await asyncio.wait_for(landing, 10)
        assert segs[0].pinned is not None and cache.pin_wait_seconds >= 0.1
        cache.schedule_pin([segs[1]])  # queued while the landing runs
        await asyncio.sleep(0.1)
        assert segs[1].pinned is None and len(cudart.registered) == 1
        cache.end_landing()
        assert await cache.wait_pinned() >= 0
        assert segs[1].pinned is not None and len(cudart.registered) == 2

    try:
        asyncio.run(scenario())
    finally:
        release.set()
        cache.clear()
        for seg in segs:
            seg.unpin()
            seg.unlink()


def test_landing_is_not_starved_by_queued_registrations(monkeypatch):
    # With many attachments queued, a landing waits for the registration in
    # progress only: the thread starts no other until the landing ends.
    cudart = Cudart()
    register = cudart.cudaHostRegister

    def slow_register(ptr, size, flags):
        time.sleep(0.05)
        return register(ptr, size, flags)

    cudart.cudaHostRegister = slow_register
    monkeypatch.setattr(torch.cuda, "cudart", lambda: cudart)
    cache = shm.ShmClientCache()
    segs = [shm.ShmSegment.create(4096) for _ in range(10)]

    async def scenario():
        cache.schedule_pin(segs)
        while not cudart.registered:
            await asyncio.sleep(0.001)
        await cache.begin_landing()
        held = len(cudart.registered)
        await asyncio.sleep(0.15)  # the landing's copies
        assert len(cudart.registered) == held <= 3
        cache.end_landing()
        await cache.wait_pinned()
        assert len(cudart.registered) == 10
        assert cache.pin_wait_seconds < 0.1

    try:
        asyncio.run(scenario())
    finally:
        cache.clear()
        for seg in segs:
            seg.unpin()
            seg.unlink()


# --------------------------------------------------------------------------
# the port's store session
# --------------------------------------------------------------------------


async def _put_between_serve_and_attach(store: str, out: dict) -> None:
    """A put of the same key lands after the volume served a get and before
    the client attached the segment: the lease keeps the served segment
    linked, so the get returns the value it was served."""
    old = torch.full((64, 64), 1.0)
    new = torch.full((64, 64), 2.0)
    real = shm.SharedMemoryTransportBuffer._handle_storage_volume_response
    fired = []

    async def racing(self, volume, remote, requests):
        if not fired:
            fired.append(True)
            await tst.put("race", new, store_name=store)
        return await real(self, volume, remote, requests)

    results = {}
    for mode in ("view", "into"):
        await tst.put("race", old, store_name=store)
        fired.clear()
        shm.SharedMemoryTransportBuffer._handle_storage_volume_response = racing
        try:
            if mode == "view":
                got = await tst.get("race", store_name=store)
            else:
                got = await tst.get("race", torch.zeros(64, 64), store_name=store)
        finally:
            shm.SharedMemoryTransportBuffer._handle_storage_volume_response = real
        results[mode] = (bool(fired), torch.equal(got, old))
        del got
    results["after"] = torch.equal(await tst.get("race", store_name=store), new)
    out["race"] = results


async def _location_cache(store: str, out: dict) -> None:
    client = tst.client(store)
    await tst.put("loc", torch.arange(6.0), store_name=store)
    first = (await client.controller.stats.call_one())["locates"]
    for _ in range(3):
        await tst.get("loc", store_name=store)
    warm = (await client.controller.stats.call_one())["locates"]
    # Another client re-puts the key under a new shape; this one's cached
    # location is stale and its get relocates once.
    other = LocalClient(client.controller, client.config)
    await other.put("loc", torch.arange(10.0))
    target = torch.zeros(10)
    await tst.get("loc", target, store_name=store)
    other.close()
    out["locates"] = (first, warm)
    out["stale_relocated"] = torch.equal(target, torch.arange(10.0))


async def port_session() -> dict:
    store = f"pool_{uuid.uuid4().hex[:8]}"
    out: dict = {}
    await tst.initialize(store_name=store)
    pids = {p.pid for p in multiprocessing.active_children()} | {os.getpid()}
    client = tst.client(store)
    try:
        # test_overwrite_reuses_segment
        await tst.put("w", torch.zeros(64, 64), store_name=store)
        before = pool_counts(await settle(client), client)
        y = torch.rand(64, 64, generator=torch.Generator().manual_seed(0))
        await tst.put("w", y, store_name=store)  # draws the warm spare
        equal = torch.equal(await tst.get("w", store_name=store), y)
        gc.collect()
        await settle(client)
        await tst.put("w", y + 1, store_name=store)  # draws the first put's segment
        out["overwrite"] = (
            equal and torch.equal(await tst.get("w", store_name=store), y + 1),
            delta(pool_counts(await volume_stats(client), client), before),
        )

        # test_snapshot_isolation_across_puts
        a, b = torch.full((1024,), 1.0), torch.full((1024,), 2.0)
        await tst.put("k", a, store_name=store)
        snap_a = await tst.get("k", store_name=store)
        kept = (await tst.get("k", store_name=store))[100:200]  # its base is dropped
        gc.collect()
        await tst.put("k", b, store_name=store)
        snap_b = await tst.get("k", store_name=store)
        await tst.put("k", a, store_name=store)
        await tst.put("k", b, store_name=store)
        leased = await volume_stats(client)
        out["snapshots"] = (torch.equal(snap_a, a), torch.equal(kept, a[100:200]),
                            torch.equal(snap_b, b), leased["shm"]["retired_segments"])
        del snap_a, snap_b, kept
        gc.collect()
        await tst.put("k", a, store_name=store)  # carries the releases
        out["released_leases"] = (await volume_stats(client))["shm"]["retired_segments"]

        # test_segment_recycling_after_release
        x = torch.rand(1 << 16, dtype=torch.float64)
        counts = []
        for it in range(8):
            x[0] = float(it)
            await tst.put("r", x, store_name=store)
            got = await tst.get("r", store_name=store)
            assert got[0] == float(it)
            del got
            gc.collect()
            counts.append(len(own_segments(pids)))
        out["recycling"] = counts

        # test_client_cache_follows_renames
        cache = client._ctx.peek(shm.ShmClientCache)
        before = set(cache.segments)
        for _ in range(4):  # over the inline size: cold segments, then pooled
            await tst.put("k2", torch.rand(16384, dtype=torch.float64), store_name=store)
            await tst.put("j2", torch.rand(12288, dtype=torch.float64), store_name=store)
        out["renames"] = (
            [n for n in cache.segments if not os.path.exists(shm.ShmSegment.path(n))],
            len(set(cache.segments) - before),
            cache.counts["cold_create"],
        )

        # test_slice_get_staged_segment_cleaned, and a staged get of an
        # entry no segment backs (put over the RPC rung)
        full = torch.arange(64.0).reshape(8, 8)
        await tst.put("sl", full, store_name=store)
        want = TensorSlice((2, 0), (3, 8), (8, 8), (), ())
        first = await tst.get("sl", want, store_name=store)
        volume = client._volume_refs["0"]
        await RPCTransportBuffer().put_to_storage_volume(volume, [Request.from_tensor("rpc", full)])
        await client.controller.notify_put_batch.call_one(
            [Request.from_tensor("rpc", full).meta_only()], "0"
        )
        await asyncio.sleep(0.2)
        census = len(own_segments(pids))
        oks = []
        for _ in range(4):
            oks.append(torch.equal(await tst.get("sl", want, store_name=store), full[2:5]))
            oks.append(torch.equal(await tst.get("rpc", store_name=store), full))
            oks.append(torch.equal(await tst.get("rpc", torch.zeros(8, 8), store_name=store),
                                   full))
        await asyncio.sleep(0.2)
        out["slices"] = (torch.equal(first, full[2:5]), all(oks), census,
                         len(own_segments(pids)))

        # test_delete_unlinks_segments
        await tst.put("d", torch.ones(32, 32), store_name=store)
        await tst.get("d", torch.zeros(32, 32), store_name=store)
        names = set(cache.key_to_segments["d"])
        await tst.delete("d", store_name=store)
        try:
            await tst.get("d", store_name=store)
            raised = False
        except KeyError:
            raised = True
        out["delete"] = (raised, [n for n in names if os.path.exists(shm.ShmSegment.path(n))])

        # test_sharded_put_zero_copy_reassembly
        sharded = torch.arange(16 * 4, dtype=torch.float32).reshape(16, 4)
        for i in range(4):
            sl = TensorSlice((4 * i, 0), (4, 4), (16, 4), (i,), (4,))
            await tst.put("sh", tst.Shard(sharded[4 * i : 4 * i + 4], sl), store_name=store)
        out["sharded"] = torch.equal(await tst.get("sh", store_name=store), sharded)

        await _put_between_serve_and_attach(store, out)
        await _location_cache(store, out)
        await _waits(store, out)

        # test_controller_stats / test_volume_stats_fanout / write generations
        await tst.put("s1", torch.ones(4, 4), store_name=store)
        await client.controller.locate_volumes.call_one(["s1"])
        out["stats"] = await client.controller.stats.call_one()
        out["stats_volumes"] = await client.controller.stats.call_one(include_volumes=True)
        g1 = await volume.actor.write_gens.call_one(["s1", "absent"])
        await tst.put("s1", torch.ones(4, 4), store_name=store)
        g2 = await volume.actor.write_gens.call_one(["s1"])
        out["write_gens"] = (g1, g2)

        # test_delete_prefix
        for v in ("v0", "v1"):
            for k in ("a", "b"):
                await tst.put(f"ckpt/{v}/{k}", torch.ones(2), store_name=store)
        out["delete_prefix"] = (
            await tst.delete_prefix("ckpt/v0", store_name=store),
            await tst.keys("ckpt", store_name=store),
            await tst.delete_prefix("ckpt/v0", store_name=store),
        )

        out["loop"] = await port_loop(store)
    finally:
        await tst.shutdown(store)
    await asyncio.sleep(0.5)
    out["left"] = sorted(own_segments(pids))
    out["alive"] = [p.pid for p in multiprocessing.active_children() if p.pid in pids]
    return out


async def _waits(store: str, out: dict) -> None:
    client = tst.client(store)

    async def later(coro, delay):
        await asyncio.sleep(delay)
        await coro

    res = {}
    task = asyncio.create_task(later(tst.put("late", torch.ones(4), store_name=store), 0.15))
    await tst.wait_for("late", timeout=10.0, store_name=store)
    res["lands"] = await tst.exists("late", store_name=store)
    await task
    await asyncio.wait_for(tst.wait_for("late", timeout=5.0, store_name=store), timeout=2.0)
    try:
        await tst.wait_for("never-written", timeout=0.2, store_name=store)
        res["timeout"] = None
    except TimeoutError as exc:
        res["timeout"] = str(exc)
    sl0 = TensorSlice((0,), (2,), (4,), (0,), (2,))
    sl1 = TensorSlice((2,), (2,), (4,), (1,), (2,))
    await tst.put("part", tst.Shard(torch.ones(2), sl0), store_name=store)
    res["contains_partial"] = await client.controller.contains.call_one("part")
    res["exists_partial"] = await tst.exists("part", store_name=store)
    try:
        await tst.wait_for("part", timeout=0.3, store_name=store)
        res["partial_blocks"] = False
    except TimeoutError:
        res["partial_blocks"] = True
    task = asyncio.create_task(
        later(tst.put("part", tst.Shard(torch.ones(2), sl1), store_name=store), 0.1)
    )
    await tst.wait_for("part", timeout=10.0, store_name=store)
    await task
    res["contains_committed"] = await client.controller.contains.call_one("part")
    res["contains_missing"] = await client.controller.contains.call_one("nope")

    async def puts():
        await asyncio.sleep(0.05)
        await tst.put("m1", torch.ones(1), store_name=store)
        await asyncio.sleep(0.05)
        await tst.put("m2", torch.ones(1), store_name=store)

    task = asyncio.create_task(puts())
    await tst.wait_for(["m1", "m2"], timeout=10.0, store_name=store)
    await task
    # wait_for_change: 0 answers at once for a key ever written; then the
    # next put or delete wakes it.
    now = await client.wait_for_change("late", 0, timeout=5.0)
    task = asyncio.create_task(later(tst.put("late", torch.zeros(4), store_name=store), 0.1))
    changed = await client.wait_for_change("late", now["gen"], timeout=10.0)
    await task
    task = asyncio.create_task(later(tst.delete("late", store_name=store), 0.1))
    deleted = await client.wait_for_change("late", changed["gen"], timeout=10.0)
    await task
    try:
        await client.wait_for_change("late", deleted["gen"], timeout=0.2)
        res["change_timeout"] = False
    except TimeoutError:
        res["change_timeout"] = True
    res["changes"] = (now, changed, deleted)
    out["waits"] = res


async def port_loop(store: str) -> dict:
    """The multi-round loop on the port (shared-memory rung), with the
    pool's offers of each round's put."""
    client = tst.client(store)
    src = tst.from_numpy_tree(loop_tree(), "cpu")
    targets = {k: torch.zeros(v.shape, dtype=torch.bfloat16) for k, v in src.items()}
    results, offers = [], []
    for step in range(ROUNDS):
        before = pool_counts(await settle(client), client)
        await tst.put_state_dict("loop", src, transfer_dtype=torch.bfloat16, store_name=store)
        offers.append(delta(pool_counts(await volume_stats(client), client), before))
        await tst.get_state_dict("loop", targets, store_name=store)
        results.append({k: bits(v) for k, v in targets.items()})
        for v in src.values():
            v.add_(1.0)  # the training step, in place
    return {"results": results, "offers": offers}


async def reference_loop() -> list:
    store = f"ref_{uuid.uuid4().hex[:8]}"
    tree = loop_tree()
    bf16 = ml_dtypes.bfloat16
    targets = {k: np.zeros(v.shape, bf16) for k, v in tree.items()}
    results = []
    with reference_without_shm() as config:
        await ts_ref.initialize(store_name=store, config=config)
        try:
            for _ in range(ROUNDS):
                await ts_ref.put_state_dict("loop", tree, transfer_dtype=bf16, store_name=store)
                await ts_ref.get_state_dict("loop", targets, store_name=store)
                results.append({k: bits(v) for k, v in targets.items()})
                for v in tree.values():
                    v += 1.0
        finally:
            await ts_ref.shutdown(store)
    return results


@contextlib.contextmanager
def reference_without_shm():
    # The reference over its RPC rung, without its stamped metadata and
    # one-sided planes: it then adds no ts_shm_* segments to the
    # machine-wide counts of its own tests. The process's default config is
    # read from the environment once, so it is not first read here.
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_config, "_default_config", None)
        mp.setattr(ref_shm, "is_available", lambda: False)
        mp.setenv("TORCHSTORE_TPU_META_STAMPED", "0")
        mp.setenv("TORCHSTORE_TPU_ONE_SIDED", "0")
        yield RefStoreConfig(shm_enabled=False, bulk_tcp_enabled=False)


@pytest.fixture(scope="module")
def port():
    return run(port_session)


@pytest.fixture(scope="module")
def reference():
    return run(reference_loop)


def test_overwrite_reuses_segment(port):
    equal, counts = port["overwrite"]
    assert equal
    # A 16 KB put rides inline: the volume lands it in a pooled segment, the
    # second overwrite in the segment the first put's value left.
    assert counts["recycled"] == 1 and counts["created"] == 0
    assert counts["miss"] == 0 and counts["cold_create"] == 0


def test_snapshot_isolation_across_puts(port):
    held, sliced, second, retired = port["snapshots"]
    assert held and sliced and second
    assert retired >= 2  # the two leased segments were retired, not reused
    assert port["released_leases"] == 0  # released once the views died


def test_segment_recycling_after_release(port):
    counts = port["recycling"]
    assert counts[-1] <= counts[2], f"segment growth: {counts}"


def test_client_cache_follows_renames(port):
    stale, new, cold = port["renames"]
    assert cold > 0  # the first puts created segments the volume renamed
    assert stale == []
    assert new <= 8  # bounded: repeated puts of two keys rotate their segments


def test_slice_get_staged_segment_cleaned(port):
    first, all_equal, before, after = port["slices"]
    assert first and all_equal
    assert after <= before, f"staged segments leaked: {before} -> {after}"


def test_delete_unlinks_segments(port):
    raised, left = port["delete"]
    assert raised and left == []


def test_sharded_put_zero_copy_reassembly(port):
    assert port["sharded"]


def test_put_between_serve_and_attach_does_not_raise(port):
    race = port["race"]
    assert race["view"] == (True, True)
    assert race["into"] == (True, True)
    assert race["after"]
    with open(inspect.getsourcefile(LocalClient)) as f:
        assert "FileNotFoundError" not in f.read()  # no retry hides the race


def test_location_cache_and_stale_relocate(port):
    first, warm = port["locates"]
    assert warm == first + 1  # one locate, then served from the cache
    assert port["stale_relocated"]


def test_wait_for_and_contains(port):
    res = port["waits"]
    assert res["lands"]
    assert "never-written" in res["timeout"]
    assert res["contains_partial"] == "partial" and res["exists_partial"]
    assert res["partial_blocks"]
    assert res["contains_committed"] == "committed"
    assert res["contains_missing"] == "missing"


def test_wait_for_change(port):
    now, changed, deleted = port["waits"]["changes"]
    assert now["gen"] > 0 and now["state"] == "committed"
    assert changed["gen"] > now["gen"] and changed["state"] == "committed"
    assert deleted["gen"] > changed["gen"] and deleted["state"] == "missing"
    assert port["waits"]["change_timeout"]


def test_controller_and_volume_stats(port):
    stats = port["stats"]
    assert stats["puts"] >= 1 and stats["put_bytes"] >= 64
    assert stats["locates"] >= 1 and stats["num_keys"] >= 1
    assert stats["num_volumes"] == 1
    assert "volumes" not in stats
    (vstats,) = port["stats_volumes"]["volumes"].values()
    assert vstats["entries"] >= 1 and vstats["stored_bytes"] >= 256
    pool = vstats["shm"]
    assert pool["live_segments"] >= 1 and pool["pool_bytes"] >= 0
    assert pool["pool_bytes"] <= pool["pool_cap"]
    assert pool["offers"]["pooled"] + pool["offers"]["spare"] > 0
    assert pool["segments_recycled"] > 0


def test_write_generations_rise(port):
    g1, g2 = port["write_gens"]
    assert set(g1) == {"s1"} and g2["s1"] > g1["s1"]


def test_delete_prefix(port):
    removed, keys, again = port["delete_prefix"]
    assert removed == 2 and keys == ["ckpt/v1/a", "ckpt/v1/b"] and again == 0


def test_shutdown_leaves_no_segment_or_process(port):
    assert port["left"] == [] and port["alive"] == []


@pytest.mark.parametrize("step", range(ROUNDS))
def test_multi_round_loop_matches_reference(port, reference, step):
    got, want = port["loop"]["results"][step], reference[step]
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_multi_round_loop_rotates_warm_segments(port):
    offers = port["loop"]["offers"]
    for later in offers[1:]:
        assert later["miss"] == 0 and later["cold_create"] == 0, offers
        assert later["spare"] + later["pooled"] > 0


# --------------------------------------------------------------------------
# HostStrategy, two emulated hosts, replication 2
# --------------------------------------------------------------------------


async def host_session() -> dict:
    name = f"hosts_{uuid.uuid4().hex[:6]}"
    strategy = tst.HostStrategy(replication=2)
    mesh = await spawn_actors(
        2, StorageVolume, f"{name}_vol", strategy,
        env_fn=lambda r: {"TORCHSTORE_TORCH_HOSTNAME": f"host{r}"},
    )
    controller = await get_or_spawn_singleton(f"{name}_ctrl", Controller)
    out: dict = {}
    old = os.environ.get("TORCHSTORE_TORCH_HOSTNAME")
    try:
        info = await controller.init.call_one(strategy, mesh.refs)
        out["ids"] = sorted(info["volume_ids"])
        os.environ["TORCHSTORE_TORCH_HOSTNAME"] = "host1"
        client = LocalClient(controller)
        await client.put("k", torch.arange(4.0))
        out["get"] = torch.equal(await client.get("k"), torch.arange(4.0))
        located = await controller.locate_volumes.call_one(["k"])
        out["located"] = sorted(located["k"])
        out["gens"] = {vid: i.write_gen for vid, i in located["k"].items()}
        big = torch.rand(256, 256)  # over the inline size: a handshake put on host1
        await client.put("big", big)
        out["big"] = torch.equal(await client.get("big"), big)
        stats = await controller.stats.call_one(include_volumes=True)
        out["entries"] = {vid: v["entries"] for vid, v in stats["volumes"].items()}
        out["shm_on"] = {vid: "shm" in v for vid, v in stats["volumes"].items()}
        # A read-only client (a generator) caches both replicas of "k". A
        # trainer's put whose landing on host0 fails detaches host0, which
        # keeps the old bytes: the reader must not serve them.
        reader = LocalClient(controller)
        first = torch.equal(await reader.get("k"), torch.arange(4.0))
        trainer = LocalClient(controller)
        land = trainer._land

        async def host0_fails(volume, requests):
            if volume.volume_id == "host0":
                raise ConnectionError("injected landing failure")
            return await land(volume, requests)

        trainer._land = host0_fails
        await trainer.put("k", torch.arange(4.0) + 1)
        located = await controller.locate_volumes.call_one(["k"])
        out["reader_after_detach"] = (
            first, sorted(located["k"]), torch.equal(await reader.get("k"), torch.arange(4.0) + 1)
        )
        # Both replicas again, cached by the reader; then host0's volume
        # dies: the reader's get relocates to host1, and a put still lands
        # on host1 while the notify detaches host0's copy.
        await client.put("k", torch.arange(4.0) + 2)
        again = torch.equal(await reader.get("k"), torch.arange(4.0) + 2)
        host0 = mesh._processes[0]
        host0.kill()
        host0.join(10)
        out["reader_after_death"] = (
            again, torch.equal(await reader.get("k"), torch.arange(4.0) + 2)
        )
        await client.put("k", torch.arange(4.0) + 3)
        located = await controller.locate_volumes.call_one(["k"])
        out["degraded"] = (sorted(located["k"]),
                           torch.equal(await client.get("k"), torch.arange(4.0) + 3))
        for c in (client, reader, trainer):
            c.close()
    finally:
        if old is None:
            os.environ.pop("TORCHSTORE_TORCH_HOSTNAME", None)
        else:
            os.environ["TORCHSTORE_TORCH_HOSTNAME"] = old
        await stop_singleton(f"{name}_ctrl")
        await mesh.stop()
    return out


def test_host_strategy_two_emulated_hosts_replicated():
    out = run(host_session)
    assert out["ids"] == ["host0", "host1"]
    assert out["get"] and out["big"]
    assert out["located"] == ["host0", "host1"]  # both replicas indexed
    assert all(gen > 0 for gen in out["gens"].values())
    assert out["entries"] == {"host0": 2, "host1": 2}
    # The client's own host is served over shared memory, the other over RPC.
    assert out["shm_on"] == {"host0": False, "host1": True}
    assert out["reader_after_detach"] == (True, ["host1"], True)
    assert out["reader_after_death"] == (True, True)
    assert out["degraded"] == (["host1"], True)
