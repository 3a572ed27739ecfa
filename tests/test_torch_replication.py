"""Port twin of tests/test_replication.py: k-way replicated puts, gets that
fail over past a dead volume, deletes of every replica, and the reclaims
of stale copies a detached replica keeps.

Every store case runs the same scenario through both packages from one
numpy seed (the JAX store off shared memory, its stamped and one-sided
planes off, as tests/test_torch_store.py runs it) and compares what each
reads back, where each placed the keys and which volume died. The reclaim
cases drive both packages' controllers against one fake volume and
compare the calls and outcomes. Every case that kills or stops a process
runs under its own timeout, and a stopped process is continued in a
``finally``."""

import asyncio
import contextlib
import os
import signal
import uuid

import anyio
import numpy as np
import pytest
import torch

import torchstore_tpu as ts_ref
import torchstore_tpu_torch as tst
from torchstore_tpu import config as ref_config
from torchstore_tpu.client import Shard as RefShard
from torchstore_tpu.config import RetryPolicy as RefRetryPolicy
from torchstore_tpu.config import StoreConfig as RefStoreConfig
from torchstore_tpu.controller import Controller as RefController
from torchstore_tpu.runtime import ActorDiedError as RefActorDiedError
from torchstore_tpu.strategy import LocalRankStrategy as RefLocalRankStrategy
from torchstore_tpu.transport import shared_memory as ref_shm
from torchstore_tpu.transport.types import Request as RefRequest
from torchstore_tpu.transport.types import TensorMeta as RefTensorMeta
from torchstore_tpu.transport.types import TensorSlice as RefTensorSlice
from torchstore_tpu_torch.controller import Controller
from torchstore_tpu_torch.runtime import ActorDiedError
from torchstore_tpu_torch.transport.types import Request, TensorMeta

TIMEOUT_S = 90
FAST_RECLAIMS = "0.05,0.1,0.2,0.4"


@pytest.fixture(autouse=True)
def reference_off_shared_memory(monkeypatch):
    """The JAX store over its RPC and TCP rungs only: its answers do not
    depend on the rung, and it then adds no ts_shm_* segment to the
    machine-wide counts of the reference's own tests. Its default config is
    not first read under these switches (monkeypatch restores it)."""
    monkeypatch.setattr(ref_config, "_default_config", None)
    monkeypatch.setattr(ref_shm, "is_available", lambda: False)
    monkeypatch.setenv("TORCHSTORE_TPU_META_STAMPED", "0")
    monkeypatch.setenv("TORCHSTORE_TPU_ONE_SIDED", "0")


def ref_config_off_shm(**kw) -> RefStoreConfig:
    return RefStoreConfig(**{"shm_enabled": False, "bulk_tcp_enabled": False, **kw})


@contextlib.asynccontextmanager
async def port_store(num=3, replication=2, **kw):
    name = f"tst_repl_{uuid.uuid4().hex[:8]}"
    await tst.initialize(num_storage_volumes=num, store_name=name,
                         strategy=tst.LocalRankStrategy(replication=replication, **kw.pop(
                             "strategy_kw", {})), **kw)
    try:
        yield name
    finally:
        await tst.shutdown(name)


@contextlib.asynccontextmanager
async def ref_store(num=3, replication=2, strategy_kw=None, config=None):
    name = f"ref_repl_{uuid.uuid4().hex[:8]}"
    await ts_ref.initialize(
        num_storage_volumes=num, store_name=name,
        strategy=RefLocalRankStrategy(replication=replication, **(strategy_kw or {})),
        config=config or ref_config_off_shm())
    try:
        yield name
    finally:
        await ts_ref.shutdown(name)


def _same(a, b) -> bool:
    return (a.host, a.port, a.name) == (b.host, b.port, b.name)


async def kill_port(store: str, volume_id: str) -> int:
    """SIGKILL the process hosting the port volume ``volume_id``; its pid."""
    from torchstore_tpu_torch import api

    vmap = await tst.client(store).controller.get_volume_map.call_one()
    handle = api._stores[store]
    for mesh in [handle.volume_mesh, *handle.repair_meshes]:
        for idx, ref in enumerate(mesh.refs):
            if _same(ref, vmap[volume_id]["ref"]):
                proc = mesh._processes[idx]
                proc.kill()
                proc.join(5)
                return proc.pid
    raise AssertionError(f"no process found for volume {volume_id!r}")


async def kill_ref(store: str, volume_id: str) -> None:
    from tests.test_replication import _kill_volume

    await _kill_volume(store, volume_id)


async def volume_process_port(store: str, volume_id: str):
    from torchstore_tpu_torch import api

    vmap = await tst.client(store).controller.get_volume_map.call_one()
    handle = api._stores[store]
    return next(p for r, p in zip(handle.volume_mesh.refs, handle.volume_mesh._processes)
                if _same(r, vmap[volume_id]["ref"]))


async def volume_process_ref(store: str, volume_id: str):
    from torchstore_tpu import api

    vmap = await ts_ref.client(store).controller.get_volume_map.call_one()
    handle = api._stores[store]
    return next(p for r, p in zip(handle.volume_mesh.refs, handle.volume_mesh._processes)
                if _same(r, vmap[volume_id]["ref"]))


def to_np(t) -> np.ndarray:
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---- placement and failover -----------------------------------------------


async def test_put_indexes_on_two_volumes():
    src = np.random.default_rng(0).standard_normal(8).astype(np.float32)
    with anyio.fail_after(TIMEOUT_S):
        async with port_store() as p, ref_store() as r:
            await tst.put("k", torch.from_numpy(src), store_name=p)
            await ts_ref.put("k", src, store_name=r)
            lp = await tst.client(p).controller.locate_volumes.call_one(["k"])
            lr = await ts_ref.client(r).controller.locate_volumes.call_one(["k"])
            assert sorted(lp["k"]) == sorted(lr["k"]) and len(lp["k"]) == 2
            got_p = to_np(await tst.get("k", store_name=p))
            got_r = to_np(await ts_ref.get("k", store_name=r))
    np.testing.assert_array_equal(got_p, got_r)
    np.testing.assert_array_equal(got_p, src)


@pytest.mark.parametrize("seed", range(4))
def test_ring_selection_matches_reference(seed):
    rng = np.random.default_rng(seed)
    vols = sorted({str(v) for v in rng.integers(0, 20, size=int(rng.integers(3, 8)))})
    for replication in range(1, len(vols) + 2):
        port, ref = tst.LocalRankStrategy(replication=replication), RefLocalRankStrategy(
            replication=replication)
        for client_id in vols:
            try:
                want = ref.select_put_volume_ids(client_id, vols)
            except ValueError as exc:
                with pytest.raises(ValueError, match=f"replication={replication}"):
                    port.select_put_volume_ids(client_id, vols)
                assert f"replication={replication}" in str(exc)
                continue
            assert port.select_put_volume_ids(client_id, vols) == want


def test_ring_selection_is_deterministic():
    s = tst.LocalRankStrategy(replication=2)
    vols = ["0", "1", "2"]
    assert s.select_put_volume_ids("1", vols) == ["1", "2"]
    assert s.select_put_volume_ids("2", vols) == ["2", "0"]  # wraps
    with pytest.raises(ValueError, match="replication=4"):
        tst.LocalRankStrategy(replication=4).select_put_volume_ids("0", vols)


async def test_replication_exceeding_volumes_rejected():
    name = f"tst_bad_{uuid.uuid4().hex[:6]}"
    with anyio.fail_after(TIMEOUT_S):
        with pytest.raises(ValueError, match="replication=3"):
            await tst.initialize(num_storage_volumes=2, store_name=name,
                                 strategy=tst.LocalRankStrategy(replication=3))
        with pytest.raises(ValueError, match="replication=3"):
            await ts_ref.initialize(num_storage_volumes=2, store_name="ref_" + name,
                                    strategy=RefLocalRankStrategy(replication=3),
                                    config=ref_config_off_shm())
    assert name not in tst.api._stores


async def test_get_survives_volume_death():
    src = np.random.default_rng(1).random((64, 64), dtype=np.float32)
    with anyio.fail_after(TIMEOUT_S):
        async with port_store() as p, ref_store() as r:
            await tst.put("w", torch.from_numpy(src), store_name=p)
            await ts_ref.put("w", src, store_name=r)
            client = tst.client(p)
            lp = await client.controller.locate_volumes.call_one(["w"])
            lr = await ts_ref.client(r).controller.locate_volumes.call_one(["w"])
            victim = sorted(lp["w"])[0]
            assert victim == sorted(lr["w"])[0]
            await kill_port(p, victim)
            await kill_ref(r, victim)
            # The first get may pay a diagnosis; it succeeds from the other
            # replica, and the next one goes there first: no new fan-out.
            first = to_np(await tst.get("w", store_name=p))
            fanouts = client.diagnoses
            second = to_np(await tst.get("w", store_name=p))
            assert client.diagnoses == fanouts and victim in client._dead_volumes
            ref_first = to_np(await ts_ref.get("w", store_name=r))
            ref_second = to_np(await ts_ref.get("w", store_name=r))
    for got in (first, second, ref_first, ref_second):
        np.testing.assert_array_equal(got, src)


async def test_unreplicated_key_on_dead_volume_still_fails():
    # The JAX client retries a get while any volume answers, to its retry
    # deadline: a short one keeps the case short.
    retry = {"retry": RefRetryPolicy(deadline_s=2.0)}
    with anyio.fail_after(TIMEOUT_S):
        async with port_store(num=2, replication=1,
                              config=tst.StoreConfig(retry=tst.RetryPolicy(deadline_s=2.0))) as p, \
                ref_store(num=2, replication=1, config=ref_config_off_shm(**retry)) as r:
            await tst.put("only", torch.ones(4, dtype=torch.float64), store_name=p)
            await ts_ref.put("only", np.ones(4), store_name=r)
            (vid,) = (await tst.client(p).controller.locate_volumes.call_one(["only"]))["only"]
            (rvid,) = (await ts_ref.client(r).controller.locate_volumes.call_one(["only"]))["only"]
            assert vid == rvid
            await kill_port(p, vid)
            await kill_ref(r, vid)
            with pytest.raises(ActorDiedError) as port_err:
                await tst.get("only", store_name=p)
            with pytest.raises((RefActorDiedError, ConnectionError, OSError)) as ref_err:
                await ts_ref.get("only", store_name=r)
    for err in (port_err, ref_err):
        assert "controller diagnosis" in str(err.value) and "dead" in str(err.value)


def _rows(full: np.ndarray):
    for row in range(full.shape[0]):
        yield row, dict(offsets=(row, 0), local_shape=(1, full.shape[1]),
                        global_shape=full.shape, coordinates=(row,), mesh_shape=(full.shape[0],))


async def test_sharded_replicated_roundtrip():
    full = np.arange(32.0, dtype=np.float32).reshape(4, 8)
    with anyio.fail_after(TIMEOUT_S):
        async with port_store() as p, ref_store() as r:
            for row, sl in _rows(full):
                await tst.put("sh", tst.Shard(torch.from_numpy(full[row:row + 1].copy()),
                                              tst.TensorSlice(**sl)), store_name=p)
                await ts_ref.put("sh", RefShard(full[row:row + 1], RefTensorSlice(**sl)),
                                 store_name=r)
            got_p = to_np(await tst.get("sh", store_name=p))
            got_r = to_np(await ts_ref.get("sh", store_name=r))
            lp = await tst.client(p).controller.locate_volumes.call_one(["sh"])
            lr = await ts_ref.client(r).controller.locate_volumes.call_one(["sh"])
    np.testing.assert_array_equal(got_p, full)
    np.testing.assert_array_equal(got_p, got_r)
    assert {v: sorted(i.tensor_slices) for v, i in lp["sh"].items()} == {
        v: sorted(i.tensor_slices) for v, i in lr["sh"].items()}


async def test_state_dict_replicated_with_failover():
    rng = np.random.default_rng(2)
    sd = {"a": rng.random(32, dtype=np.float32), "b": np.arange(4)}
    with anyio.fail_after(TIMEOUT_S):
        async with port_store() as p, ref_store() as r:
            await tst.put_state_dict("ck", {k: torch.from_numpy(v) for k, v in sd.items()},
                                     store_name=p)
            await ts_ref.put_state_dict("ck", sd, store_name=r)
            await kill_port(p, "0")  # the client's own id: the primary
            await kill_ref(r, "0")
            out_p = await tst.get_state_dict("ck", store_name=p)
            out_r = await ts_ref.get_state_dict("ck", store_name=r)
    for key in sd:
        np.testing.assert_array_equal(to_np(out_p[key]), sd[key])
        np.testing.assert_array_equal(to_np(out_p[key]), to_np(out_r[key]))


async def test_bulk_transport_failover():
    """A dead volume on the bulk rung surfaces as a broken socket: the get
    still fails over to the other replica."""
    src = np.random.default_rng(3).random(1024, dtype=np.float32)
    with anyio.fail_after(TIMEOUT_S):
        async with port_store(strategy_kw={"default_transport_type": "bulk"}) as p, \
                ref_store(strategy_kw={"default_transport_type": "bulk"},
                          config=RefStoreConfig(shm_enabled=False)) as r:
            await tst.put("w", torch.from_numpy(src), store_name=p)
            await ts_ref.put("w", src, store_name=r)
            lp = await tst.client(p).controller.locate_volumes.call_one(["w"])
            await kill_port(p, sorted(lp["w"])[0])
            await kill_ref(r, sorted(lp["w"])[0])
            got_p = to_np(await tst.get("w", store_name=p))
            got_r = to_np(await ts_ref.get("w", store_name=r))
    np.testing.assert_array_equal(got_p, src)
    np.testing.assert_array_equal(got_r, src)


async def test_degraded_overwrite_stays_consistent():
    v1, v2 = np.full(16, 1.0, np.float32), np.full(16, 2.0, np.float32)
    with anyio.fail_after(TIMEOUT_S):
        async with port_store() as p, ref_store() as r:
            reads = {}
            for name, mod, kill, wrap in ((p, tst, kill_port, torch.from_numpy),
                                          (r, ts_ref, kill_ref, lambda a: a)):
                await mod.put("k", wrap(v1), store_name=name)
                ctl = mod.client(name).controller
                replicas = sorted((await ctl.locate_volumes.call_one(["k"]))["k"])
                await kill(name, replicas[1])
                await mod.put("k", wrap(v2), store_name=name)
                located = await ctl.locate_volumes.call_one(["k"])
                assert replicas[1] not in located["k"]
                reads[mod] = [to_np(await mod.get("k", store_name=name)) for _ in range(4)]
    for got in reads[tst] + reads[ts_ref]:
        np.testing.assert_array_equal(got, v2)


async def test_delete_cleans_every_replica():
    with anyio.fail_after(TIMEOUT_S):
        async with port_store() as p, ref_store() as r:
            await tst.put("gone", torch.ones(4), store_name=p)
            await ts_ref.put("gone", np.ones(4), store_name=r)
            await tst.delete("gone", store_name=p)
            await ts_ref.delete("gone", store_name=r)
            assert not await tst.exists("gone", store_name=p)
            assert not await ts_ref.exists("gone", store_name=r)
            lp = await tst.client(p).controller.locate_volumes.call_one(["gone"], missing_ok=True)
            lr = await ts_ref.client(r).controller.locate_volumes.call_one(["gone"],
                                                                          missing_ok=True)
    assert lp == lr == {}


# ---- reclaims of stale copies: both controllers against one fake volume ----


class _Ep:
    def __init__(self, fn):
        self.call_one = fn


class FakeVolume:
    """A volume ref with only what the reclaim drainer calls, over a write
    generation table like the volumes'."""

    def __init__(self, gens=None, kv=None, on_delete=None):
        self.gens = dict(gens or {})
        self.kv = dict(kv or {})
        self.calls = []
        self.on_delete = on_delete

    def __getattr__(self, name):
        return _Ep(getattr(self, f"_{name}"))

    async def _write_gens(self, keys):
        self.calls.append(("write_gens", list(keys)))
        return {k: self.gens[k] for k in keys if k in self.gens}

    async def _delete_batch_if(self, items):
        self.calls.append(("delete_if", list(items)))
        if self.on_delete is not None:
            await self.on_delete()
        removed, kept, kept_gens = [], [], {}
        for key, stale_gen in items:
            cur = self.gens.get(key)
            if cur is not None and cur > stale_gen:
                kept.append(key)
                kept_gens[key] = cur
                continue
            if self.kv.pop(key, None) is not None:
                removed.append(key)
            self.gens.pop(key, None)
        return {"removed": removed, "kept_fresh": kept, "kept_gens": kept_gens}


def port_meta(key="k"):
    req = Request.from_tensor(key, torch.ones(4))
    req.tensor_meta = TensorMeta(shape=(4,), dtype="float32")
    return req.meta_only()


def ref_meta(key="k"):
    req = RefRequest.from_tensor(key, np.ones(4, np.float32))
    req.tensor_meta = RefTensorMeta(shape=(4,), dtype="float32")
    return req.meta_only()


BOTH = [pytest.param((Controller, port_meta), id="port"),
        pytest.param((RefController, ref_meta), id="reference")]


@pytest.fixture
def fast_reclaims(monkeypatch):
    monkeypatch.setenv("TORCHSTORE_TORCH_RECLAIM_DELAYS", FAST_RECLAIMS)
    monkeypatch.setenv("TORCHSTORE_TPU_RECLAIM_DELAYS", FAST_RECLAIMS)


async def _drain(c) -> None:
    while c._reclaim_tasks:
        for task in list(c._reclaim_tasks):
            await task


@pytest.mark.parametrize("pkg", BOTH)
async def test_reclaim_never_deletes_a_put_that_raced_it(pkg):
    """A put landing on the detached volume before the reclaim's delete
    keeps its bytes: the delete is conditional on the stale generation."""
    controller_cls, meta = pkg
    c = controller_cls()
    vol = FakeVolume(gens={"k": 100}, kv={"k": "v1-bytes"})
    c.volume_refs = {"v0": vol}
    await c.notify_put_batch([meta()], "v0", write_gens={"v0": {"k": 100}})
    await c.notify_put_batch([meta()], "v1", detach_volume_ids=["v0"],
                             write_gens={"v1": {"k": 200}})
    assert c._pending_reclaims["v0"] == {"k": 100}
    # The race: a new put lands on v0 before the drainer runs, unindexed.
    vol.kv["k"], vol.gens["k"] = "v3-bytes", 300
    for task in list(c._reclaim_tasks):
        task.cancel()
    c._reclaim_running.discard("v0")
    result = await vol._delete_batch_if(sorted(c._pending_reclaims["v0"].items()))
    assert result == {"removed": [], "kept_fresh": ["k"], "kept_gens": {"k": 300}}
    assert vol.kv["k"] == "v3-bytes"
    vol.kv["stale"], vol.gens["stale"] = "old-bytes", 50
    result = await vol._delete_batch_if([("stale", 50)])
    assert result["removed"] == ["stale"] and "stale" not in vol.kv


async def _conditional_delete_calls(controller_cls, meta) -> list:
    c = controller_cls()
    vol = FakeVolume(gens={"k": 9}, kv={"k": "x"})
    c.volume_refs = {"v0": vol}
    await c.notify_put_batch([meta()], "v0", write_gens={"v0": {"k": 7}})
    await c.notify_put_batch([meta()], "v1", detach_volume_ids=["v0"],
                             write_gens={"v1": {"k": 8}})
    # The racing put's notify re-indexes v0 before the drainer fires.
    await c.notify_put_batch([meta()], "v0", write_gens={"v0": {"k": 9}})
    await _drain(c)
    skipped = list(vol.calls)
    await c.notify_put_batch([meta()], "v1", detach_volume_ids=["v0"],
                             write_gens={"v1": {"k": 10}})
    await _drain(c)
    return [skipped, vol.calls, c._pending_reclaims]


async def test_reclaim_drainer_uses_conditional_delete(fast_reclaims):
    port = await _conditional_delete_calls(Controller, port_meta)
    ref = await _conditional_delete_calls(RefController, ref_meta)
    assert port == ref
    assert port == [[], [("delete_if", [("k", 9)])], {}]


async def _requeue_calls(controller_cls, meta) -> tuple:
    c = controller_cls()
    vol = FakeVolume(gens={"k": 300}, kv={"k": "orphan"})
    c.volume_refs = {"v0": vol}
    await c.notify_put_batch([meta()], "v0", write_gens={"v0": {"k": 100}})
    await c.notify_put_batch([meta()], "v1", detach_volume_ids=["v0"],
                             write_gens={"v1": {"k": 200}})
    await _drain(c)
    return vol.calls, vol.kv, c._pending_reclaims


async def test_reclaim_requeues_kept_fresh_until_indexed_or_orphaned(fast_reclaims):
    """kept_fresh is not final: the volume's generation is requeued, so
    bytes whose notify never comes are reclaimed on a later round."""
    port = await _requeue_calls(Controller, port_meta)
    assert port == await _requeue_calls(RefController, ref_meta)
    calls, kv, pending = port
    assert calls == [("delete_if", [("k", 100)]), ("delete_if", [("k", 300)])]
    assert kv == {} and pending == {}


async def _two_phase_calls(controller_cls, meta) -> tuple:
    c = controller_cls()
    vol = FakeVolume(gens={"k": 77}, kv={"k": "partial-bytes"})
    c.volume_refs = {"v0": vol}
    await c.notify_put_batch([meta()], "v1", detach_volume_ids=["v0"],
                             write_gens={"v1": {"k": 200}})
    scheduled = dict(c._pending_reclaims["v0"])
    await _drain(c)
    return scheduled, vol.calls, vol.kv, c._pending_reclaims


async def test_reclaim_collects_partial_landings_two_phase(fast_reclaims):
    """A detached volume never indexed for the key may hold a partial
    landing: scheduled at -1, it reads the volume's generation, then
    deletes exactly those bytes."""
    port = await _two_phase_calls(Controller, port_meta)
    assert port == await _two_phase_calls(RefController, ref_meta)
    assert port == ({"k": -1}, [("write_gens", ["k"]), ("delete_if", [("k", 77)])], {}, {})


async def _clobbered(controller_cls, meta) -> set:
    c = controller_cls()

    async def racing_notify():
        await c.notify_put_batch([meta()], "v0", write_gens={"v0": {"k": 500}})

    c.volume_refs = {"v0": FakeVolume(gens={"k": 7}, kv={"k": "x"}, on_delete=racing_notify)}
    await c.notify_put_batch([meta()], "v0", write_gens={"v0": {"k": 7}})
    await c.notify_put_batch([meta()], "v1", detach_volume_ids=["v0"],
                             write_gens={"v1": {"k": 8}})
    await _drain(c)
    located = await c.locate_volumes(["k"])
    assert c._pending_reclaims == {}
    return set(located["k"])


async def test_reclaim_reconciles_clobbered_index_entries(fast_reclaims):
    """A reclaim that deleted a key the index meanwhile claims for the
    volume detaches that entry instead of pointing readers at nothing."""
    port = await _clobbered(Controller, port_meta)
    assert port == await _clobbered(RefController, ref_meta) == {"v1"}


async def _detached_stale_copy(mod, name, wrap, stop) -> list:
    """The degraded overwrite with volume 1 stopped, then pinned reads of
    the stale location until they serve v2; returns every value read."""
    v1, v2 = np.full(8, 1.0, np.float32), np.full(8, 2.0, np.float32)
    await mod.put("k", wrap(v1), store_name=name)
    client = mod.client(name)
    cli2 = type(client)(client.controller, client._config)
    np.testing.assert_array_equal(to_np(await cli2.get("k")), v1)
    assert len(cli2._loc_cache["k"]) == 2
    proc = await stop(name, "1")
    os.kill(proc.pid, signal.SIGSTOP)
    try:
        await mod.put("k", wrap(v2), store_name=name)
        located = await client.controller.locate_volumes.call_one(["k"])
        assert set(located["k"]) == {"0"}
    finally:
        os.kill(proc.pid, signal.SIGCONT)
    stale_pin = cli2._loc_cache.get("k", {}).get("1")
    seen = []
    for _ in range(60):
        if stale_pin is not None:
            cli2._loc_cache["k"] = {"1": stale_pin}
        got = to_np(await cli2.get("k"))
        seen.append(got.tolist())
        if (got == v2).all():
            break
        np.testing.assert_array_equal(got, v1)  # the only other legal value
        await asyncio.sleep(0.25)
    for _ in range(120):
        if not (await client.controller.stats.call_one()).get("pending_reclaims"):
            break
        await asyncio.sleep(0.25)
    else:
        raise AssertionError("reclaim never drained")
    return seen


async def test_detached_stale_copy_reclaimed_and_not_served(monkeypatch):
    """After a degraded overwrite, the stopped-then-continued replica holds
    the old bytes; a reader pinned to it converges on the new value, and
    the reclaim drains (kept fresh or deleted)."""
    monkeypatch.setenv("TORCHSTORE_TORCH_RECLAIM_DELAYS", FAST_RECLAIMS)
    monkeypatch.setenv("TORCHSTORE_TPU_RECLAIM_DELAYS", FAST_RECLAIMS)
    v2 = [2.0] * 8
    with anyio.fail_after(120):
        async with port_store(num=2, config=tst.StoreConfig(
                rpc_timeout=2.0, handshake_timeout=2.0)) as p:
            port = await _detached_stale_copy(tst, p, torch.from_numpy, volume_process_port)
        async with ref_store(num=2, config=ref_config_off_shm(rpc_timeout=2.0)) as r:
            ref = await _detached_stale_copy(ts_ref, r, lambda a: a, volume_process_ref)
    assert port[-1] == ref[-1] == v2


# ---- the port's own differences ---------------------------------------------


def _port_shard(coord: int, mesh: int):
    sl = tst.TensorSlice(offsets=(coord * 4 // mesh, 0), local_shape=(4 // mesh, 4),
                         global_shape=(4, 4), coordinates=(coord,), mesh_shape=(mesh,))
    req = Request.from_tensor_slice("k", sl)
    req.tensor_meta = TensorMeta(shape=sl.local_shape, dtype="float32")
    return req.meta_only()


def _ref_shard(coord: int, mesh: int):
    sl = RefTensorSlice(offsets=(coord * 4 // mesh, 0), local_shape=(4 // mesh, 4),
                        global_shape=(4, 4), coordinates=(coord,), mesh_shape=(mesh,))
    req = RefRequest.from_tensor_slice("k", sl)
    req.tensor_meta = RefTensorMeta(shape=sl.local_shape, dtype="float32")
    return req.meta_only()


async def test_layout_change_reclaims_the_old_layouts_copies(fast_reclaims):
    """A re-put under another mesh that lands on v0 only drops v1's shards
    of the old layout from the index; the port reclaims them on v1 at the
    generation they were indexed at (the reference leaves them there,
    unindexed, until the key is deleted)."""
    out = {}
    for name, controller_cls, shard in (("port", Controller, _port_shard),
                                        ("reference", RefController, _ref_shard)):
        c = controller_cls()
        vols = {"v0": FakeVolume(gens={"k": 30}, kv={"k": "new"}),
                "v1": FakeVolume(gens={"k": 11}, kv={"k": "old"})}
        c.volume_refs = vols
        await c.notify_put_batch([shard(0, 2)], "v0", write_gens={"v0": {"k": 10}})
        await c.notify_put_batch([shard(1, 2)], "v1", write_gens={"v1": {"k": 11}})
        await c.notify_put_batch([shard(0, 1)], "v0", write_gens={"v0": {"k": 30}})
        await _drain(c)
        located = await c.locate_volumes(["k"])
        out[name] = (sorted(located["k"]), vols["v1"].calls, vols["v1"].kv, vols["v0"].calls)
    assert out["port"] == (["v0"], [("delete_if", [("k", 11)])], {}, [])
    assert out["reference"] == (["v0"], [], {"k": "old"}, [])


async def test_conditional_delete_on_a_volume_keeps_fresh_bytes_and_leased_reads():
    """delete_batch_if on a spawned volume: a stale generation deletes (a
    reader's zero-copy view of the segment stays readable: it retires
    under the read lease), a newer one keeps the bytes and reports them;
    write_gens reports the current generations."""
    with anyio.fail_after(TIMEOUT_S):
        async with port_store(num=1, replication=1) as name:
            await tst.put_batch({"a": torch.arange(1024.0), "b": torch.ones(1024)},
                                store_name=name)
            view = await tst.get("a", store_name=name)  # zero-copy, under a lease
            client = tst.client(name)
            vmap = await client.controller.get_volume_map.call_one()
            vol = vmap["0"]["ref"]
            gens = await vol.write_gens.call_one(["a", "b", "nope"])
            result = await vol.delete_batch_if.call_one([("a", gens["a"]), ("b", gens["b"] - 1)])
            after = await vol.write_gens.call_one(["a", "b"])
    assert set(gens) == {"a", "b"}
    assert result == {"removed": ["a"], "kept_fresh": ["b"], "kept_gens": {"b": gens["b"]}}
    assert after == {"b": gens["b"]}
    assert torch.equal(view, torch.arange(1024.0))


async def test_shutdown_reaps_a_killed_volumes_segments():
    """A SIGKILLed volume cannot unlink its tst_shm_ segments; shutdown
    does (the reference reaps only when a volume starts)."""
    from torchstore_tpu_torch.transport.shared_memory import SHM_DIR, owner_pid

    with anyio.fail_after(TIMEOUT_S):
        async with port_store(num=2, replication=2) as name:
            await tst.put("w", torch.arange(1 << 16, dtype=torch.float32), store_name=name)
            pid = await kill_port(name, "0")
            held = [n for n in os.listdir(SHM_DIR) if owner_pid(n) == pid]
            got = await tst.get("w", store_name=name)
            assert torch.equal(got, torch.arange(1 << 16, dtype=torch.float32))
            del got
    assert held  # the dead volume's segments outlived it until the shutdown
    assert [n for n in os.listdir(SHM_DIR) if owner_pid(n) == pid] == []
