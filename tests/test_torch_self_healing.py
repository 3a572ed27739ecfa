"""Port twin of the supervisor and routing cases of tests/test_self_healing.py
(its retry-policy and fault-point cases are twinned in
tests/test_torch_config.py and tests/test_torch_faults.py; the few those
lack are here): the controller's heartbeat quarantines a dead volume and
auto-repair copies its keys onto healthy volumes; a volume whose pings
fail for a while is quarantined, then reinstated through probation; puts
route around a quarantined volume; an interval of 0 turns the supervisor
off. Each scenario runs through both packages (the JAX store off shared
memory) and the health states, placements and bytes read back are
compared. Then the port's own: a volume answers pings while a bulk pull
runs, ``pull_from`` lands in the volume's pool and refuses relay hops,
the reclaim schedule's parsing, and the two port-only repairs: a put
that lands on an auto-repair's target during its pull keeps its bytes
(through both packages, the reference's stale result recorded), and a
volume whose disk writes are slow is never quarantined."""

import asyncio
import pickle
import time

import anyio
import numpy as np
import pytest
import torch

import torchstore_tpu_torch as tst
from torchstore_tpu import faults as ref_faults
from torchstore_tpu.config import RetryPolicy as RefRetryPolicy
from torchstore_tpu.controller import Controller as RefController
from torchstore_tpu_torch import config as port_config
from torchstore_tpu_torch import faults
from torchstore_tpu_torch.config import RetryPolicy
from tests.test_torch_replication import (  # noqa: F401 - the autouse fixture
    kill_port,
    kill_ref,
    port_store,
    ref_store,
    reference_off_shared_memory,
    to_np,
)
from tests.test_torch_repair import PORT, REF, Pkg

TIMEOUT_S = 90


@pytest.fixture
def fast_health(monkeypatch):
    for prefix in ("TORCHSTORE_TORCH_", "TORCHSTORE_TPU_"):
        monkeypatch.setenv(prefix + "HEALTH_INTERVAL_S", "0.2")
        monkeypatch.setenv(prefix + "HEALTH_MISS_THRESHOLD", "3")


async def wait_for(predicate, timeout=30.0, interval=0.05, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        result = await predicate()
        if result:
            return result
        await asyncio.sleep(interval)
    raise AssertionError(f"timed out waiting for {what}")


async def both(scenario, *args, **store_kw) -> tuple:
    out = []
    with anyio.fail_after(TIMEOUT_S):
        for pkg in (PORT, REF):
            async with pkg.store(**store_kw) as name:
                out.append(await scenario(pkg, name, *args))
    return tuple(out)


# ---- the supervisor, both packages ------------------------------------------


async def _quarantine_and_auto_repair(pkg: Pkg, name: str, want: np.ndarray) -> dict:
    await pkg.mod.put("k", pkg.wrap(want), store_name=name)
    client = pkg.mod.client(name)
    victim = sorted((await client.controller.locate_volumes.call_one(["k"]))["k"])[0]
    await pkg.kill(name, victim)

    async def quarantined():
        return (await pkg.mod.volume_health(name))[victim]["state"] == "quarantined"

    await wait_for(quarantined, what=f"quarantine of {victim}")

    async def rereplicated():
        vids = set((await client.controller.locate_volumes.call_one(["k"]))["k"])
        return sorted(vids) if victim not in vids and len(vids) == 2 else None

    placed = await wait_for(rereplicated, what="auto re-replication")
    stats = await client.controller.stats.call_one()
    return {"victim": victim, "placed": placed,
            "got": to_np(await pkg.mod.get("k", store_name=name)).tolist(),
            "states": {v: h["state"] for v, h in stats["volume_health"].items()}}


async def test_supervisor_quarantines_dead_volume_and_auto_repairs(fast_health):
    """Kill one of three volumes: the supervisor quarantines it with no
    repair call, locate stops listing it, the key is copied onto the
    remaining healthy volume, and gets keep working."""
    want = np.arange(64.0, dtype=np.float32)
    port, ref = await both(_quarantine_and_auto_repair, want)
    # The other volumes' states are left out: under load either package's
    # supervisor may put a slow survivor through probation.
    for out in (port, ref):
        out["states"] = out["states"][out["victim"]]
    assert port == ref
    assert port["got"] == want.tolist() and port["states"] == "quarantined"


async def _probation(pkg: Pkg, name: str) -> dict:
    client = pkg.mod.client(name)
    await client._ensure_setup()
    victim = sorted(client._volume_refs)[0]
    # 5 failing pings: 3 misses quarantine it, the rest keep it down, then
    # it answers again on its own.
    await pkg.mod.inject_fault("actor.ping", "raise", count=5, scope=victim, store_name=name)
    seen = []

    def state_is(state):
        async def check():
            got = (await pkg.mod.volume_health(name))[victim]["state"]
            if not seen or seen[-1] != got:
                seen.append(got)
            return got == state
        return check

    await wait_for(state_is("quarantined"), what="quarantine")
    await wait_for(state_is("ok"), what="reinstatement through probation")
    return {"victim": victim, "health": (await pkg.mod.volume_health(name))[victim],
            "path": seen}


async def test_supervisor_probation_then_reinstatement(fast_health):
    port, ref = await both(_probation, num=2, replication=1)
    # A loaded machine may add a late ping to either package's path: the
    # states it ends on are compared.
    for out in (port, ref):
        out["path"] = out["path"][-3:]
    assert port == ref
    assert port["health"]["state"] == "ok"
    assert port["path"] == ["quarantined", "probation", "ok"]


async def _route_around(pkg: Pkg, name: str) -> dict:
    client = pkg.mod.client(name)
    await client._ensure_setup()
    victim = sorted(client._volume_refs)[0]
    await pkg.kill(name, victim)

    async def quarantined():
        return (await pkg.mod.volume_health(name))[victim]["state"] == "quarantined"

    await wait_for(quarantined, what="quarantine")
    # Sync the client's health view, then put a burst: each lands on the
    # surviving volume.
    await client.placement_epoch()
    if client._volumes_stale:
        await client._refresh_health()
    for i in range(4):
        await pkg.mod.put(f"r{i}", pkg.wrap(np.full(8, float(i), np.float32)), store_name=name)
    keys = [f"r{i}" for i in range(4)]
    placed = await client.controller.locate_volumes.call_one(keys)
    return {"victim": victim, "placed": {k: sorted(v) for k, v in placed.items()},
            "got": [to_np(await pkg.mod.get(k, store_name=name)).tolist() for k in keys]}


async def test_puts_route_around_quarantined_volume(fast_health):
    port, ref = await both(_route_around, num=2, replication=1)
    assert port == ref
    assert all(port["victim"] not in v for v in port["placed"].values())
    assert port["got"] == [[float(i)] * 8 for i in range(4)]


async def _off(pkg: Pkg, name: str) -> dict:
    await pkg.mod.put("k", pkg.wrap(np.ones(2, np.float32)), store_name=name)
    return await pkg.mod.volume_health(name)


async def test_supervisor_disabled_by_interval_zero(monkeypatch):
    for prefix in ("TORCHSTORE_TORCH_", "TORCHSTORE_TPU_"):
        monkeypatch.setenv(prefix + "HEALTH_INTERVAL_S", "0")
    port, ref = await both(_off, num=1, replication=1)
    assert port == ref
    assert all(h["state"] == "ok" for h in port.values())


async def _get_through_fault(pkg: Pkg, name: str, want: np.ndarray) -> list:
    await pkg.mod.put("k", pkg.wrap(want), store_name=name)
    await pkg.mod.inject_fault("volume.get", "raise", count=1, scope="volumes",
                               store_name=name)
    got = to_np(await pkg.mod.get("k", store_name=name)).tolist()
    assert await pkg.mod.clear_faults(store_name=name) >= 0
    return got


async def test_get_fails_over_through_injected_fault():
    """volume.get raising once on every volume: the retry reads a replica
    again and the caller never sees the fault."""
    want = np.arange(16.0, dtype=np.float32)
    try:
        port, ref = await both(_get_through_fault, want, num=2, replication=2)
    finally:
        faults.disarm()
        ref_faults.disarm()
    assert port == ref == want.tolist()


# ---- retry-policy and fault-point cases the other twins lack ---------------


def test_retry_policy_jitter_bounds():
    for policy in (RetryPolicy(base_s=1.0, max_s=1.0, multiplier=1.0, jitter=0.25),
                   RefRetryPolicy(base_s=1.0, max_s=1.0, multiplier=1.0, jitter=0.25)):
        assert all(0.75 <= policy.backoff(0) <= 1.25 for _ in range(50))


def test_retry_policy_rides_store_config():
    cfg = tst.StoreConfig(retry=RetryPolicy(base_s=0.01, deadline_s=1.0))
    clone = pickle.loads(pickle.dumps(cfg))
    assert clone.retry.base_s == 0.01 and clone.retry.deadline_s == 1.0


def test_registry_covers_documented_sites():
    for name in ("controller.notify", "controller.locate", "volume.put", "volume.get",
                 "volume.handshake", "shm.handshake", "actor.ping", "bulk.send_frame",
                 "bulk.recv_frame", "rendezvous.dispatch"):
        assert name in faults.REGISTRY and name in ref_faults.REGISTRY


def test_drop_frame_returns_sentinel():
    try:
        for module in (faults, ref_faults):
            module.arm("bulk.send_frame", "drop-frame", count=1)
            assert module.fire("bulk.send_frame") == "drop-frame"
            assert module.fire("bulk.send_frame") is None
    finally:
        faults.disarm()
        ref_faults.disarm()


@pytest.mark.parametrize("raw", [None, "", "0.5,2", "1, 2 ,3", "bogus", "1,,2", "-"])
def test_reclaim_schedule_parses_as_the_reference(raw, monkeypatch):
    """The drainer's schedule from the env: the reference's (delays and
    deadline) for every value, a malformed one falling back to 1,5,15,60
    without raising."""
    for name in ("TORCHSTORE_TORCH_RECLAIM_DELAYS", "TORCHSTORE_TPU_RECLAIM_DELAYS"):
        if raw is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, raw)
    port = port_config.reclaim_policy()
    ref = RefController().core._reclaim_policy()
    assert (port.delays, port.deadline_s) == (ref.delays, ref.deadline_s)


def test_health_knobs_fall_back_on_malformed_values(monkeypatch):
    monkeypatch.setenv("TORCHSTORE_TORCH_HEALTH_INTERVAL_S", "soon")
    monkeypatch.setenv("TORCHSTORE_TORCH_HEALTH_MISS_THRESHOLD", "0")
    monkeypatch.setenv("TORCHSTORE_TORCH_AUTO_REPAIR", "off")
    assert port_config.health_interval_s() == 2.0
    assert port_config.health_miss_threshold() == 1
    assert port_config.auto_repair_enabled() is False


# ---- the port's own: pings under a bulk pull, pull_from ---------------------


async def test_volume_answers_pings_while_a_bulk_pull_runs(monkeypatch):
    """A pull_from over the bulk rung, its link rate held down so it lasts
    a while, must not read as missed heartbeats: the source and the target
    answer pings throughout, and the pulled copies land."""
    monkeypatch.setenv("TORCHSTORE_TORCH_BULK_EMULATE_GBPS", "0.05")
    # 16 frames of 2 MiB, each followed by the held rate's pause: ~0.7 s.
    items = {f"b{i}": torch.full((1 << 19,), float(i)) for i in range(16)}
    nbytes = sum(t.numel() * 4 for t in items.values())
    with anyio.fail_after(TIMEOUT_S):
        async with port_store(num=3, replication=1) as name:
            await tst.put_batch(items, store_name=name)
            client = tst.client(name)
            vmap = await client.controller.get_volume_map.call_one()
            metas = [client._value_to_requests(k, v)[0].meta_only() for k, v in items.items()]
            pull = asyncio.ensure_future(vmap["2"]["ref"].pull_from.call_one(
                vmap["0"]["ref"], metas, src_hostname=vmap["0"]["hostname"], src_volume="0"))
            worst = 0.0
            pings = 0
            while not pull.done():
                t0 = time.monotonic()
                await asyncio.wait_for(asyncio.gather(vmap["0"]["ref"].ping(),
                                                      vmap["2"]["ref"].ping()), 2.0)
                worst = max(worst, time.monotonic() - t0)
                pings += 1
                await asyncio.sleep(0.05)
            result = await pull
            stats = await client.controller.stats.call_one(include_volumes=True)
    assert result["rung"] == "bulk" and result["bytes"] == nbytes
    assert set(result["write_gens"]) == set(items)
    # The supervisor waits 2 s for a ping at its default interval.
    assert pings >= 3 and worst < 1.0
    assert stats["volumes"]["2"]["resident_bytes"] == nbytes


async def test_pull_from_lands_in_the_pool_and_refuses_relay_hops():
    """A pulled copy lives in a segment of the target's pool: indexed there
    by the controller, it serves a get once its source is dead. relay=True is the
    broadcast relay's (not ported) and raises naming it."""
    from torchstore_tpu_torch.runtime import RemoteActorError

    want = torch.randn(64, 32, generator=torch.Generator().manual_seed(3))
    with anyio.fail_after(TIMEOUT_S):
        async with port_store(num=2, replication=1) as name:
            await tst.put("w", want, store_name=name)
            client = tst.client(name)
            vmap = await client.controller.get_volume_map.call_one()
            meta = client._value_to_requests("w", want)[0].meta_only()
            with pytest.raises((NotImplementedError, RemoteActorError), match="A11.1"):
                await vmap["1"]["ref"].pull_from.call_one(vmap["0"]["ref"], [meta], relay=True)
            result = await vmap["1"]["ref"].pull_from.call_one(
                vmap["0"]["ref"], [meta], src_hostname=vmap["0"]["hostname"], src_volume="0")
            await client.controller.notify_put_batch.call_one(
                [meta], "1", write_gens={"1": result["write_gens"]})
            stats = await client.controller.stats.call_one(include_volumes=True)
            shm = stats["volumes"]["1"].get("shm", {})
            await kill_port(name, "0")  # the copy on volume 1 alone serves now
            got = await client.get_batch({"w": None})
    torch.testing.assert_close(got["w"], want, rtol=0, atol=0)
    assert shm.get("live_segments", 0) >= 1


# ---- repairs: a put during an auto-repair pull; disk writes off the loop ----

PULL_DELAY_MS = 3000  # the source serves the auto-repair's read this late
SRC_PUT_DELAY_MS = 5000  # and lands the racing put later still


async def _copies(pkg: Pkg, name: str, key: str) -> dict:
    """What each healthy replica of ``key`` serves, read through a client
    pinned to that replica alone."""
    client = pkg.mod.client(name)
    located = (await client.controller.locate_volumes.call_one([key]))[key]
    out = {}
    for vid in sorted(located):
        reader = type(client)(client.controller, client._config)
        await reader.get(key)  # the reader's first read settles its epoch
        reader._loc_cache[key] = {vid: located[vid]}
        out[vid] = to_np(await reader.get(key)).tolist()
        if hasattr(reader, "close"):
            reader.close()
    return out


async def _put_during_pull(pkg: Pkg, name: str) -> dict:
    old, new = np.full(1024, 1.0, np.float32), np.full(1024, 2.0, np.float32)
    await pkg.mod.put("k", pkg.wrap(old), store_name=name)
    client = pkg.mod.client(name)
    victim, src = sorted((await client.controller.locate_volumes.call_one(["k"]))["k"])
    (tgt,) = set(client._volume_refs) - {victim, src}
    # The source serves the auto-repair's read late and takes the racing
    # put's bytes later still: the pull reads the old value while the put
    # has landed on the target.
    await pkg.mod.inject_fault("volume.get", "delay", count=1, delay_ms=PULL_DELAY_MS,
                               scope=src, store_name=name)
    await pkg.mod.inject_fault("volume.put", "delay", count=1, delay_ms=SRC_PUT_DELAY_MS,
                               scope=src, store_name=name)
    await pkg.kill(name, victim)

    async def quarantined():
        return (await pkg.mod.volume_health(name))[victim]["state"] == "quarantined"

    await wait_for(quarantined, what=f"quarantine of {victim}")
    src_ref = client._volume_refs[src].actor

    async def pulling():  # the source's get delay fired: the read is in flight
        return not any(f["name"] == "volume.get" for f in await src_ref.list_faults.call_one())

    await wait_for(pulling, what="the auto-repair pull")
    await client.placement_epoch()
    if client._volumes_stale:
        await client._refresh_health()
    await pkg.mod.put("k", pkg.wrap(new), store_name=name)  # lands on src and tgt

    async def settled():
        stats = await client.controller.stats.call_one()
        return not stats.get("pending_reclaims") and stats

    stats = await wait_for(settled, what="reclaims to drain")
    return {"victim": victim, "src": src, "tgt": tgt, "copies": await _copies(pkg, name, "k"),
            "skipped_moved": stats.get("auto_repairs", {}).get(victim, {}).get("skipped_moved")}


async def test_put_during_auto_repair_pull_keeps_its_bytes(fast_health, monkeypatch):
    """Kill one of three volumes; while auto-repair pulls its key from the
    survivor, a put of the same key lands on the pull's target. Every
    healthy copy then serves the put's value: the pull drops what it read
    for a key whose write generation moved during the read, and the
    controller neither indexes nor reclaims it (``skipped_moved``).

    The reference runs the same schedule: its pull stores the old value
    over the put's on the target, under the put's metadata, and its
    reclaim skips the key because the put indexed it there. Recorded, not
    ground truth: in a run on the CPU its target served 1.0 and its source
    2.0; in another its client had not seen the quarantine, so the put
    went to the dead volume and the survivor alone (ROADMAP Queue C, the
    port-only repair of the stale pull)."""
    for prefix in ("TORCHSTORE_TORCH_", "TORCHSTORE_TPU_"):
        monkeypatch.setenv(prefix + "RECLAIM_DELAYS", "0.05,0.1,0.2,0.4")
    port, ref = await both(_put_during_pull)
    new = [2.0] * 1024
    assert port["copies"] == {port["src"]: new, port["tgt"]: new}
    assert port["skipped_moved"] == 1
    # The reference's copies hold values that were put; which ones is its
    # own (recorded in the docstring), not this test's ground truth.
    assert all(copy in ([1.0] * 1024, new) for copy in ref["copies"].values())


async def test_slow_disk_writes_never_quarantine_the_volume(monkeypatch, tmp_path):
    """A durable put and a spill whose file writes each take 2 s, under a
    supervisor at 0.25 s and 2 misses: the writes run on the landing
    pool's threads, so the volume's loop answers every ping (no
    quarantine), and every key reads back bit-equal, the spilled one
    faulted in. The volume is colocated, so the slowed write is this
    process's."""
    from torchstore_tpu_torch.storage_utils import file_store

    monkeypatch.setenv("TORCHSTORE_TORCH_HEALTH_INTERVAL_S", "0.25")
    monkeypatch.setenv("TORCHSTORE_TORCH_HEALTH_MISS_THRESHOLD", "2")
    monkeypatch.setenv("TORCHSTORE_TORCH_TIER_ENABLED", "1")
    monkeypatch.setenv("TORCHSTORE_TORCH_TIER_DIR", str(tmp_path / "tier"))
    monkeypatch.setenv("TORCHSTORE_TORCH_TIER_BUDGET_BYTES", str(8 * 1024))
    monkeypatch.setenv("TORCHSTORE_TORCH_TIER_HIGH_PCT", "0.5")
    monkeypatch.setenv("TORCHSTORE_TORCH_TIER_LOW_PCT", "0.25")
    monkeypatch.setenv("TORCHSTORE_TORCH_TIER_SWEEP_INTERVAL_S", "0")
    persist = file_store.FileBackedStore._persist_file
    slowed = []

    def slow_persist(path, fname, t):
        slowed.append(fname)
        time.sleep(2.0)
        return persist(path, fname, t)

    monkeypatch.setattr(file_store.FileBackedStore, "_persist_file", staticmethod(slow_persist))
    gen = torch.Generator().manual_seed(11)
    want = {"c/v0/w": torch.randn(1024, generator=gen), "c/v1/w": torch.randn(1024, generator=gen)}
    name = "tst_slow_disk"
    with anyio.fail_after(60):
        await tst.initialize(store_name=name, colocated=True, storage_dir=str(tmp_path / "dur"))
        try:
            await tst.put("c/v0/w", want["c/v0/w"], store_name=name)  # a slowed durable put
            await tst.put("c/v1/w", want["c/v1/w"], store_name=name)
            swept = await tst.tier_sweep(store_name=name)  # slowed spills
            got = {k: await tst.get(k, store_name=name) for k in want}
            stats = await tst.client(name).controller.stats.call_one(include_volumes=True)
            health = await tst.volume_health(name)
        finally:
            await tst.shutdown(name)
    assert sum(v.get("spilled", 0) for v in swept.values()) >= 1
    assert len(slowed) >= 3  # two durable puts and at least one spill
    quarantines = sum(s["value"] for s in
                      stats["metrics"].get("ts_quarantines_total", {}).get("series", []))
    assert quarantines == 0 and all(h["state"] == "ok" for h in health.values())
    for key, tensor in want.items():
        torch.testing.assert_close(got[key], tensor, rtol=0, atol=0)


# ---- the index's side of a pull that raced a put (one controller, fakes) ----


class _PullEndpoint:
    def __init__(self, fn):
        self.fn = fn

    def effective_timeout(self):
        return 30.0

    def with_timeout(self, _timeout):
        return self

    async def call_one(self, *args, **kwargs):
        return await self.fn(*args, **kwargs)


class _PullTarget:
    """A target volume whose pull_from runs ``during`` (the race), then
    reports the pulled key stored at generation 30, or moved."""

    def __init__(self, during=None, moved=False):
        self.pull_from = _PullEndpoint(self._pull)
        self.during, self.moved = during, moved

    async def _pull(self, src, metas, **kw):
        if self.during is not None:
            await self.during()
        keys = [m.key for m in metas]
        return {"write_gens": {} if self.moved else {k: 30 for k in keys},
                "moved": keys if self.moved else [], "rung": "rpc", "bytes": 0,
                "seconds": 0.0, "alloc_s": 0.0}


def _race_controller(target: _PullTarget) -> tuple:
    from torchstore_tpu_torch.controller import Controller
    from torchstore_tpu_torch.transport.types import Request, TensorMeta

    c = Controller()
    c.volume_refs = {"v0": object(), "v1": object(), "v2": target}
    c.volume_hostnames = {}
    req = Request.from_tensor("k", torch.ones(4))
    req.tensor_meta = TensorMeta(shape=(4,), dtype="float32")
    return c, req.meta_only()


async def _repair_race(target: _PullTarget) -> tuple:
    c, meta = target.controller, target.meta
    await c.notify_put_batch([meta], ["v0", "v1"], write_gens={"v0": {"k": 10}, "v1": {"k": 10}})
    report = await c.core.auto_repair_pass("v0", ["v1", "v2"])
    return c, report


def _put_b(target: _PullTarget):
    async def put():  # a put that landed on v2 (gen 20) before the pull stored (30)
        await target.controller.notify_put_batch(
            [target.meta], ["v2", "v1"], write_gens={"v2": {"k": 20}, "v1": {"k": 21}},
            supersede=True)  # as every client put
    return put


@pytest.mark.parametrize("case", ["moved", "notify_during_pull", "notify_after_pull"])
async def test_index_never_serves_a_pull_that_replaced_a_put(case):
    """The three orders of an auto-repair pull and a put of the same key on
    its target: the target kept the put's bytes (``moved``: neither
    indexed nor reclaimed), or the pull's store replaced them, the put's
    notify landing before or after the pull returned. In the last two the
    target's entry is detached and the pulled copy reclaimed at its
    generation, so the index never lists the target under the put's
    metadata."""
    target = _PullTarget(moved=case == "moved")
    target.controller, target.meta = _race_controller(target)
    if case == "notify_during_pull":
        target.during = _put_b(target)
    try:
        c, report = await _repair_race(target)
        if case == "notify_after_pull":
            assert c.core.index.get("k")["v2"].pulled_gen == 30
            await _put_b(target)()
        infos = c.core.index.get("k")
        pending = dict(c._pending_reclaims.get("v2", {}))
    finally:
        c.core.teardown()
    if case == "moved":
        assert report["skipped_moved"] == 1 and report["keys"] == 0
        assert set(infos) == {"v0", "v1"} and pending == {}
    else:
        assert set(infos) == {"v1"} and infos["v1"].write_gen == 21
        assert pending == {"k": 30}
