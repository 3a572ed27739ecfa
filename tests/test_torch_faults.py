"""Fault points and the retries they drive.

``parse_spec`` and ``arm``'s checks against the JAX package's on the same
strings (exact), the count / prob / delay semantics (prob against the JAX
package's firing pattern from the same seed), and the fault half of
tests/test_strategies_and_faults.py on the port's store: injected death
and wedge surface bounded and named, a failed put leaves the store
consistent, a replicated put detaches the faulted replica. Then the
retries: a single-volume put demoted from shm to rpc, a get retried once,
a replicated put whose every replica failed landed again, the controller's
notify delayed, the channel's fault points."""

import asyncio
import random
import time
import uuid

import numpy as np
import pytest
import torch

import torchstore_tpu_torch as ts
from torchstore_tpu import faults as ref_faults
from torchstore_tpu_torch import faults
from torchstore_tpu_torch.config import RetryPolicy, StoreConfig
from torchstore_tpu_torch.observability import metrics as obs_metrics
from torchstore_tpu_torch.runtime import ActorDiedError, ActorTimeoutError
from torchstore_tpu_torch.strategy import LocalRankStrategy, StorageVolumeRef
from torchstore_tpu_torch.transport.buffers import TransportContext
from torchstore_tpu_torch.transport.factory import TransportType, demotion_ladder


def counter(name: str, **labels) -> float:
    metric = obs_metrics.counter(name)
    return metric.value(**labels) if labels else metric.total()


@pytest.fixture(autouse=True)
def disarm_everything():
    yield
    faults.disarm()
    ref_faults.disarm()


@pytest.fixture
async def store():
    name = f"tst_faults_{uuid.uuid4().hex[:6]}"
    await ts.initialize(store_name=name)
    yield name
    await ts.clear_faults(store_name=name)
    await ts.shutdown(name)


SPECS = [
    "volume.put=raise",
    "volume.put=raise:count=2;actor.ping=wedge",
    " controller.notify=delay:delay_ms=250 ; volume.get=raise:prob=0.5:count=3 ",
    "shm.handshake=die",
    "",
    ";;",
    "volume.put",
    "volume.put=raise:bogus=1",
    "volume.put=raise:count",
    "volume.get=raise:count=x",
]


@pytest.mark.parametrize("text", SPECS)
def test_parse_spec_equals_reference(text):
    def parse(module):
        try:
            return ("ok", module.parse_spec(text))
        except ValueError:
            return ("error", None)

    assert parse(faults) == parse(ref_faults)


@pytest.mark.parametrize("kwargs", [
    {"name": "volume.nope", "action": "raise"},
    {"name": "volume.put", "action": "explode"},
    {"name": "volume.put", "action": "raise", "count": 0},
    {"name": "volume.put", "action": "raise", "prob": 1.5},
    {"name": "volume.put", "action": "raise", "prob": 0.0},
])
def test_arm_refuses_what_the_reference_refuses(kwargs):
    for module in (faults, ref_faults):
        with pytest.raises(ValueError):
            module.arm(**kwargs)
    assert faults.armed() == []


def test_registry_names_are_the_reference_names():
    assert faults.REGISTRY <= ref_faults.REGISTRY
    assert faults.ACTIONS == ref_faults.ACTIONS


def test_count_fires_then_disarms():
    before = counter("ts_faults_fired_total", point="volume.put", action="raise")
    spec = faults.arm("volume.put", "raise", count=2)
    assert spec == {"name": "volume.put", "action": "raise", "count": 2, "prob": None,
                    "delay_ms": 100.0, "fired": 0}
    for _ in range(2):
        with pytest.raises(faults.FaultInjectedError, match="volume.put"):
            faults.fire("volume.put")
    assert faults.fire("volume.put") is None and faults.armed() == []
    assert counter("ts_faults_fired_total", point="volume.put", action="raise") == before + 2


def test_prob_fires_as_the_reference_does_from_one_seed():
    def pattern(module):
        module.arm("volume.get", "drop-frame", prob=0.3)
        random.seed(11)
        out = [module.fire("volume.get") for _ in range(200)]
        module.disarm()
        return out

    port = pattern(faults)
    assert port == pattern(ref_faults)
    assert 20 < port.count("drop-frame") < 100  # fired on some passes only


async def test_delay_and_unlimited_and_disarm():
    faults.arm("controller.locate", "delay", delay_ms=60)
    t0 = time.perf_counter()
    assert await faults.afire("controller.locate") is None
    assert await faults.afire("controller.locate") is None  # no count: every pass
    assert time.perf_counter() - t0 >= 0.12
    assert [s["fired"] for s in faults.armed()] == [2]
    assert faults.disarm("controller.locate") == 1 and faults.disarm("controller.locate") == 0
    assert await faults.afire("controller.locate") is None


def test_env_arming_after_fork(monkeypatch):
    monkeypatch.setenv(faults.ENV_FAULTPOINTS, "volume.get=raise:count=1;actor.ping=delay")
    faults.reinit_after_fork()
    assert sorted(s["name"] for s in faults.armed()) == ["actor.ping", "volume.get"]
    monkeypatch.setenv(faults.ENV_FAULTPOINTS, "volume.get=raise:count=")  # malformed
    faults.reinit_after_fork()
    assert faults.armed() == []  # nothing armed, nothing raised


# ---- the store under faults -------------------------------------------------


async def test_injected_volume_death_surfaces_as_dead(store):
    await ts.put("k", torch.ones(4), store_name=store)
    await ts.inject_fault("volume.get", "die", store_name=store)
    t0 = time.monotonic()
    with pytest.raises(ActorDiedError, match="volume 0|connection"):
        await ts.get("k", store_name=store)
    assert time.monotonic() - t0 < 20  # no retry waits on a dead volume


async def test_put_to_a_dead_volume_fails_without_retrying():
    """A volume whose process is gone answers no ping: its put surfaces at
    once instead of retrying to the policy's deadline."""
    from torchstore_tpu_torch import api

    name = f"tst_deadput_{uuid.uuid4().hex[:6]}"
    await ts.initialize(store_name=name, config=StoreConfig(retry=RetryPolicy(deadline_s=60.0)))
    try:
        await ts.put("k", torch.ones(4), store_name=name)
        retries = counter("ts_client_put_retries_total")
        for proc in api._stores[name].volume_mesh._processes:
            proc.kill()
            proc.join(10)
        t0 = time.monotonic()
        with pytest.raises(ActorDiedError):
            await ts.put("k", torch.zeros(4), store_name=name)
        assert time.monotonic() - t0 < 20
        assert counter("ts_client_put_retries_total") == retries
    finally:
        await ts.shutdown(name)


async def test_wedged_volume_times_out_bounded():
    name = f"tst_wedge_{uuid.uuid4().hex[:6]}"
    await ts.initialize(store_name=name, config=StoreConfig(rpc_timeout=2.0))
    try:
        await ts.put("k", torch.ones(4), store_name=name)
        await ts.inject_fault("volume.get", "wedge", store_name=name)
        t0 = time.monotonic()
        with pytest.raises(ActorTimeoutError):
            await ts.get("k", store_name=name)
        assert time.monotonic() - t0 < 30
    finally:
        await ts.clear_faults(store_name=name)
        await ts.shutdown(name)


async def test_failed_put_leaves_store_consistent():
    name = f"tst_consist_{uuid.uuid4().hex[:6]}"
    config = StoreConfig(retry=RetryPolicy(deadline_s=0.3, jitter=0.0))
    await ts.initialize(store_name=name, config=config)
    try:
        await ts.put("k", torch.ones(4), store_name=name)
        await ts.inject_fault("volume.put", "raise", count=1000, store_name=name)
        with pytest.raises(faults.FaultInjectedError):
            await ts.put("k", torch.zeros(4), store_name=name)
        await ts.clear_faults(store_name=name)
        assert torch.equal(await ts.get("k", store_name=name), torch.ones(4))
        assert await ts.keys(store_name=name) == ["k"]
    finally:
        await ts.shutdown(name)


async def test_replicated_put_detaches_faulted_replica():
    name = f"tst_detach_{uuid.uuid4().hex[:6]}"
    await ts.initialize(num_storage_volumes=3, strategy=LocalRankStrategy(replication=2),
                        store_name=name)
    try:
        client = ts.client(name)
        await client._ensure_setup()
        targets = [v.volume_id for v in client._put_volumes()]
        assert len(targets) == 2
        await ts.inject_fault("volume.put", "raise", count=1000, scope=targets[1],
                              store_name=name)
        await ts.put("k", torch.arange(8.0), store_name=name)
        located = await client.controller.locate_volumes.call_one(["k"])
        assert set(located["k"]) == {targets[0]}  # the faulted replica detached
        assert torch.equal(await ts.get("k", store_name=name), torch.arange(8.0))
        await ts.clear_faults(store_name=name)
        await ts.put("k", torch.arange(8.0) + 1, store_name=name)
        located = await client.controller.locate_volumes.call_one(["k"])
        assert set(located["k"]) == set(targets)
    finally:
        await ts.shutdown(name)


async def test_replicated_put_all_failed_lands_again():
    name = f"tst_allfail_{uuid.uuid4().hex[:6]}"
    await ts.initialize(num_storage_volumes=2, strategy=LocalRankStrategy(replication=2),
                        store_name=name)
    try:
        before = counter("ts_client_failovers_total", op="put")
        await ts.inject_fault("volume.put", "raise", count=1, store_name=name)  # both
        await ts.put("k", torch.arange(6.0), store_name=name)
        assert counter("ts_client_failovers_total", op="put") == before + 1
        located = await ts.client(name).controller.locate_volumes.call_one(["k"])
        assert len(located["k"]) == 2
        assert torch.equal(await ts.get("k", store_name=name), torch.arange(6.0))
    finally:
        await ts.shutdown(name)


def test_demotion_ladder():
    here = __import__("torchstore_tpu_torch.utils", fromlist=["get_hostname"]).get_hostname()

    def ladder(transport=None, hostname=here, **cfg):
        ref = StorageVolumeRef(actor=None, volume_id="0", transport_context=TransportContext(),
                               hostname=hostname, transport_type=transport)
        return [r.value for r in demotion_ladder(ref, StoreConfig(**cfg))]

    assert ladder() == ["shm", "bulk", "rpc"]
    assert ladder("shm") == ["shm", "bulk", "rpc"]
    assert ladder("bulk") == ["bulk", "rpc"]
    assert ladder("rpc") == ["rpc"]
    assert ladder(hostname="elsewhere") == ["bulk", "rpc"]
    assert ladder(shm_enabled=False) == ["bulk", "rpc"]
    assert ladder(shm_enabled=False, bulk_tcp_enabled=False) == ["rpc"]
    assert TransportType("rpc") is TransportType.RPC


@pytest.mark.parametrize("transport,rung", [(None, "bulk"), ("rpc", "rpc")],
                         ids=["shm_demoted", "rpc_pinned"])
async def test_single_volume_put_retries_down_the_ladder(transport, rung):
    name = f"tst_ladder_{uuid.uuid4().hex[:6]}"
    await ts.initialize(store_name=name,
                        strategy=ts.SingletonStrategy(default_transport_type=transport))
    try:
        retries = counter("ts_client_put_retries_total", transport=rung)
        failovers = counter("ts_client_failovers_total", op="put")
        x = torch.randn(1 << 16, generator=torch.Generator().manual_seed(1))
        await ts.inject_fault("volume.put", "raise", count=1, store_name=name)
        await ts.put("k", x, store_name=name)
        assert counter("ts_client_put_retries_total", transport=rung) == retries + 1
        assert counter("ts_client_failovers_total", op="put") == failovers + 1
        assert torch.equal(await ts.get("k", store_name=name), x)
    finally:
        await ts.shutdown(name)


async def test_get_retries_once_after_a_fault(store):
    x = torch.arange(1000.0)
    await ts.put("k", x, store_name=store)
    retries = counter("ts_client_fetch_retries_total")
    failovers = counter("ts_client_failovers_total", op="get")
    await ts.inject_fault("volume.get", "raise", count=1, store_name=store)
    assert torch.equal(await ts.get("k", store_name=store), x)
    assert counter("ts_client_fetch_retries_total") == retries + 1
    assert counter("ts_client_failovers_total", op="get") == failovers + 1


async def test_delayed_notify_and_locate_and_cleared_everywhere(store):
    await ts.inject_fault("controller.notify", "delay", delay_ms=200, scope="controller",
                          store_name=store)
    t0 = time.perf_counter()
    await ts.put("k", torch.ones(3), store_name=store)
    assert time.perf_counter() - t0 >= 0.2
    await ts.inject_fault("controller.locate", "raise", count=1, scope="all", store_name=store)
    with pytest.raises(faults.FaultInjectedError):
        faults.fire("controller.locate")  # the client scope armed it here too
    client = ts.client(store)
    with pytest.raises(faults.FaultInjectedError):
        await client.controller.locate_volumes.call_one(["k"])
    await ts.clear_faults(store_name=store)
    assert await client.controller.list_faults.call_one() == []
    (volume,) = client._volume_refs.values()
    assert await volume.actor.list_faults.call_one() == []
    with pytest.raises(ValueError, match="unknown fault scope"):
        await ts.inject_fault("volume.put", "raise", scope="nowhere", store_name=store)


async def test_ping_fault_inside_one_volume(store):
    client = ts.client(store)
    await client._ensure_setup()
    (volume,) = client._volume_refs.values()
    assert await volume.actor.ping()
    await ts.inject_fault("actor.ping", "raise", count=1, store_name=store)
    with pytest.raises(faults.FaultInjectedError):
        await volume.actor.ping()
    assert await volume.actor.ping()


async def test_channel_fault_points(store):
    """publish_layer (client), watermark (controller) and delta_baseline
    (publisher and reader) each fail their step loudly; once cleared, the
    same channel publishes and delivers correct bytes."""
    stream = ts.state_dict_stream("sd", store_name=store)
    faults.arm("channel.publish_layer", "raise", count=1)
    with pytest.raises(faults.FaultInjectedError):
        await stream.put({"a": torch.ones(4)})
    await ts.inject_fault("channel.watermark", "raise", count=1, scope="controller",
                          store_name=store)
    with pytest.raises(faults.FaultInjectedError):
        await stream.put({"a": torch.ones(4)})
    await stream.put({"b": torch.ones(2)})
    await stream.seal()
    out = await ts.get_state_dict("sd", store_name=store)
    assert set(out) == {"a", "b"}

    pub = ts.WeightPublisher("fb", store_name=store, keep=5, transfer_quant="int8_block",
                             delta=True, keyframe_every=4)
    sub = ts.WeightSubscriber("fb", store_name=store)
    w = {"w": torch.from_numpy(np.random.default_rng(0).standard_normal(512).astype(np.float32))}
    await pub.publish(w)
    await sub.acquire(timeout=30)
    faults.arm("channel.delta_baseline", "raise", count=1)
    w["w"][:64] += 0.1
    with pytest.raises(faults.FaultInjectedError):
        await pub.publish(w)
    faults.disarm()
    ver = await pub.publish(w)
    sd, got = await sub.acquire(timeout=30)
    assert got == ver
    step = float(w["w"].abs().max()) / 127
    assert torch.allclose(sd["w"], w["w"], atol=step)


async def test_faults_arm_in_spawned_children_from_env(monkeypatch):
    """TORCHSTORE_TORCH_FAULTPOINTS rides into freshly spawned volumes."""
    monkeypatch.setenv(faults.ENV_FAULTPOINTS, "volume.get=raise:count=1")
    name = f"tst_envfault_{uuid.uuid4().hex[:6]}"
    await ts.initialize(store_name=name)
    monkeypatch.delenv(faults.ENV_FAULTPOINTS)
    faults.reinit_after_fork()  # this process armed it at its own import
    try:
        client = ts.client(name)
        await client._ensure_setup()
        (volume,) = client._volume_refs.values()
        armed = await volume.actor.list_faults.call_one()
        assert [(s["name"], s["count"]) for s in armed] == [("volume.get", 1)]
        await ts.put("k", torch.ones(2), store_name=name)
        assert torch.equal(await ts.get("k", store_name=name), torch.ones(2))  # retried
        assert await volume.actor.list_faults.call_one() == []
    finally:
        await ts.shutdown(name)
        await asyncio.sleep(0)
