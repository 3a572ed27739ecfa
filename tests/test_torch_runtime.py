"""The port's actor runtime: pickle-5 frames with out-of-band CPU tensors
(device tensors refused), and RPC to spawned actor processes with remote
errors re-raised in the caller; then the cases of tests/test_runtime.py
(fan-out, mesh indexing, actor to actor, the singleton registry, a failed
spawn), in-process dispatch, and the forkserver start: no CUDA in the
helper, each child with the env it was spawned with."""

import asyncio
import multiprocessing
import os

import anyio
import pytest
import torch

from torchstore_tpu_torch.runtime import (
    Actor,
    ActorDiedError,
    ActorMeshRef,
    RemoteActorError,
    actors,
    endpoint,
    spawn_actors,
)
from torchstore_tpu_torch.runtime.serialization import (
    SerializationError,
    dumps,
    loads,
    read_message,
    write_message,
)
from torchstore_tpu_torch.storage_volume import StorageVolume
from torchstore_tpu_torch.strategy import SingletonStrategy
from torchstore_tpu_torch.transport.rpc import RPCTransportBuffer
from torchstore_tpu_torch.transport.types import Request


def tensors():
    g = torch.Generator().manual_seed(0)
    return {
        "f32": torch.randn(5, 7, generator=g),
        "bf16": torch.randn(64, generator=g).to(torch.bfloat16),
        "bool": torch.randn(9, generator=g) > 0,
        "i64": torch.arange(-3, 4),
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros(0, 3),
        "transposed": torch.randn(4, 6, generator=g).t(),
    }


def test_tensors_ride_out_of_band_and_round_trip():
    value = {"nested": [tensors(), ("x", 3)]}
    payload, buffers = dumps(value)
    assert len(buffers) == len(tensors())  # every tensor rides out of band
    assert sum(b.raw().nbytes for b in buffers) > len(payload)
    back = loads(payload, [bytearray(b.raw()) for b in buffers])
    for key, t in tensors().items():
        got = back["nested"][0][key]
        assert got.dtype == t.dtype and got.shape == t.shape
        assert torch.equal(got, t), key
    assert back["nested"][1] == ("x", 3)


def test_device_tensor_refused_at_the_frame():
    with pytest.raises(SerializationError, match="stage it to the host"):
        dumps({"w": torch.empty(4, device="meta")})


async def test_frames_over_a_socket():
    received = []

    async def handle(reader, writer):
        received.append(await read_message(reader))
        writer.close()

    server = await asyncio.start_server(handle, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    with anyio.fail_after(30):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        big = torch.arange(3 << 20, dtype=torch.float32)  # > one write chunk
        await write_message(writer, 1, {"big": big})
        writer.close()
        while not received:
            await asyncio.sleep(0.01)
    server.close()
    kind, msg = received[0]
    assert kind == 1 and torch.equal(msg["big"], big)


async def test_remote_errors_reach_the_caller():
    with anyio.fail_after(120):
        mesh = await spawn_actors(1, StorageVolume, "tst_rt_volume", SingletonStrategy())
        try:
            (ref,) = mesh.refs
            info = await ref.get_id.call_one()
            assert info["volume_id"] == "0"
            assert info["pid"] in [p.pid for p in multiprocessing.active_children()]
            # An endpoint that raises: the original exception comes back.
            buffer = RPCTransportBuffer()
            with pytest.raises(KeyError, match="not found") as exc:
                await ref.get.call_one(buffer, [Request(key="missing")])
            assert isinstance(exc.value.__cause__, RemoteActorError)
            # Not an endpoint: refused remotely.
            with pytest.raises(RemoteActorError, match="not an @endpoint"):
                await ref.on_stop.call_one()
            assert await ref.control("ping") == "pong"
        finally:
            await mesh.stop()
        with pytest.raises(ActorDiedError):
            await ref.get_id.call_one()


def test_concurrent_first_calls_share_one_connection():
    """Calls that open a connection to one address at once share it: each
    opening its own would replace the others' in the pool and leave their
    reader tasks pending when they are dropped."""
    async def go():
        accepted = []

        async def handle(reader, writer):
            accepted.append(writer)

        server = await asyncio.start_server(handle, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        try:
            conns = await asyncio.gather(*(actors.get_connection("127.0.0.1", port)
                                           for _ in range(8)))
            await asyncio.sleep(0.05)
            opened = len(accepted)
            for conn in set(conns):
                await conn.close()
            return len({id(c) for c in conns}), opened
        finally:
            for writer in accepted:
                writer.close()
            server.close()
            await server.wait_closed()

    assert asyncio.run(go()) == (1, 1)


# ---- the cases of tests/test_runtime.py ---------------------------------------


class EchoActor(Actor):
    def __init__(self, scale: float = 1.0):
        self.scale = scale
        self.state = {}

    @endpoint
    async def echo(self, x):
        return x

    @endpoint
    def scale_tensor(self, t: torch.Tensor) -> torch.Tensor:
        return t * self.scale

    @endpoint
    async def my_rank(self):
        return int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])

    @endpoint
    async def put(self, k, v):
        self.state[k] = v

    @endpoint
    async def get(self, k):
        return self.state[k]

    @endpoint
    async def boom(self):
        raise KeyError("kaboom")

    def not_an_endpoint(self):
        return "secret"

    @endpoint
    async def peer_get(self, ref, k):
        # Actor to actor: refs work inside actor processes.
        return await ref.get.call_one(k)

    @endpoint
    async def env(self, prefix: str) -> dict:
        return {k: v for k, v in os.environ.items() if k.startswith(prefix)}

    @endpoint
    async def cuda_state(self) -> dict:
        import multiprocessing as mp

        return {"initialized": torch.cuda.is_initialized(),
                "start": mp.get_start_method(allow_none=True)}


class _ExplodingActor(Actor):
    def __init__(self):
        raise RuntimeError("bad init")


@pytest.fixture
async def mesh():
    m = await spawn_actors(2, EchoActor, "tst_echo", scale=3.0)
    yield m
    await m.stop()


async def test_call_one_roundtrip(mesh):
    assert await mesh.refs[0].echo.call_one({"a": [1, 2]}) == {"a": [1, 2]}
    assert await mesh.refs[0].echo.call(5) == 5  # call on one ref is call_one


async def test_fanout_and_rank_env(mesh):
    assert await mesh.my_rank.call() == [(0, 2), (1, 2)]


async def test_tensor_roundtrip(mesh):
    t = torch.arange(1_000_000, dtype=torch.float32).reshape(1000, 1000)
    out = await mesh.refs[1].scale_tensor.call_one(t)
    assert out.dtype == torch.float32 and torch.equal(out, t * 3.0)


async def test_state_persists_across_calls(mesh):
    await mesh.refs[0].put.call_one("k", torch.ones(4))
    assert torch.equal(await mesh.refs[0].get.call_one("k"), torch.ones(4))


async def test_remote_exception_type_preserved(mesh):
    with pytest.raises(KeyError, match="kaboom") as exc:
        await mesh.refs[0].boom.call_one()
    assert isinstance(exc.value.__cause__, RemoteActorError)
    assert "kaboom" in str(exc.value.__cause__)


async def test_non_endpoint_rejected(mesh):
    with pytest.raises(RemoteActorError, match="not an @endpoint"):
        await mesh.refs[0].not_an_endpoint.call_one()


async def test_missing_key_error(mesh):
    with pytest.raises(KeyError):
        await mesh.refs[0].get.call_one("missing")


async def test_actor_to_actor_calls(mesh):
    await mesh.refs[1].put.call_one("shared", 42)
    assert await mesh.refs[0].peer_get.call_one(mesh.refs[1], "shared") == 42


async def test_mesh_ref_pickles_without_processes(mesh):
    import pickle

    m2 = pickle.loads(pickle.dumps(mesh))
    assert isinstance(m2, ActorMeshRef) and m2._processes == []
    assert await m2.refs[0].echo.call_one(7) == 7


async def test_concurrent_calls_multiplexed(mesh):
    outs = await asyncio.gather(*(mesh.refs[0].echo.call_one(i) for i in range(50)))
    assert outs == list(range(50))


async def test_mesh_indexing(mesh):
    sub = mesh[1]
    assert len(sub) == 1 and len(mesh[0:2]) == 2
    assert await sub.my_rank.call_one() == (1, 2)
    assert await mesh[0:2].my_rank.call() == [(0, 2), (1, 2)]


async def test_call_one_on_multi_mesh_rejected(mesh):
    with pytest.raises(ValueError, match="mesh of size 2"):
        await mesh.my_rank.call_one()


async def test_controls_ping_and_list(mesh):
    assert await mesh.refs[0].ping()
    assert await mesh.refs[1].control("list") == ["tst_echo_1"]


async def test_singleton_registry():
    from torchstore_tpu_torch.runtime import get_or_spawn_singleton, stop_singleton

    ref1 = await get_or_spawn_singleton("tst_single", EchoActor, scale=2.0)
    ref2 = await get_or_spawn_singleton("tst_single", EchoActor, scale=9.0)
    assert ref1.port == ref2.port  # cached, not spawned again
    assert torch.equal(await ref1.scale_tensor.call_one(torch.ones(2)), torch.full((2,), 2.0))
    await stop_singleton("tst_single")


async def test_spawn_failure_surfaces():
    with pytest.raises(ActorDiedError, match="bad init"):
        await spawn_actors(1, _ExplodingActor, "tst_exploding")


async def test_inproc_actor_is_called_directly():
    from torchstore_tpu_torch.runtime.actors import (
        ActorRef,
        ActorServer,
        register_inproc,
        unregister_inproc,
    )

    actor = EchoActor(scale=5.0)
    server = ActorServer()
    server.register("tst_inproc", actor)
    port = await server.start()
    ref = ActorRef("tst_inproc", "127.0.0.1", port)
    register_inproc("127.0.0.1", port, "tst_inproc", actor)
    try:
        t = torch.ones(3)
        await ref.put.call_one("k", t)
        assert actor.state["k"] is t  # by reference: nothing was serialized
        assert await ref.scale_tensor.call_one(t) is not t
    finally:
        unregister_inproc("127.0.0.1", port, "tst_inproc")
    # Unregistered, the same ref goes over the server.
    got = await ref.get.call_one("k")
    assert torch.equal(got, torch.ones(3)) and got is not actor.state["k"]
    await actors.close_all_connections()
    await server.close()


async def test_forkserver_child_leaves_cuda_alone_and_sees_its_env(monkeypatch):
    """Children start from the forkserver (unless TORCHSTORE_TORCH_MP_CONTEXT
    says spawn), whose helper never initialized CUDA; a child sees the
    TORCHSTORE_TORCH_* env it was spawned with, not the helper's."""
    monkeypatch.setenv("TORCHSTORE_TORCH_TEST_PROBE", "first")
    m1 = await spawn_actors(1, EchoActor, "tst_env1")
    monkeypatch.setenv("TORCHSTORE_TORCH_TEST_PROBE", "second")
    monkeypatch.setenv("TORCHSTORE_TORCH_TEST_EXTRA", "x")
    m2 = await spawn_actors(1, EchoActor, "tst_env2")
    monkeypatch.delenv("TORCHSTORE_TORCH_TEST_PROBE")
    monkeypatch.delenv("TORCHSTORE_TORCH_TEST_EXTRA")
    m3 = await spawn_actors(1, EchoActor, "tst_env3")
    try:
        state = await m1.refs[0].cuda_state.call_one()
        assert state == {"initialized": False, "start": "forkserver"}
        probe = "TORCHSTORE_TORCH_TEST_"
        assert await m1.refs[0].env.call_one(probe) == {probe + "PROBE": "first"}
        assert await m2.refs[0].env.call_one(probe) == {probe + "PROBE": "second",
                                                        probe + "EXTRA": "x"}
        assert await m3.refs[0].env.call_one(probe) == {}
    finally:
        for m in (m1, m2, m3):
            await m.stop()


async def test_spawn_context_still_selectable(monkeypatch):
    monkeypatch.setenv("TORCHSTORE_TORCH_MP_CONTEXT", "spawn")
    m = await spawn_actors(1, EchoActor, "tst_spawned")
    try:
        assert (await m.refs[0].cuda_state.call_one())["start"] == "spawn"
    finally:
        await m.stop()
        monkeypatch.delenv("TORCHSTORE_TORCH_MP_CONTEXT")
        actors._mp_context()  # back to the forkserver for the tests after
