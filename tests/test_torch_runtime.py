"""The port's actor runtime: pickle-5 frames with out-of-band CPU tensors
(device tensors refused), and RPC to spawned actor processes with remote
errors re-raised in the caller."""

import asyncio
import multiprocessing

import anyio
import pytest
import torch

from torchstore_tpu_torch.runtime import ActorDiedError, RemoteActorError, spawn_actors
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
    from torchstore_tpu_torch.runtime import actors

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
