"""Connection auth: the HMAC challenge of tests/test_auth.py on the port's
listeners. The challenge itself against the JAX package's (the same bytes on
the wire: a port client passes a JAX server's challenge and the reverse),
the store's round trip over the shm and rpc rungs with a secret set, and a
rogue connection closed before any frame is parsed, on both of the port's
listeners (the actor server, and the direct-sync source's server)."""

import asyncio
import os

import pytest
import torch

import torchstore_tpu_torch as ts
from torchstore_tpu.runtime import auth as ref_auth
from torchstore_tpu_torch import api
from torchstore_tpu_torch import config as config_mod
from torchstore_tpu_torch.config import ENV_AUTH_SECRET, StoreConfig
from torchstore_tpu_torch.runtime import auth
from torchstore_tpu_torch.state_dict_utils import _direct_cache

SECRET = "port-secret-123"


@pytest.fixture
def secret_env():
    """A process-wide secret for one test's store, restored after."""
    old = os.environ.get(ENV_AUTH_SECRET)
    os.environ[ENV_AUTH_SECRET] = SECRET
    config_mod._default_config = None
    yield SECRET
    if old is None:
        os.environ.pop(ENV_AUTH_SECRET, None)
    else:
        os.environ[ENV_AUTH_SECRET] = old
    config_mod._default_config = None


async def serve_once(secret, server_auth=auth.server_authenticate):
    accepted = asyncio.get_running_loop().create_future()

    async def handle(reader, writer):
        ok = await server_auth(reader, writer, secret)
        if not accepted.done():
            accepted.set_result(ok)
        if ok:
            writer.write(b"WELCOME!")
            await writer.drain()
        writer.close()

    server = await asyncio.start_server(handle, "127.0.0.1", 0)
    return server, server.sockets[0].getsockname()[1], accepted


@pytest.mark.parametrize("client_auth,server_auth", [
    (auth.client_authenticate, auth.server_authenticate),
    (auth.client_authenticate, ref_auth.server_authenticate),
    (ref_auth.client_authenticate, auth.server_authenticate),
], ids=["port-port", "port-client-jax-server", "jax-client-port-server"])
async def test_right_secret_accepted(client_auth, server_auth):
    server, port, accepted = await serve_once("s3cret", server_auth)
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    await client_auth(reader, writer, "s3cret")
    assert await reader.readexactly(8) == b"WELCOME!"
    assert await accepted is True
    writer.close()
    server.close()


async def test_wire_constants_equal_reference():
    assert (auth.AUTH_MAGIC, auth.NONCE_LEN, auth.MAC_LEN) == (
        ref_auth.AUTH_MAGIC, ref_auth.NONCE_LEN, ref_auth.MAC_LEN)
    nonce = bytes(range(16))
    assert auth.compute_mac("k", nonce) == ref_auth.compute_mac("k", nonce)


async def test_wrong_secret_rejected():
    server, port, accepted = await serve_once("s3cret")
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    await auth.client_authenticate(reader, writer, "WRONG")
    assert await accepted is False
    assert await reader.read(8) == b""  # closed, nothing served
    writer.close()
    server.close()


async def test_no_auth_client_rejected():
    server, port, accepted = await serve_once("s3cret")
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    # A client unaware of auth writes a frame; it is read as a wrong MAC.
    writer.write(b"\x00" * 64)
    await writer.drain()
    assert await accepted is False
    writer.close()
    server.close()


async def test_secret_client_plain_server_fails_loudly():
    async def handle(reader, writer):
        await asyncio.sleep(0.2)
        writer.write(b"\x01" * 20)  # not a challenge
        await writer.drain()

    server = await asyncio.start_server(handle, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    with pytest.raises(ConnectionError, match="did not issue a challenge"):
        await auth.client_authenticate(reader, writer, "s3cret")
    writer.close()
    server.close()


async def test_disabled_is_zero_overhead():
    server, port, accepted = await serve_once(None)
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    await auth.client_authenticate(reader, writer, None)
    assert await reader.readexactly(8) == b"WELCOME!"
    writer.close()
    server.close()


@pytest.mark.parametrize("transport", ["shm", "rpc"])
async def test_store_roundtrip_with_auth(secret_env, transport):
    await ts.initialize(
        store_name="tst_auth",
        strategy=ts.SingletonStrategy(default_transport_type=transport),
        config=StoreConfig(auth_secret=secret_env),
    )
    try:
        x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
        await ts.put("k", x, store_name="tst_auth")
        assert torch.equal(await ts.get("k", store_name="tst_auth"), x)
        await ts.put("obj", {"step": 3}, store_name="tst_auth")
        assert await ts.get("obj", store_name="tst_auth") == {"step": 3}
    finally:
        await ts.shutdown("tst_auth")


async def assert_rogue_closed(host: str, port: int) -> None:
    """A peer with the wrong secret answers the challenge with a bad MAC:
    the server closes before it parses a frame."""
    reader, writer = await asyncio.open_connection(host, port)
    await auth.client_authenticate(reader, writer, "wrong-secret")
    writer.write(b"\x00" * 64)  # a would-be frame, never parsed
    assert await asyncio.wait_for(reader.read(16), 10) == b""
    writer.close()


async def test_rogue_connection_to_actor_servers_rejected(secret_env):
    await ts.initialize(store_name="tst_auth2", config=StoreConfig(auth_secret=secret_env))
    try:
        client = ts.client("tst_auth2")
        await client._ensure_setup()
        controller = api._stores["tst_auth2"].controller
        (volume,) = client._volume_refs.values()
        await assert_rogue_closed(controller.host, controller.port)
        await assert_rogue_closed(volume.actor.host, volume.actor.port)
        # Authenticated clients are still served.
        await ts.put("ok", torch.ones(8), store_name="tst_auth2")
        assert torch.equal(await ts.get("ok", store_name="tst_auth2"), torch.ones(8))
    finally:
        await ts.shutdown("tst_auth2")


async def test_rogue_connection_to_direct_sync_source_rejected(secret_env):
    await ts.initialize(store_name="tst_auth3", config=StoreConfig(auth_secret=secret_env))
    try:
        sd = {"w": torch.arange(64, dtype=torch.float32), "b": torch.ones(4)}
        await ts.put_state_dict("policy", sd, direct=True, store_name="tst_auth3")
        source = _direct_cache(ts.client("tst_auth3")).sources[("policy", 0)]
        await assert_rogue_closed("127.0.0.1", source.server.port)
        # The dest passes the challenge and pulls.
        dest = {"w": torch.zeros(64), "b": torch.zeros(4)}
        await ts.get_state_dict("policy", dest, direct=True, store_name="tst_auth3")
        assert torch.equal(dest["w"], sd["w"]) and torch.equal(dest["b"], sd["b"])
    finally:
        await ts.shutdown("tst_auth3")


async def test_second_store_with_another_secret_refused(secret_env):
    await ts.initialize(store_name="tst_auth4", config=StoreConfig(auth_secret=secret_env))
    try:
        with pytest.raises(ValueError, match="per-process"):
            await ts.initialize(store_name="tst_auth5",
                                config=StoreConfig(auth_secret="another"))
        assert "tst_auth5" not in api._stores
    finally:
        await ts.shutdown("tst_auth4")
