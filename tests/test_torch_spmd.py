"""The port's SPMD bootstrap against the JAX package's: SPMDEnv parsed and
validated from the same env dicts, the rendezvous KV through both
packages' servers and clients, and test_spmd_full_lifecycle's four cases
(1 host x 2 ranks, 1 x 4, 2 x 2, 2 x 2 with auth), every rank's reads held
against what the JAX package's ranks read. test_spmd_durable_recovery's
world writes into durable volumes, crashes, and a fresh world over the same
directory recovers every rank's key (``storage_dir`` / ``recover``)."""

import asyncio
import json
import multiprocessing as mp
import os
import socket
import traceback

import numpy as np
import pytest

from torchstore_tpu.runtime import rendezvous as ref_rdv
from torchstore_tpu.spmd import SPMDEnv as RefSPMDEnv
from torchstore_tpu_torch import faults
from torchstore_tpu_torch.runtime import rendezvous as port_rdv
from torchstore_tpu_torch.spmd import SPMDEnv

import test_torch_sp_worker as worker

BASE = {"RANK": "1", "WORLD_SIZE": "4", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "4",
        "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "29500"}
ENVS = {
    "parse": BASE,
    "multi_host": {**BASE, "RANK": "5", "WORLD_SIZE": "8", "LOCAL_RANK": "1"},
    "missing": {k: v for k, v in BASE.items() if k not in ("RANK", "MASTER_ADDR")},
    "rank_out_of_range": {**BASE, "RANK": "4"},
    "world_not_divisible": {**BASE, "WORLD_SIZE": "6", "RANK": "0", "LOCAL_RANK": "0"},
    "local_rank_out_of_range": {**BASE, "LOCAL_RANK": "4"},
    "defaults": {k: v for k, v in BASE.items() if k not in ("LOCAL_RANK", "LOCAL_WORLD_SIZE")},
}
SPMD_KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _parse(cls, env: dict, monkeypatch):
    for k in SPMD_KEYS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    try:
        e = cls.from_env()
    except Exception as exc:  # noqa: BLE001 - compared between the packages
        return type(exc).__name__, str(exc)
    return (e.rank, e.world_size, e.local_rank, e.local_world_size, e.master_addr,
            e.master_port, e.num_hosts, e.host_rank)


@pytest.mark.parametrize("case", sorted(ENVS))
def test_spmd_env_equals_reference(case, monkeypatch):
    port = _parse(SPMDEnv, ENVS[case], monkeypatch)
    ref = _parse(RefSPMDEnv, ENVS[case], monkeypatch)
    assert port == ref
    if case == "parse":
        assert port[:2] == (1, 4) and port[6:] == (1, 0)
    if case == "multi_host":
        assert port[6:] == (2, 1)
    if case == "missing":
        assert port[0] == "RuntimeError" and "missing" in port[1]


async def _kv_ops(server_cls, client_cls) -> list:
    server = server_cls()
    port = await server.start("127.0.0.1", 0)
    a, b = client_cls("127.0.0.1", port), client_cls("127.0.0.1", port)
    await a.connect()
    await b.connect()
    out = []
    try:
        get_task = asyncio.ensure_future(b.get("k"))
        await asyncio.sleep(0.05)
        out.append(get_task.done())
        await a.set("k", {"v": 1})
        out.append(await get_task)
        out.append(await a.add("c", 2))
        out.append(await b.add("c", 3))
        out.append(await a.wait_counter("c", 5))
        out.append((await b.check("k"), await b.check("nope")))
        await asyncio.gather(a.barrier("x", 2), b.barrier("x", 2))
        out.append(server.counters.get("barrier/x"))
        with pytest.raises(RuntimeError, match="unknown rendezvous op"):
            await a._request("nope")
        out.append(client_cls is port_rdv.RendezvousClient or True)
    finally:
        await a.close()
        await b.close()
        await server.stop()
    return out


def test_rendezvous_kv_equals_reference():
    ref = asyncio.run(_kv_ops(ref_rdv.RendezvousServer, ref_rdv.RendezvousClient))
    port = asyncio.run(_kv_ops(port_rdv.RendezvousServer, port_rdv.RendezvousClient))
    assert port == ref
    assert port[:6] == [False, {"v": 1}, 2, 5, 5, (True, False)]
    handle = {"host": "127.0.0.2", "port": 5}
    assert port_rdv.unpickle_handle(port_rdv.pickle_handle(handle)) == handle


async def _auth_and_fault_case() -> dict:
    from torchstore_tpu_torch import config as port_config

    out = {}
    server = port_rdv.RendezvousServer()
    port = await server.start("127.0.0.1", 0)
    try:
        # A raw connection that skips the MAC is closed before a frame parses.
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        hello = await asyncio.wait_for(reader.readexactly(20), 10)
        writer.write(b"\x00" * 64)
        await writer.drain()
        out["rogue_closed"] = hello[:4] == b"TSAU" and await reader.read(16) == b""
        writer.close()
        client = port_rdv.RendezvousClient("127.0.0.1", port)
        await client.connect()
        faults.arm("rendezvous.dispatch", "raise", count=1)
        with pytest.raises(RuntimeError, match="injected fault"):
            await client.set("k", 1)
        await client.set("k", 2)
        out["after_fault"] = await client.get("k")
        await client.close()
    finally:
        faults.disarm()
        await server.stop()
        port_config._default_config = None
    return out


def test_rendezvous_takes_auth_and_its_fault_point(monkeypatch):
    from torchstore_tpu_torch import config as port_config

    monkeypatch.setenv(port_config.ENV_AUTH_SECRET, "rdv-secret")
    monkeypatch.setattr(port_config, "_default_config", None)
    out = asyncio.run(_auth_and_fault_case())
    assert out == {"rogue_closed": True, "after_fault": 2}


async def _stalled_challenge_case() -> dict:
    from torchstore_tpu_torch import config as port_config

    server = port_rdv.RendezvousServer()
    handle, stalled = server._handle, []

    async def busy_first(reader, writer):
        # Rank 0's loop busy past the client's auth timeout, once.
        if not stalled:
            stalled.append(True)
            await asyncio.sleep(0.6)
        await handle(reader, writer)

    server._handle = busy_first
    port = await server.start("127.0.0.1", 0)
    client = port_rdv.RendezvousClient("127.0.0.1", port)
    try:
        await client.connect(timeout=30.0)
        await client.set("k", 3)
        return {"stalled": stalled, "value": await client.get("k")}
    finally:
        await client.close()
        await server.stop()
        port_config._default_config = None


def test_rendezvous_client_retries_a_stalled_auth_challenge(monkeypatch):
    """A challenge that does not come within the auth timeout (rank 0's
    loop busy spawning its volumes) is retried inside the connect deadline,
    as a refused connection is, and the session works."""
    from torchstore_tpu_torch import config as port_config
    from torchstore_tpu_torch.runtime import auth

    monkeypatch.setenv(port_config.ENV_AUTH_SECRET, "rdv-secret")
    monkeypatch.setattr(port_config, "_default_config", None)
    monkeypatch.setattr(auth, "AUTH_TIMEOUT_S", 0.2)
    assert asyncio.run(_stalled_challenge_case()) == {"stalled": [True], "value": 3}


def test_durable_recovery_is_not_ported(monkeypatch):
    """Durable recovery is ported now (``test_spmd_durable_recovery``);
    what stays refused, as the JAX package refuses it, is ``recover``
    without a ``storage_dir``, before any rank starts a process."""
    import torchstore_tpu as ts_ref
    import torchstore_tpu_torch as tst

    for k, v in BASE.items():
        monkeypatch.setenv(k, v)
    for pkg in (tst, ts_ref):
        with pytest.raises(ValueError, match="recover=True requires storage_dir"):
            asyncio.run(pkg.initialize_spmd(store_name="tst_nodurable", recover=True))


def test_spmd_durable_recovery(tmp_path):
    world, storage = 2, str(tmp_path / "storage")
    wrote = worker.spmd_durable(world, storage, "write")
    assert [r["wrote"] for r in wrote] == list(range(world))
    for rank, res in enumerate(worker.spmd_durable(world, storage, "recover")):
        # As the JAX package's test reads: each rank's key, its rank's value.
        assert res["reads"] == [[float(other)] * 4 for other in range(world)], rank
        assert res["keys"] == [f"r{other}" for other in range(world)]
        assert res["children_left"] == []


# --------------------------------------------------------------------------
# the lifecycle: the JAX package's ranks (off shared memory) as the oracle
# --------------------------------------------------------------------------


def _ref_worker(rank: int, env: dict, result_dir: str) -> None:
    os.environ.update(env)
    result = {"rank": rank, "ok": False}
    try:
        import jax

        jax.config.update("jax_platforms", "cpu")
        result.update(asyncio.run(_ref_scenario(rank, int(env["WORLD_SIZE"]))))
        result["ok"] = True
    except Exception as exc:  # noqa: BLE001 - reported to the parent
        result["error"] = f"{exc!r}\n{traceback.format_exc()}"
    with open(os.path.join(result_dir, f"ref_rank_{rank}.json"), "w") as f:
        json.dump(result, f)


async def _ref_scenario(rank: int, world: int) -> dict:
    import torchstore_tpu as ts

    await ts.initialize_spmd(store_name="refspmd")
    g = np.arange(float(world * 4), dtype=np.float32).reshape(world, 4)
    sl = ts.TensorSlice(offsets=(rank, 0), local_shape=(1, 4), global_shape=(world, 4),
                        coordinates=(rank,), mesh_shape=(world,))
    await ts.put("g", ts.Shard(g[rank:rank + 1], sl), store_name="refspmd")
    await ts.put(f"r{rank}", np.full(2, float(rank)), store_name="refspmd")
    await ts.barrier("puts_done", store_name="refspmd")
    peer = await ts.get(f"r{(rank + 1) % world}", store_name="refspmd")
    full = await ts.get("g", store_name="refspmd")
    await ts.barrier("reads_done", store_name="refspmd")
    await ts.shutdown("refspmd")
    return {"peer": np.asarray(peer).tolist(), "full": np.asarray(full).tolist()}


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def reference_reads(tmp_path_factory):
    """What the JAX package's ranks read in a 2 hosts x 2 ranks world with
    auth (its largest lifecycle case), on its RPC and TCP rungs."""
    tmp = str(tmp_path_factory.mktemp("ref_spmd"))
    world, local_world, port = 4, 2, _free_port()
    ctx = mp.get_context("spawn")
    procs = []
    for r in range(world):
        env = {k.replace("TORCHSTORE_TORCH_", "TORCHSTORE_TPU_"): v
               for k, v in worker.spmd_env(r, world, local_world, port, "ref-secret").items()}
        env.update(TORCHSTORE_TPU_SHM_ENABLED="0", TORCHSTORE_TPU_META_STAMPED="0",
                   TORCHSTORE_TPU_ONE_SIDED="0", JAX_PLATFORMS="cpu")
        procs.append(ctx.Process(target=_ref_worker, args=(r, env, tmp), daemon=False))
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=180)
            assert not p.is_alive(), "reference spmd worker hung"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    results = []
    for r in range(world):
        res = json.load(open(os.path.join(tmp, f"ref_rank_{r}.json")))
        assert res["ok"], f"reference rank {r}: {res.get('error')}"
        results.append(res)
    return results


@pytest.mark.parametrize(
    "world,local_world,secret",
    [(2, 2, None), (4, 4, None), (4, 2, None), (4, 2, "spmd-secret")],
    ids=["1host-2rank", "1host-4rank", "2hosts-2ranks", "2hosts-auth"],
)
def test_spmd_full_lifecycle(world, local_world, secret, reference_reads):
    hosts = world // local_world
    results = worker.spmd_lifecycle(world, local_world, secret=secret, hostnames=hosts > 1)
    g = np.arange(float(world * 4), dtype=np.float32).reshape(world, 4)
    for rank, res in enumerate(results):
        other = (rank + 1) % world
        assert res["peer"] == [float(other)] * 2
        assert np.array_equal(np.array(res["full"], np.float32), g)
        if world == len(reference_reads):
            assert res["peer"] == reference_reads[rank]["peer"]
            assert res["full"] == reference_reads[rank]["full"]
        assert res["children_left"] == []
        if hosts > 1:
            # The peer and half of the shards live on the other host.
            assert res["bulk_gets"] >= 2, res
        else:
            assert res["bulk_gets"] == 0
