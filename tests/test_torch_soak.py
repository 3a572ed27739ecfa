"""Port twin of tests/test_soak.py: repeated put / get / delete churn must
grow neither file descriptors, nor this store's shared-memory segments,
nor the connection pool; the conditional reclaims converge through cycles
of a wedged replica; connections of closed event loops are pruned.

The segment count is the store's own: ``tst_shm_`` segments whose name
carries the pid of one of its volumes or of this process
(``transport/shared_memory.owner_pid``), never every segment on the
machine, so other stores running beside it (``pytest -n``) do not move it.
Each case runs under its own time limit."""

import asyncio
import os
import signal
import threading

import torch

import torchstore_tpu_torch as tst
from torchstore_tpu_torch.runtime.actors import _conn_pools
from torchstore_tpu_torch.transport.shared_memory import SHM_DIR, owner_pid

CASE_S = 60.0
WEDGE_CASE_S = 150.0  # the reference's case takes about 68 s on a CPU


def _fd_count() -> int:
    return len(os.listdir("/proc/self/fd"))


def _volume_processes(store_name: str) -> list:
    from torchstore_tpu_torch import api

    return list(api._stores[store_name].volume_mesh._processes)


def _own_segments(pids: set) -> int:
    return sum(1 for n in os.listdir(SHM_DIR)
               if n.startswith("tst_shm_") and owner_pid(n) in pids)


async def test_churn_leaves_no_residue():
    name = "tst_soak"
    await tst.initialize(store_name=name)

    async def body():
        pids = {p.pid for p in _volume_processes(name)} | {os.getpid()}
        x = torch.rand(256, 256, generator=torch.Generator().manual_seed(0))
        # Warm: caches, connections and segments reach their steady state
        # (a key's segments rotate put -> retire -> release -> pool about
        # three deep, so each of the two keys gets enough rounds).
        for i in range(10):
            await tst.put(f"k{i % 2}", x, store_name=name)
            await tst.get(f"k{i % 2}", store_name=name)
        fds0, shm0 = _fd_count(), _own_segments(pids)
        for i in range(50):
            key = f"k{i % 2}"
            await tst.put(key, x, store_name=name)
            out = await tst.get(key, store_name=name)
            assert out[0, 0] == x[0, 0]
            if i % 10 == 9:
                await tst.delete(key, store_name=name)
        fds1, shm1 = _fd_count(), _own_segments(pids)
        assert fds1 <= fds0 + 4, (fds0, fds1)
        assert shm1 <= shm0 + 2, (shm0, shm1)
        assert len(_conn_pools) <= 4, len(_conn_pools)

    try:
        await asyncio.wait_for(body(), CASE_S)
    finally:
        await tst.shutdown(name)


async def test_reclaim_churn_converges_under_wedge_cycles(monkeypatch):
    """Wedge a replica (SIGSTOP) through overwrites and continue it, three
    times. After every cycle each acknowledged value reads back (never the
    overwritten one); then the reclaim queue drains completely, and a last
    overwrite lands on both volumes again."""
    # A short reclaim backoff, inherited by the controller process, so the
    # drain converges within the case (the default is 1, 5, 15, 60).
    monkeypatch.setenv("TORCHSTORE_TORCH_RECLAIM_DELAYS", "0.5,1,2,4,8")
    name = "tst_rsoak"
    await tst.initialize(num_storage_volumes=2, store_name=name,
                         strategy=tst.LocalRankStrategy(replication=2),
                         config=tst.StoreConfig(rpc_timeout=2.0))
    stopped: list[int] = []

    async def body():
        from torchstore_tpu_torch import api

        client = tst.client(name)
        vmap = await client.controller.get_volume_map.call_one()
        target = vmap["1"]["ref"]
        mesh = api._stores[name].volume_mesh
        proc = next(p for r, p in zip(mesh.refs, mesh._processes)
                    if (r.host, r.port, r.name) == (target.host, target.port, target.name))
        keys = [f"w{i}" for i in range(3)]
        version = 0.0
        for key in keys:
            version += 1.0
            await tst.put(key, torch.full((64,), version), store_name=name)
        for cycle in range(3):
            os.kill(proc.pid, signal.SIGSTOP)
            stopped.append(proc.pid)
            version += 1.0
            for key in keys:  # degraded overwrites: detach, then reclaim
                await tst.put(key, torch.full((64,), version), store_name=name)
            os.kill(proc.pid, signal.SIGCONT)
            stopped.clear()
            for key in keys:
                out = await tst.get(key, store_name=name)
                assert out[0] == version, (cycle, key, out[0], version)
        loop = asyncio.get_running_loop()
        deadline = loop.time() + 30
        while True:
            stats = await client.controller.stats.call_one()
            if not stats.get("pending_reclaims"):
                break
            assert loop.time() < deadline, stats
            await asyncio.sleep(0.5)
        for key in keys:
            await tst.put(key, torch.full((64,), 99.0), store_name=name)
            out = await tst.get(key, store_name=name)
            assert out[0] == 99.0
        located = await client.controller.locate_volumes.call_one(keys)
        for key in keys:
            assert len(located[key]) == 2, located  # redundancy restored

    try:
        await asyncio.wait_for(body(), WEDGE_CASE_S)
    finally:
        for pid in stopped:
            try:
                os.kill(pid, signal.SIGCONT)
            except ProcessLookupError:
                pass
        await tst.shutdown(name)


async def test_many_loops_prune_connection_pool():
    """Each ``asyncio.run`` makes a loop; the pooled connections of loops
    that closed are pruned by the next get, not accumulated."""
    name = "tst_loops"
    await tst.initialize(store_name=name)

    async def body():
        await tst.put("k", torch.ones(4), store_name=name)

        def one_shot():
            async def go():
                out = await tst.get("k", store_name=name)
                assert out[0] == 1.0

            asyncio.run(go())

        for _ in range(8):
            t = threading.Thread(target=one_shot)
            t.start()
            t.join()
        await tst.get("k", store_name=name)  # prunes from this loop
        stale = [k for k, (pool_loop, _) in _conn_pools.items() if pool_loop.is_closed()]
        assert not stale, stale

    try:
        await asyncio.wait_for(body(), CASE_S)
    finally:
        await tst.shutdown(name)
