"""Port twin of tests/test_repair.py: ``repair()`` replaces dead volumes
with fresh processes under their ids, copies back every key a survivor
holds (the exact slices each dead volume held), reports unrecoverable keys
lost (reads then fail loudly as missing), and never replaces a wedged
volume.

Each scenario runs through both packages from one numpy seed (the JAX
store off shared memory, as tests/test_torch_replication.py runs it), and
the reports, the placements and the bytes read back are compared. Every
case that kills or stops a process runs under its own timeout; a stopped
process is continued in a ``finally``."""

import os
import signal
from dataclasses import dataclass
from typing import Any, Callable

import anyio
import numpy as np
import pytest
import torch

import torchstore_tpu as ts_ref
import torchstore_tpu_torch as tst
from torchstore_tpu.client import LocalClient as RefLocalClient
from torchstore_tpu.client import Shard as RefShard
from torchstore_tpu.controller import Controller as RefController
from torchstore_tpu.transport.types import Request as RefRequest
from torchstore_tpu.transport.types import TensorMeta as RefTensorMeta
from torchstore_tpu.transport.types import TensorSlice as RefTensorSlice
from torchstore_tpu_torch.client import LocalClient
from torchstore_tpu_torch.controller import Controller
from torchstore_tpu_torch.transport.types import Request, TensorMeta
from tests.test_torch_replication import (  # noqa: F401 - the autouse fixture
    kill_port,
    kill_ref,
    port_store,
    ref_store,
    reference_off_shared_memory,
    to_np,
    volume_process_port,
    volume_process_ref,
)

TIMEOUT_S = 90


@dataclass
class Pkg:
    """One package's side of a scenario."""

    mod: Any
    store: Callable
    kill: Callable
    process: Callable
    wrap: Callable
    shard: Callable
    tslice: Callable
    client_cls: type


PORT = Pkg(tst, port_store, kill_port, volume_process_port, torch.from_numpy,
           tst.Shard, tst.TensorSlice, LocalClient)
REF = Pkg(ts_ref, ref_store, kill_ref, volume_process_ref, lambda a: a,
          RefShard, RefTensorSlice, RefLocalClient)


async def both(scenario, *args, **store_kw) -> tuple:
    """``scenario(pkg, store_name, *args)`` on each package's own store."""
    out = []
    with anyio.fail_after(TIMEOUT_S):
        for pkg in (PORT, REF):
            async with pkg.store(**store_kw) as name:
                out.append(await scenario(pkg, name, *args))
    return tuple(out)


async def located(pkg: Pkg, name: str, keys: list) -> dict:
    got = await pkg.mod.client(name).controller.locate_volumes.call_one(keys)
    return {k: sorted(v) for k, v in got.items()}


async def _restores(pkg: Pkg, name: str, src: np.ndarray) -> dict:
    await pkg.mod.put("w", pkg.wrap(src), store_name=name)
    victim = (await located(pkg, name, ["w"]))["w"][0]
    await pkg.kill(name, victim)
    report = await pkg.mod.repair(store_name=name)
    after = (await located(pkg, name, ["w"]))["w"]
    got = to_np(await pkg.mod.get("w", store_name=name))
    # The repaired copy carries the data past the other original's death.
    other = next(v for v in after if v != victim)
    await pkg.kill(name, other)
    again = to_np(await pkg.mod.get("w", store_name=name))
    return {"victim": victim, "report": report, "located": after,
            "got": got.tolist(), "again": again.tolist()}


async def test_repair_restores_replication():
    src = np.random.default_rng(0).random(64, dtype=np.float32)
    port, ref = await both(_restores, src)
    assert port == ref
    assert port["report"]["replaced"] == [port["victim"]]
    assert port["report"]["rereplicated"] == 1 and port["report"]["lost"] == []
    assert len(port["located"]) == 2 and port["victim"] in port["located"]
    assert port["got"] == port["again"] == src.tolist()


async def _lost(pkg: Pkg, name: str) -> dict:
    await pkg.mod.put("only", pkg.wrap(np.ones(4)), store_name=name)
    (vid,) = (await located(pkg, name, ["only"]))["only"]
    await pkg.kill(name, vid)
    report = await pkg.mod.repair(store_name=name)
    with pytest.raises(KeyError):
        await pkg.mod.get("only", store_name=name)
    # The replacement serves new writes under the old volume id.
    await pkg.mod.put("fresh", pkg.wrap(np.full(2, 7.0)), store_name=name)
    return {"vid": vid, "report": report,
            "fresh": to_np(await pkg.mod.get("fresh", store_name=name)).tolist(),
            "fresh_on": (await located(pkg, name, ["fresh"]))["fresh"]}


async def test_repair_reports_lost_keys():
    port, ref = await both(_lost, num=2, replication=1)
    assert port == ref
    assert port["report"]["replaced"] == [port["vid"]] and port["report"]["lost"] == ["only"]
    assert port["fresh"] == [7.0, 7.0]


async def _shards(pkg: Pkg, name: str, full: np.ndarray) -> dict:
    for row in range(full.shape[0]):
        sl = pkg.tslice(offsets=(row, 0), local_shape=(1, 8), global_shape=(3, 8),
                        coordinates=(row,), mesh_shape=(3,))
        await pkg.mod.put("sh", pkg.shard(pkg.wrap(full[row:row + 1].copy()), sl),
                          store_name=name)
    victim = (await located(pkg, name, ["sh"]))["sh"][0]
    await pkg.kill(name, victim)
    report = await pkg.mod.repair(store_name=name)
    infos = await pkg.mod.client(name).controller.locate_volumes.call_one(["sh"])
    return {"victim": victim, "report": report,
            "got": to_np(await pkg.mod.get("sh", store_name=name)).tolist(),
            "coords": {v: sorted(i.tensor_slices) for v, i in infos["sh"].items()}}


async def test_repair_rereplicates_shards():
    full = np.arange(24.0, dtype=np.float32).reshape(3, 8)
    port, ref = await both(_shards, full)
    assert port == ref
    assert port["report"]["replaced"] == [port["victim"]] and port["report"]["lost"] == []
    assert port["got"] == full.tolist() and port["victim"] in port["coords"]


async def _stale_client(pkg: Pkg, name: str, src: np.ndarray) -> dict:
    await pkg.mod.put("w", pkg.wrap(src), store_name=name)
    owner = pkg.mod.client(name)
    stale = pkg.client_cls(owner.controller, owner._config)
    np.testing.assert_array_equal(to_np(await stale.get("w")), src)
    for vid in (await located(pkg, name, ["w"]))["w"]:
        await pkg.kill(name, vid)
    report = await pkg.mod.repair(store_name=name)
    await pkg.mod.put("w2", pkg.wrap(src), store_name=name)
    # The stale client holds the dead volumes' refs: one get must diagnose,
    # find the refs replaced, reload them and serve.
    return {"report": report, "got": to_np(await stale.get("w2")).tolist()}


async def test_stale_client_self_heals_after_repair():
    src = np.random.default_rng(1).random(32, dtype=np.float32)
    port, ref = await both(_stale_client, src)
    assert port == ref
    assert port["report"]["lost"] == ["w"] and port["got"] == src.tolist()


async def _noop(pkg: Pkg, name: str) -> dict:
    await pkg.mod.put("k", pkg.wrap(np.ones(2)), store_name=name)
    return await pkg.mod.repair(store_name=name)


async def test_repair_noop_when_healthy():
    port, ref = await both(_noop)
    assert port == ref == {"replaced": [], "rereplicated": 0, "lost": [], "failed": [],
                           "wedged": []}


async def _double(pkg: Pkg, name: str) -> dict:
    await pkg.mod.put("k", pkg.wrap(np.ones(4)), store_name=name)
    replicas = (await located(pkg, name, ["k"]))["k"]
    for vid in replicas:
        await pkg.kill(name, vid)
    report = await pkg.mod.repair(store_name=name)
    with pytest.raises(KeyError):
        await pkg.mod.get("k", store_name=name)
    await pkg.mod.put("k2", pkg.wrap(np.full(2, 3.0)), store_name=name)
    return {"replicas": replicas, "report": {**report, "replaced": sorted(report["replaced"])},
            "k2": to_np(await pkg.mod.get("k2", store_name=name)).tolist()}


async def test_repair_survives_double_volume_death():
    port, ref = await both(_double)
    assert port == ref
    assert port["report"]["replaced"] == port["replicas"]
    assert port["report"]["lost"] == ["k"] and port["report"]["failed"] == []
    assert port["k2"] == [3.0, 3.0]


def _shard_meta(request_cls, meta_cls, slice_cls, coord):
    sl = slice_cls(offsets=(coord, 0), local_shape=(1, 4), global_shape=(2, 4),
                   coordinates=(coord,), mesh_shape=(2,))
    req = request_cls.from_tensor_slice("k", sl)
    req.tensor_meta = meta_cls(shape=(1, 4), dtype="float32")
    return req.meta_only()


@pytest.mark.parametrize("pkg", [(Controller, Request, TensorMeta, tst.TensorSlice),
                                 (RefController, RefRequest, RefTensorMeta, RefTensorSlice)],
                         ids=["port", "reference"])
async def test_detach_is_shard_granular(pkg):
    """A degraded put's detach drops only the failed shard's coordinates:
    the other rank's shard on the same volume stays."""
    controller_cls, request_cls, meta_cls, slice_cls = pkg
    c = controller_cls()

    def meta(coord):
        return _shard_meta(request_cls, meta_cls, slice_cls, coord)

    await c.notify_put_batch([meta(0)], "1")
    await c.notify_put_batch([meta(1)], "1")
    assert await c.contains("k") == "committed"
    await c.notify_put_batch([meta(0)], ["0"], detach_volume_ids=["1"])
    got = await c.locate_volumes(["k"])
    assert set(got["k"]) == {"0", "1"}
    assert list(got["k"]["1"].tensor_slices) == [(1,)]
    assert list(got["k"]["0"].tensor_slices) == [(0,)]
    for task in list(c._reclaim_tasks):
        task.cancel()


async def test_repair_requires_owner():
    for mod in (tst, ts_ref):
        with pytest.raises(RuntimeError, match="initialized"):
            await mod.repair(store_name="never-made")


async def _wedged(pkg: Pkg, name: str) -> dict:
    await pkg.mod.put("k", pkg.wrap(np.ones(4)), store_name=name)
    proc = await pkg.process(name, "0")
    os.kill(proc.pid, signal.SIGSTOP)
    try:
        report = await pkg.mod.repair(store_name=name)
    finally:
        os.kill(proc.pid, signal.SIGCONT)
    return {"report": report, "got": to_np(await pkg.mod.get("k", store_name=name)).tolist()}


async def test_wedged_volume_reported_not_replaced():
    port, ref = await both(_wedged)
    assert port == ref
    assert port["report"]["wedged"] == ["0"] and port["report"]["replaced"] == []
    assert port["got"] == [1.0] * 4


async def _soak(pkg: Pkg, name: str, working_set: dict) -> list:
    for key, arr in working_set.items():
        await pkg.mod.put(key, pkg.wrap(arr), store_name=name)
    client = pkg.mod.client(name)
    reports = []
    for cycle in range(3):
        vmap = await client.controller.get_volume_map.call_one()
        victim = sorted(vmap)[cycle % len(vmap)]
        await pkg.kill(name, victim)
        report = await pkg.mod.repair(store_name=name)
        assert report["replaced"] == [victim], (cycle, report)
        assert report["lost"] == [] and report["failed"] == [], (cycle, report)
        for key, arr in working_set.items():
            np.testing.assert_array_equal(to_np(await pkg.mod.get(key, store_name=name)), arr)
        reports.append(report)
    statuses = await client.controller.check_volumes.call_one()
    assert all(s == "ok" for s in statuses.values()), statuses
    return reports


async def test_kill_repair_soak():
    """Three kill -> repair cycles on a replicated working set: the data
    survives every cycle and the fleet ends healthy."""
    rng = np.random.default_rng(2)
    working_set = {f"w{i}": rng.random(32, dtype=np.float32) for i in range(4)}
    port, ref = await both(_soak, working_set)
    assert port == ref
