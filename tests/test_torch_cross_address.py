"""The port with nothing listening on 127.0.0.1, against the JAX package:
test_cross_address_fleet's store A (controller, volume and bulk listener)
bound to 127.0.0.2 and forced onto bulk, store B on 127.0.0.3 on the
default ladder, one client talking to both, with the trace id of a put
crossing to another process. Both packages run the same seeded values (the
JAX package off shared memory); the port's run also lists every TCP
listener its processes hold, and a direct-sync source's listener and its
dial address follow the bind address. The mirror legs of the reference
file belong to the one-sided planes, which are not ported."""

import asyncio
import contextlib
import json
import multiprocessing
import os
import uuid

import numpy as np
import pytest
import torch

import torchstore_tpu as ts_ref
import torchstore_tpu_torch as tst
from torchstore_tpu import config as ref_config
from torchstore_tpu.config import StoreConfig as RefStoreConfig
from torchstore_tpu.transport import shared_memory as ref_shm
from torchstore_tpu_torch.observability import tracing
from torchstore_tpu_torch.transport.bulk import BulkClientCache

ADDR_A, ADDR_B = "127.0.0.2", "127.0.0.3"


def values() -> dict:
    return {"small": np.arange(256, dtype=np.float32),
            "bulk": np.random.default_rng(0).standard_normal((512, 1024)).astype(np.float32)}


def tcp_listeners(pids) -> set:
    """The (ip, port) of every listening IPv4 TCP socket the processes hold."""
    inodes = set()
    for pid in pids:
        try:
            for fd in os.listdir(f"/proc/{pid}/fd"):
                try:
                    link = os.readlink(f"/proc/{pid}/fd/{fd}")
                except OSError:
                    continue
                if link.startswith("socket:["):
                    inodes.add(link[8:-1])
        except OSError:
            continue
    out = set()
    with open("/proc/net/tcp") as f:
        next(f)
        for line in f:
            parts = line.split()
            local, state, inode = parts[1], parts[3], parts[9]
            if state != "0A" or inode not in inodes:  # 0A: LISTEN
                continue
            ip_hex, port_hex = local.split(":")
            ip = ".".join(str(int(ip_hex[i:i + 2], 16)) for i in (6, 4, 2, 0))
            out.add((ip, int(port_hex, 16)))
    return out


@contextlib.contextmanager
def reference_off_shm():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_config, "_default_config", None)
        mp.setattr(ref_shm, "is_available", lambda: False)
        mp.setenv("TORCHSTORE_TPU_META_STAMPED", "0")
        mp.setenv("TORCHSTORE_TPU_ONE_SIDED", "0")
        yield mp, RefStoreConfig(shm_enabled=False)


async def reference_fleet() -> dict:
    v = values()
    a, b = f"ref_xa_{uuid.uuid4().hex[:6]}", f"ref_xb_{uuid.uuid4().hex[:6]}"
    out = {}
    with reference_off_shm() as (mp, config):
        mp.setenv("TORCHSTORE_TPU_BIND_HOST", ADDR_A)
        await ts_ref.initialize(store_name=a, config=config,
                                strategy=ts_ref.SingletonStrategy(default_transport_type="bulk"))
        mp.setenv("TORCHSTORE_TPU_BIND_HOST", ADDR_B)
        await ts_ref.initialize(store_name=b, config=config)
        try:
            for store in (a, b):
                c = ts_ref.client(store)
                vmap = await c.controller.get_volume_map.call_one()
                out[f"hosts_{store == b}"] = (c.controller.host,
                                              sorted(i["ref"].host for i in vmap.values()))
            await ts_ref.put("x/small", v["small"], store_name=a)
            out["small"] = np.asarray(await ts_ref.get("x/small", store_name=a))
            await ts_ref.put("x/bulk", v["bulk"], store_name=a)
            out["bulk"] = np.asarray(await ts_ref.get("x/bulk", store_name=a))
            relay = await ts_ref.get("x/small", store_name=a)
            await ts_ref.put("x/relay", np.asarray(relay), store_name=b)
            out["relay"] = np.asarray(await ts_ref.get("x/relay", store_name=b))
        finally:
            await ts_ref.shutdown(b)
            await ts_ref.shutdown(a)
    return out


async def port_fleet(mp) -> dict:
    v = values()
    t = torch.from_numpy
    a, b = f"tst_xa_{uuid.uuid4().hex[:6]}", f"tst_xb_{uuid.uuid4().hex[:6]}"
    out = {}
    before = {p.pid for p in multiprocessing.active_children()}
    mine_before = tcp_listeners([os.getpid()])
    mp.setenv("TORCHSTORE_TORCH_BIND_HOST", ADDR_A)
    await tst.initialize(store_name=a, strategy=tst.SingletonStrategy(
        default_transport_type="bulk"))
    mp.setenv("TORCHSTORE_TORCH_BIND_HOST", ADDR_B)
    await tst.initialize(store_name=b)
    try:
        for store in (a, b):
            c = tst.client(store)
            vmap = await c.controller.get_volume_map.call_one()
            out[f"hosts_{store == b}"] = (c.controller.host,
                                          sorted(i["ref"].host for i in vmap.values()))
        await tst.put("x/small", t(v["small"]), store_name=a)
        out["small"] = (await tst.get("x/small", store_name=a)).numpy()
        await tst.put("x/bulk", t(v["bulk"]), store_name=a)
        out["bulk"] = (await tst.get("x/bulk", store_name=a)).numpy()
        relay = await tst.get("x/small", store_name=a)
        await tst.put("x/relay", relay.clone(), store_name=b)
        out["relay"] = (await tst.get("x/relay", store_name=b)).numpy()
        out["bulk_endpoints"] = sorted(
            tst.client(a)._ctx.get_cache(BulkClientCache).endpoints.values())
        # A direct-sync source in this process binds store B's address, and
        # its dest dials what it advertised.
        mp.setenv("TORCHSTORE_TORCH_BIND_HOST", ADDR_B)
        sd = {"w": t(v["bulk"]).clone(), "b": t(v["small"]).clone()}
        await tst.put_state_dict("direct", sd, direct=True, store_name=b)
        targets = {"w": torch.zeros(512, 1024), "b": torch.zeros(256)}
        await tst.get_state_dict("direct", targets, direct=True, store_name=b)
        out["direct"] = (targets["w"].numpy(), targets["b"].numpy())
        children = {p.pid for p in multiprocessing.active_children()} - before
        out["child_listeners"] = tcp_listeners(children)
        out["own_listeners"] = tcp_listeners([os.getpid()]) - mine_before
    finally:
        await tst.shutdown(b)
        await tst.shutdown(a)
    return out


def test_cross_address_fleet(tmp_path, monkeypatch):
    ref = asyncio.run(reference_fleet())
    base = str(tmp_path / "trace.json")
    monkeypatch.setenv(tracing.ENV_TRACE, base)
    monkeypatch.setenv(tracing.ENV_TRACE_RUN, f"{os.getpid()}.{uuid.uuid4().hex[:8]}")
    tracing.collector().reinit_after_fork()
    try:
        port = asyncio.run(port_fleet(monkeypatch))
        merged = tst.collect_trace(str(tmp_path / "merged.json"))
    finally:
        monkeypatch.delenv(tracing.ENV_TRACE)
        tracing.collector().reinit_after_fork()

    # Nothing in either fleet advertises loopback-default addresses.
    assert port["hosts_False"] == ref["hosts_False"] == (ADDR_A, [ADDR_A])
    assert port["hosts_True"] == ref["hosts_True"] == (ADDR_B, [ADDR_B])
    v = values()
    for key in ("small", "bulk", "relay"):
        assert np.array_equal(port[key], ref[key]), key
    assert np.array_equal(port["relay"], v["small"])
    assert [h for h, _ in port["bulk_endpoints"]] == [ADDR_A]
    assert np.array_equal(port["direct"][0], v["bulk"])
    assert np.array_equal(port["direct"][1], v["small"])
    # Every listener of the volumes, the controllers and this process's
    # direct-sync source is on .2 or .3: none on 127.0.0.1.
    listeners = port["child_listeners"] | port["own_listeners"]
    assert {ip for ip, _ in port["child_listeners"]} == {ADDR_A, ADDR_B}
    assert {ip for ip, _ in port["own_listeners"]} == {ADDR_B}
    assert not [lst for lst in listeners if lst[0] == "127.0.0.1"]

    # The trace id minted in this process crossed the 127.0.0.2 hop: a
    # put_batch span and another process's spans share it.
    events = json.load(open(merged["path"]))
    spans = [e for e in events if e.get("ph") == "X"]
    puts = [e for e in spans if e["name"] == "put_batch" and "trace_id" in (e.get("args") or {})]
    assert puts
    stitched = 0
    for put in puts:
        tid = put["args"]["trace_id"]
        pids = {e["pid"] for e in spans if (e.get("args") or {}).get("trace_id") == tid}
        stitched += len(pids) >= 2
    assert stitched >= 1, "no trace id crossed the 127.0.0.2/127.0.0.3 hop"
