"""The port's transfer-plan cache (``client.SyncPlanCache``), held to the
reference's plan-cache tests (``tests/test_sync_pipeline.py``: hits and
epoch invalidation with no locate on the warm get, a shape change that
fails loudly, a key-drop republish that invalidates, the cache disabled by
config; ``tests/test_quant_delta.py``: quantized publishes hit the cache),
and the cache itself against the JAX package's ``SyncPlanCache`` on the
same sequence of calls.

The store cases run in one session (two port stores: the cache on and
off), recorded once; the tests read the record. Inputs are made from a
numpy seed.
"""

import asyncio
import importlib

import numpy as np
import pytest
import torch

import torchstore_tpu_torch as tst
ref_client = importlib.import_module("torchstore_tpu.client")
port_client = importlib.import_module("torchstore_tpu_torch.client")
sdu = importlib.import_module("torchstore_tpu_torch.state_dict_utils")

PLANS, NOPLAN = "plans", "noplan"


def arr(seed: int, n: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).random(n).astype(np.float32))


def counters() -> dict:
    return {
        "hits_put": port_client._PLAN_HITS.value(op="put"),
        "hits_get": port_client._PLAN_HITS.value(op="get"),
        "misses": port_client._PLAN_MISSES.total(),
        "invalidations": port_client._PLAN_INVALIDATIONS.total(),
        "markers": sdu._MARKER_FETCHES.total(),
    }


async def probe(client) -> dict:
    """The controller's locates and placement epoch, and this client's
    epoch reads (read by direct controller calls, which move no count)."""
    stats = await client.controller.stats.call_one()
    epoch = await client.controller.placement_epoch.call_one()
    return {"locates": stats["locates"], "epoch": epoch, "epoch_reads": client.epoch_reads,
            **counters()}


def delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


async def hits_and_invalidation(client) -> dict:
    """test_plan_cache_hits_and_epoch_invalidation."""
    sd = {str(i): arr(i, 8192) for i in range(8)}
    user = {str(i): torch.zeros(8192) for i in range(8)}
    rec: dict = {}
    await tst.put_state_dict("p/sd", sd, store_name=PLANS)
    out = await tst.get_state_dict("p/sd", user, store_name=PLANS)
    rec["cold_equal"] = torch.equal(out["0"], sd["0"])
    warm0 = await probe(client)
    sd["0"][0] = 7.0
    await tst.put_state_dict("p/sd", sd, store_name=PLANS)
    mid = await probe(client)
    out = await tst.get_state_dict("p/sd", user, store_name=PLANS)
    rec["warm_value"] = float(out["0"][0])
    rec["put_step"] = delta(mid, warm0)
    rec["get_step"] = delta(await probe(client), mid)
    # A structural change elsewhere (a delete) moves the epoch: every plan
    # goes, and the next iteration rebuilds.
    before = await probe(client)
    await tst.put("unrelated", torch.ones(4), store_name=PLANS)
    await tst.delete("unrelated", store_name=PLANS)
    sd["0"][0] = 9.0
    await tst.put_state_dict("p/sd", sd, store_name=PLANS)
    out = await tst.get_state_dict("p/sd", user, store_name=PLANS)
    rec["after_value"] = float(out["0"][0])
    rec["after_step"] = delta(await probe(client), before)
    return rec


async def quantized_hits(client) -> dict:
    """test_quantized_publishes_hit_plan_cache."""
    sd = {"w": arr(20, 1024), "b": arr(21, 32)}
    user = {"w": torch.zeros(1024), "b": torch.zeros(32)}
    before = await probe(client)
    steps = []
    for it in range(3):
        sd["w"][0] = float(it)
        start = await probe(client)
        await tst.put_state_dict("pc", sd, transfer_quant="int8_block", store_name=PLANS)
        await tst.get_state_dict("pc", user, store_name=PLANS)
        steps.append(delta(await probe(client), start))
    return {"total": delta(await probe(client), before), "steps": steps,
            "err": float((user["w"] - sd["w"]).abs().max()),
            "tol": float(sd["w"].abs().max()) / 127 + 1e-6}


async def shape_change(client) -> dict:
    """test_plan_cache_shape_change_fails_loudly."""
    sd = {"w": arr(30, 4096)}
    user = {"w": torch.zeros(4096)}
    for _ in range(2):  # the second round runs on warm plans
        await tst.put_state_dict("s/sd", sd, store_name=PLANS)
        await tst.get_state_dict("s/sd", user, store_name=PLANS)
    sd2 = {"w": arr(31, 128)}
    epoch0 = (await probe(client))["epoch"]
    await tst.put_state_dict("s/sd", sd2, store_name=PLANS)
    rec = {"bumped": (await probe(client))["epoch"] > epoch0}
    try:
        await tst.get_state_dict("s/sd", user, store_name=PLANS)
        rec["stale"] = None
    except (ValueError, KeyError) as exc:
        rec["stale"] = exc
    out = await tst.get_state_dict("s/sd", {"w": torch.zeros(128)}, store_name=PLANS)
    rec["new_equal"] = torch.equal(out["w"], sd2["w"])
    # The quantized tier fails as loudly (the blob of another size).
    qsd = {"w": arr(32, 4096)}
    for _ in range(2):
        await tst.put_state_dict("s/q", qsd, transfer_quant="int8_block", store_name=PLANS)
        await tst.get_state_dict("s/q", user, store_name=PLANS)
    await tst.put_state_dict("s/q", {"w": arr(33, 128)}, transfer_quant="int8_block",
                             store_name=PLANS)
    try:
        await tst.get_state_dict("s/q", user, store_name=PLANS)
        rec["quant_stale"] = None
    except (ValueError, KeyError) as exc:
        rec["quant_stale"] = exc
    return rec


async def key_drop(client) -> dict:
    """test_plan_cache_key_drop_republish_invalidates."""
    sd = {"head": arr(40, 1024), "body": arr(41, 1024)}
    await tst.put_state_dict("d/sd", sd, store_name=PLANS)
    first = await tst.get_state_dict("d/sd", store_name=PLANS)
    hits0 = port_client._PLAN_HITS.value(op="get")
    second = await tst.get_state_dict("d/sd", store_name=PLANS)  # plan hit
    rec = {"first": sorted(first), "second": sorted(second),
           "second_hit": port_client._PLAN_HITS.value(op="get") - hits0}
    # A publisher restart: no memory of the previous signature.
    client.plan_cache.last_put_sig.clear()
    await tst.put_state_dict("d/sd", {"body": sd["body"]}, store_name=PLANS)
    rec["after"] = sorted(await tst.get_state_dict("d/sd", store_name=PLANS))
    return rec


async def disabled(store: str) -> dict:
    """test_plan_cache_disabled_by_config."""
    client = tst.client(store)
    rec = {"cache": client.plan_cache, "equal": []}
    sd = {"w": arr(50, 1024)}
    for _ in range(2):
        await tst.put_state_dict("n/sd", sd, store_name=store)
        out = await tst.get_state_dict("n/sd", store_name=store)
        rec["equal"].append(torch.equal(out["w"], sd["w"]))
    return rec


async def session() -> dict:
    rec: dict = {}
    await tst.initialize(store_name=PLANS)
    try:
        client = tst.client(PLANS)
        rec["hits"] = await hits_and_invalidation(client)
        rec["quant"] = await quantized_hits(client)
        rec["shape"] = await shape_change(client)
        rec["drop"] = await key_drop(client)
    finally:
        await tst.shutdown(PLANS)
    await tst.initialize(store_name=NOPLAN, config=tst.StoreConfig(plan_cache=False))
    try:
        rec["disabled"] = await disabled(NOPLAN)
    finally:
        await tst.shutdown(NOPLAN)
    return rec


@pytest.fixture(scope="module")
def record():
    return asyncio.run(asyncio.wait_for(session(), timeout=240))


def test_plan_cache_hits_and_epoch_invalidation(record):
    rec = record["hits"]
    assert rec["cold_equal"] and rec["warm_value"] == 7.0 and rec["after_value"] == 9.0
    put, get = rec["put_step"], rec["get_step"]
    # Warm put: a plan hit, no epoch bump.
    assert put["hits_put"] == 1 and put["misses"] == 0 and put["epoch"] == 0
    # Warm get: a plan hit validated by ONE epoch read; no marker, no locate.
    assert get["hits_get"] == 1 and get["misses"] == 0
    assert get["epoch_reads"] == 1 and get["markers"] == 0 and get["locates"] == 0
    # After the delete: plans invalidated, rebuilt through the marker.
    after = rec["after_step"]
    assert after["invalidations"] > 0 and after["markers"] == 1 and after["locates"] > 0


def test_quantized_publishes_hit_plan_cache(record):
    rec = record["quant"]
    assert rec["total"]["hits_put"] + rec["total"]["hits_get"] >= 4
    for step in rec["steps"][1:]:
        assert step["hits_put"] == step["hits_get"] == 1
        assert step["markers"] == step["locates"] == step["epoch"] == 0
    assert rec["err"] <= rec["tol"]


def test_plan_cache_shape_change_fails_loudly(record):
    rec = record["shape"]
    assert rec["bumped"]  # the publisher's signature change moved the epoch
    assert isinstance(rec["stale"], (ValueError, KeyError))
    assert rec["new_equal"]
    assert isinstance(rec["quant_stale"], (ValueError, KeyError))


def test_plan_cache_key_drop_republish_invalidates(record):
    rec = record["drop"]
    assert rec["first"] == rec["second"] == ["body", "head"] and rec["second_hit"] == 1
    assert rec["after"] == ["body"]  # the cached two-key plan did not serve


def test_plan_cache_disabled_by_config(record):
    rec = record["disabled"]
    assert rec["cache"] is None and rec["equal"] == [True, True]


def run_cache_calls(mod) -> list:
    """One sequence of calls on a ``SyncPlanCache`` of ``mod``, and what
    each returned."""
    cache = mod.SyncPlanCache()
    out = [cache.observe_epoch(None), cache.observe_epoch(3), cache.observe_epoch(3)]
    cache.store("get", "k", ("s",), {"targets": 1})
    cache.store("put", "k", ("s",), {"store_keys": 2}, epoch=2)
    out.append(cache.lookup("get", "k", ("s",)) is not None)
    out.append(cache.lookup("put", "k", ("s",)) is not None)  # built under an older epoch
    out.append(cache.peek("put", "k", ("s",)) is not None)
    out.append(cache.lookup("get", "k", ("other",)) is not None)
    out.append(cache.observe_epoch(4))
    out.append(len(cache.entries))
    for i in range(cache.MAX_ENTRIES + 1):
        cache.store("get", f"k{i}", ("s",), {})
    out.append(len(cache.entries))
    return out


def test_sync_plan_cache_matches_reference():
    assert port_client.SyncPlanCache.MAX_ENTRIES == ref_client.SyncPlanCache.MAX_ENTRIES
    assert run_cache_calls(port_client) == run_cache_calls(ref_client)


@pytest.mark.parametrize("leaf", ["tensor", "bf16", "shard", "object"])
def test_signatures_tell_layouts_apart(leaf):
    """Two leaves that decompose into different requests never share a
    signature; the same layout twice always does."""
    x = torch.zeros(4, 6)
    ts = tst.TensorSlice((0, 0), (2, 6), (4, 6), (0,), (2,))
    make = {
        "tensor": lambda: (x, torch.zeros(6, 4)),
        "bf16": lambda: (x, x.to(torch.bfloat16)),
        "shard": lambda: (tst.Shard(x[:2], ts),
                          tst.Shard(x[2:], tst.TensorSlice((2, 0), (2, 6), (4, 6), (1,), (2,)))),
        "object": lambda: (7, "seven"),
    }[leaf]
    a, b = make()
    same = sdu._flat_signature({"w": a}) == sdu._flat_signature({"w": make()[0]})
    assert same
    assert (sdu._flat_signature({"w": a}) != sdu._flat_signature({"w": b})) == (leaf != "object")
