"""The port's layer-streamed weight sync (``stream_sync``) and the
controller's stream records, held to the JAX package's cases.

The reference's cases (``tests/test_streamed_sync.py``) run on the port:
out-of-order publish with in-order delivery, in-place destinations, a
superseded stream, the lag gauge, a barrier republish over a streamed key
(``marker_drift``), the record cap, a phantom ``key_order`` entry, a record
retired with its keys, a mid-stream join, a publisher crash, a channel's
streamed acquire overlapping its publish, and the llama loop: the port's
tiny Llama, with the flax model's parameters carried across
(``params_from_flax``), stream-published per module while a streamed
acquire serves it in forward order; its greedy tokens must equal the
barrier path's and the JAX ``Decoder``'s on the same parameters. Besides:
no watermark is visible before its bytes are committed (a publisher slowed
between landing and notifying), and a streamed long poll outlives the
client's RPC deadline. Not here: the doorbell case (ROADMAP A10), the
ordered direct pull (A7: it raises, checked below) and the manifest
helper (A11).

One port store session records every case (a module fixture).
"""

import asyncio
import copy
import dataclasses
import multiprocessing
import os
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchstore_tpu_torch as tst
from torchstore_tpu import parallel as ref_parallel
from torchstore_tpu.models.generate import Decoder as RefDecoder
from torchstore_tpu.models.llama import Llama as RefLlama
from torchstore_tpu.models.llama import LlamaConfig as RefConfig
from torchstore_tpu_torch import stream_sync
from torchstore_tpu_torch.client import LocalClient
from torchstore_tpu_torch.controller import Controller
from torchstore_tpu_torch.models.generate import Decoder, forward_key_order
from torchstore_tpu_torch.models.llama import Llama, LlamaConfig, params_from_flax
from torchstore_tpu_torch.state_dict_utils import NoMatchingPush
from torchstore_tpu_torch.transport import shared_memory as port_shm

PROMPT = np.array([[1, 2, 3, 4]], np.int32)
NEW_TOKENS = 4


def run(coro_fn, *args):
    return asyncio.run(asyncio.wait_for(coro_fn(*args), timeout=240))


def full(n, x):
    return torch.full((n,), float(x))


def fallbacks(reason: str) -> float:
    return stream_sync.stream_counters()["fallbacks"][reason]


def llama_configs():
    """The tiny Llama in both packages, fp32 throughout (tokens compared
    exactly)."""
    ref = dataclasses.replace(RefConfig.tiny(), dtype=jnp.float32, param_dtype=jnp.float32)
    port = dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32,
                               param_dtype=torch.float32)
    return ref, port


def flax_params(ref_cfg, seed: int = 0):
    variables = RefLlama(ref_cfg).init(jax.random.key(seed), jnp.zeros((1, 8), jnp.int32))
    return jax.tree.map(np.asarray, ref_parallel.unbox(variables))


# --------------------------------------------------------------------------
# the session
# --------------------------------------------------------------------------


async def protocol_cases(store: str, out: dict) -> None:
    client = tst.client(store)

    # test_out_of_order_publish_in_order_delivery
    order = [f"layers/{i}/w" for i in range(4)]
    events: list = []
    consumer = asyncio.ensure_future(tst.get_state_dict_streamed(
        "m/sd", key_order=order, on_layer=lambda fk, v: events.append(fk),
        wait_for_stream_s=30, timeout=60, store_name=store))
    await asyncio.sleep(0.05)
    stream = tst.state_dict_stream("m/sd", store_name=store)
    for i in (1, 0, 3, 2):
        await stream.put({"layers": {str(i): {"w": full(64, i)}}})
        await asyncio.sleep(0.01)
    version = await stream.seal()
    sd = await consumer
    barrier = await tst.get_state_dict("m/sd", store_name=store)
    out["in_order"] = (version, events, [float(sd["layers"][str(i)]["w"][0]) for i in range(4)],
                       float(barrier["layers"]["3"]["w"][0]),
                       stream_sync.stream_counters()["acquires"])

    # test_streamed_get_with_in_place_destinations
    stream = tst.state_dict_stream("d/sd", store_name=store)
    src = {f"w{i}": full(128, i + 1) for i in range(3)}
    for k, v in src.items():
        await stream.put({k: v})
    await stream.seal()
    user = {k: torch.zeros(128) for k in src}
    got = await tst.get_state_dict("d/sd", user_state_dict=user, stream=True, store_name=store)
    try:
        await tst.get_state_dict("d/sd", user_state_dict={**user, "extra": torch.zeros(4)},
                                 stream=True, store_name=store)
        strict = None
    except ValueError as exc:
        strict = str(exc)
    out["in_place"] = (all(got[k] is user[k] for k in src),
                       all(torch.equal(user[k], src[k]) for k in src), strict)

    # test_superseded_stream_restarts_to_newest_consistent
    keys = [f"w{i}" for i in range(3)]
    served_first, resume = asyncio.Event(), asyncio.Event()

    async def on_layer(fk, v):
        served_first.set()
        await resume.wait()

    stream1 = tst.state_dict_stream("r/sd", store_name=store)
    await stream1.put({keys[0]: full(64, 10.0)})
    consumer = asyncio.ensure_future(tst.get_state_dict_streamed(
        "r/sd", on_layer=on_layer, timeout=60, store_name=store))
    await asyncio.wait_for(served_first.wait(), 30)
    stream2 = tst.state_dict_stream("r/sd", store_name=store)
    for k in keys:
        await stream2.put({k: full(64, 20.0)})
    await stream2.seal()
    before = fallbacks("superseded") + fallbacks("mixed_generation")
    resume.set()
    sd = await consumer
    out["superseded"] = ([sorted(set(sd[k].tolist())) for k in keys],
                         fallbacks("superseded") + fallbacks("mixed_generation") - before)

    # test_lag_gauge_moves_during_stream
    stream = tst.state_dict_stream("l/sd", store_name=store)
    for i in range(4):
        await stream.put({f"w{i}": full(64, i)})
    await stream.seal()
    observed: list = []

    async def on_lag(fk, v):
        observed.append(stream_sync.stream_counters()["lag_keys"])

    await tst.get_state_dict_streamed("l/sd", on_layer=on_lag, timeout=60, store_name=store)
    out["lag"] = (observed, stream_sync.stream_counters()["lag_keys"])

    # test_barrier_republish_over_streamed_key_falls_back
    stream = tst.state_dict_stream("b/sd", store_name=store)
    await stream.put({"w": full(32, 1.0)})
    await stream.seal()
    await tst.put_state_dict("b/sd", {"w": full(32, 2.0)}, store_name=store)
    before = fallbacks("marker_drift")
    got = await tst.get_state_dict("b/sd", stream=True, store_name=store)
    out["drift"] = (float(got["w"][0]), fallbacks("marker_drift") - before)

    # test_record_cap_evicts_sealed_not_live_streams
    live = await client.stream_begin("hot/sd")  # in flight, never sealed
    for i in range(Controller.MAX_STREAMS + 44):
        key = f"cold/{i}"
        await client.stream_begin(key)
        await client.stream_seal(key, 1)
    state = await client.stream_state("hot/sd")
    out["cap"] = (live, None if state is None else state["version"],
                  await client.stream_state("cold/0"))

    # test_phantom_key_order_entry_still_completes_in_order
    stream = tst.state_dict_stream("p/sd", store_name=store)
    for i in range(3):
        await stream.put({f"w{i}": full(32, i)})
    await stream.seal()
    served: list = []
    got = await tst.get_state_dict_streamed(
        "p/sd", key_order=["w0", "phantom", "w2", "w1"],
        on_layer=lambda fk, v: served.append(fk), timeout=60, store_name=store)
    out["phantom"] = (served, [float(got[f"w{i}"][0]) for i in range(3)])

    # test_stream_record_retired_with_its_keys
    stream = tst.state_dict_stream("g/sd", store_name=store)
    await stream.put({"w": torch.ones(32)})
    await stream.seal()
    had = await client.stream_state("g/sd") is not None
    removed = await tst.delete_prefix("g/sd", store_name=store)
    gone = await client.stream_state("g/sd") is None
    try:
        await tst.get_state_dict("g/sd", stream=True, store_name=store)
        no_push = False
    except NoMatchingPush:
        no_push = True
    out["retired"] = (had, removed, gone, no_push)

    # The ordered direct pull (ROADMAP A7): the one-hop pull in key_order.
    await tst.put_state_dict("x", {"w": torch.ones(2), "v": torch.ones(3)}, direct=True,
                             store_name=store)
    served = []
    await tst.get_state_dict("x", {"w": torch.zeros(2), "v": torch.zeros(3)}, direct=True,
                             key_order=["v", "w"], on_layer=lambda k, v: served.append(k),
                             store_name=store)
    out["direct_order"] = served


async def channel_cases(store: str, out: dict) -> None:
    # test_mid_stream_join_gets_previous_sealed_version
    pub = tst.WeightPublisher("chan", store_name=store, keep=2)
    cs0 = pub.stream()
    for i in range(3):
        await cs0.put({f"w{i}": full(64, 0.0)})
    v0 = await cs0.seal()
    cs1 = pub.stream()
    await cs1.put({"w0": full(64, 1.0)})
    await cs1.put({"w1": full(64, 1.0)})
    sub = tst.WeightSubscriber("chan", store_name=store)
    sd, a0 = await sub.acquire(timeout=15)
    first = [float(sd[f"w{i}"][0]) for i in range(3)]
    await cs1.put({"w2": full(64, 1.0)})
    v1 = await cs1.seal()
    sd, a1 = await sub.acquire(timeout=15)
    out["mid_join"] = (v0, a0, first, v1, a1, [float(sd[f"w{i}"][0]) for i in range(3)])

    # test_publisher_crash_leaves_previous_acquirable_and_gc_reclaims
    pub = tst.WeightPublisher("crash", store_name=store, keep=2)
    c0 = await pub.publish({f"w{i}": full(64, 0.0) for i in range(3)})
    crashed = pub.stream()
    await crashed.put({"w0": full(64, 1.0)})
    del crashed  # never sealed, never advanced a pointer
    partial = await tst.keys("crash/v1", store_name=store)
    sub = tst.WeightSubscriber("crash", store_name=store)
    sd, a0 = await sub.acquire(timeout=15)
    kept = float(sd["w1"][0])
    pub2 = tst.WeightPublisher("crash", store_name=store, keep=2)
    c1 = await pub2.publish({f"w{i}": full(64, 5.0) for i in range(3)})
    sd, a1 = await sub.acquire(timeout=15)
    out["crash"] = (c0, partial, a0, kept, c1, a1, [float(sd[f"w{i}"][0]) for i in range(3)])

    # test_channel_streamed_acquire_overlaps_publish
    pub = tst.WeightPublisher("ov", store_name=store, keep=2)
    sub = tst.WeightSubscriber("ov", store_name=store)
    first_served = asyncio.Event()
    served: list = []

    def on_layer(fk, v):
        served.append(fk)
        first_served.set()

    task = asyncio.ensure_future(sub.acquire_streamed(
        key_order=[f"w{i}" for i in range(3)], on_layer=on_layer, timeout=60))
    await asyncio.sleep(0.05)
    cs = pub.stream()
    await cs.put({"w0": full(64, 7.0)})
    await asyncio.wait_for(first_served.wait(), 30)
    served_before_rest = list(served)
    await cs.put({"w1": full(64, 7.0)})
    await cs.put({"w2": full(64, 7.0)})
    version = await cs.seal()
    sd, got = await task
    out["overlap"] = (served_before_rest, got, version, served,
                      [float(sd[f"w{i}"][0]) for i in range(3)])


async def watermark_cases(store: str, out: dict) -> None:
    client = tst.client(store)
    controller = client.controller

    # No watermark before its bytes: the publisher waits between landing
    # and notifying; a reader polling the record meanwhile must never see
    # the key watermarked while the index does not yet hold it committed.
    land = client._land
    landed = asyncio.Event()

    async def slow_land(volume, requests):
        gens = await land(volume, requests)
        landed.set()
        await asyncio.sleep(0.4)
        return gens

    seen: list = []
    done = asyncio.Event()

    async def watch():
        sk = "slow/sd/w"
        while not done.is_set():
            state = await client.stream_state("slow/sd")
            marked = stream_sync.watermark_of(state, sk) is not None
            committed = await controller.contains.call_one(sk) == "committed"
            seen.append((landed.is_set(), marked, committed))
            await asyncio.sleep(0.02)

    stream = tst.state_dict_stream("slow/sd", store_name=store)
    await stream.begin()
    watcher = asyncio.create_task(watch())
    client._land = slow_land
    try:
        await stream.put({"w": full(16, 3.0)})
    finally:
        del client._land
    await asyncio.sleep(0.05)
    done.set()
    await watcher
    await stream.seal()
    out["bytes_first"] = seen

    # A streamed long poll outlives the client's RPC deadline.
    own = copy.copy(controller)
    short = LocalClient(own, tst.StoreConfig(rpc_timeout=1.0))
    pub = tst.WeightPublisher("lp", store_name=store)
    sub = tst.WeightSubscriber("lp", client=short)

    async def publish_late():
        await asyncio.sleep(2.5)
        cs = pub.stream()
        await cs.put({"w": full(4, 9.0)})
        return await cs.seal()

    task = asyncio.create_task(publish_late())
    sd, v = await sub.acquire_streamed(timeout=None)
    out["long_poll"] = (v, await task, float(sd["w"][0]), own.rpc_timeout)
    short.close()


async def llama_case(store: str, out: dict) -> None:
    """The train-publish-decode loop: the tiny Llama published barrier
    and streamed per module; tokens from each, and the flax parameters for
    the JAX Decoder."""
    ref_cfg, port_cfg = llama_configs()
    tree = flax_params(ref_cfg)
    params = params_from_flax(tree)
    await tst.put_state_dict("llama/sd", {"params": params}, store_name=store)
    barrier = await tst.get_state_dict("llama/sd", store_name=store)
    dec = Decoder(port_cfg, max_len=16, device="cpu")

    def tokens_of(state: dict) -> np.ndarray:
        model = Llama(port_cfg, "cpu")
        model.load_state_dict(state)
        return dec.generate(model, PROMPT, max_new_tokens=NEW_TOKENS).numpy()

    modules: dict = {}
    for key, tensor in params.items():
        modules.setdefault(key.split(".")[0], {})[key] = tensor
    served: list = []
    first_served, published = asyncio.Event(), asyncio.Event()
    overlap = asyncio.Event()

    async def publisher():
        stream = tst.state_dict_stream("llama/sds", store_name=store)
        await stream.begin()
        names = list(modules)
        for name in names:
            await stream.put({"params": modules[name]})
            if name == names[0]:
                # Held open until the reader served the first module.
                await asyncio.wait_for(first_served.wait(), 30)
                overlap.set()
        await stream.seal()
        published.set()

    def on_layer(fk, value):
        served.append(fk)
        first_served.set()

    order = forward_key_order([f"params/{k}" for k in params])
    _, streamed = await asyncio.gather(publisher(), tst.get_state_dict_streamed(
        "llama/sds", key_order=order, on_layer=on_layer, wait_for_stream_s=30, timeout=120,
        store_name=store))
    out["llama"] = {
        "overlap": overlap.is_set() and published.is_set(),
        "served": served,
        "order": order,
        "module_order": list(modules),
        "barrier_tokens": tokens_of(barrier["params"]),
        "streamed_tokens": tokens_of(streamed["params"]),
        "ref_cfg": ref_cfg,
        "tree": tree,
    }


async def port_session() -> dict:
    store = f"ss_{uuid.uuid4().hex[:8]}"
    out: dict = {}
    await tst.initialize(store_name=store)
    pids = {p.pid for p in multiprocessing.active_children()} | {os.getpid()}
    try:
        await protocol_cases(store, out)
        await channel_cases(store, out)
        await watermark_cases(store, out)
        await llama_case(store, out)
    finally:
        await tst.shutdown(store)
    await asyncio.sleep(0.3)
    out["alive"] = [p.pid for p in multiprocessing.active_children() if p.pid in pids]
    out["segments"] = [n for n in os.listdir(port_shm.SHM_DIR)
                       if n.startswith(port_shm.PREFIX)
                       and int(n[len(port_shm.PREFIX):].split("_")[0]) in pids]
    return out


@pytest.fixture(scope="module")
def port():
    return run(port_session)


# --------------------------------------------------------------------------
# core protocol
# --------------------------------------------------------------------------


def test_out_of_order_publish_in_order_delivery(port):
    version, events, values, barrier_last, acquires = port["in_order"]
    assert version == 1
    assert events == [f"layers/{i}/w" for i in range(4)]
    assert values == [0.0, 1.0, 2.0, 3.0] and barrier_last == 3.0
    assert acquires >= 1


def test_streamed_get_with_in_place_destinations(port):
    same, equal, strict = port["in_place"]
    assert same and equal
    assert "not present" in strict


def test_superseded_stream_restarts_to_newest_consistent(port):
    values, restarts = port["superseded"]
    assert values == [[20.0]] * 3  # never a mix of generations
    assert restarts > 0


def test_lag_gauge_moves_during_stream(port):
    observed, final = port["lag"]
    assert len(observed) == 4 and max(observed) > 0
    assert final == 0


def test_barrier_republish_over_streamed_key_falls_back(port):
    value, drifts = port["drift"]
    assert value == 2.0 and drifts == 1


def test_record_cap_evicts_sealed_not_live_streams(port):
    live, state_version, oldest_cold = port["cap"]
    assert state_version == live
    assert oldest_cold is None  # a sealed record went first


def test_phantom_key_order_entry_still_completes_in_order(port):
    served, values = port["phantom"]
    assert served == ["w0", "w2", "w1"]
    assert values == [0.0, 1.0, 2.0]


def test_stream_record_retired_with_its_keys(port):
    had, removed, gone, no_push = port["retired"]
    assert had and removed >= 2 and gone and no_push


def test_direct_key_order_is_not_ported_yet(port):
    # Ported in A7: the direct path serves key_order instead of raising.
    assert port["direct_order"] == ["v", "w"]


# --------------------------------------------------------------------------
# weight channel: mid-stream join, crash, overlap
# --------------------------------------------------------------------------


def test_mid_stream_join_gets_previous_sealed_version(port):
    v0, a0, first, v1, a1, second = port["mid_join"]
    assert (v0, a0) == (0, 0) and first == [0.0] * 3
    assert (v1, a1) == (1, 1) and second == [1.0] * 3


def test_publisher_crash_leaves_previous_acquirable_and_gc_reclaims(port):
    c0, partial, a0, kept, c1, a1, values = port["crash"]
    assert c0 == 0 and partial
    assert a0 == 0 and kept == 0.0
    assert c1 == 1 and a1 == 1 and values == [5.0] * 3


def test_channel_streamed_acquire_overlaps_publish(port):
    before_rest, got, version, served, values = port["overlap"]
    assert before_rest == ["w0"]
    assert got == version == 0
    assert served == ["w0", "w1", "w2"] and values == [7.0] * 3


# --------------------------------------------------------------------------
# watermarks and long polls
# --------------------------------------------------------------------------


def test_no_watermark_before_its_bytes_are_committed(port):
    seen = port["bytes_first"]
    assert all(committed for _, marked, committed in seen if marked)
    # The window existed: bytes landed, neither indexed nor watermarked.
    assert any(landed and not marked and not committed for landed, marked, committed in seen)
    assert seen[-1][1] and seen[-1][2]


def test_streamed_acquire_outlives_the_rpc_deadline(port):
    v, sealed, value, deadline = port["long_poll"]
    assert v == sealed == 0 and value == 9.0 and deadline == 1.0


def test_session_leaves_no_process_or_segment(port):
    assert port["alive"] == [] and port["segments"] == []


# --------------------------------------------------------------------------
# the llama loop
# --------------------------------------------------------------------------


def test_llama_streamed_layers_in_forward_order(port):
    res = port["llama"]
    assert res["overlap"]
    assert res["served"] == res["order"]  # every leaf once, forward order
    served = res["served"]
    emb_last = max(i for i, k in enumerate(served) if "embed" in k)
    l1_first = min(i for i, k in enumerate(served) if "layer_1" in k)
    assert emb_last < l1_first


def test_llama_streamed_decode_matches_barrier_and_jax(port):
    res = port["llama"]
    np.testing.assert_array_equal(res["streamed_tokens"], res["barrier_tokens"])
    want = RefDecoder(res["ref_cfg"], max_len=16).generate(
        res["tree"], jnp.asarray(PROMPT), max_new_tokens=NEW_TOKENS)
    np.testing.assert_array_equal(res["streamed_tokens"], np.asarray(want))


def test_forward_key_order_ranks_nested_modules():
    keys = ["params/lm_head.kernel", "params/layer_10.w", "params/layer_2.w",
            "params/final_norm.scale", "params/embed.embedding"]
    assert forward_key_order(keys) == [
        "params/embed.embedding", "params/layer_2.w", "params/layer_10.w",
        "params/final_norm.scale", "params/lm_head.kernel",
    ]
