"""The delta wire tier through the port's weight channel, held to the JAX
package: the channel cases of ``tests/test_quant_delta.py`` on the port
(accuracy and unchanged keys, the keyframe cadence, the keep and
blockwise rules, a broken chain, streamed unchanged keys served from the
reader's state with no re-transfer, an alias to a missing base, a
recreated channel, a stream record reused without quantization), and a
delta channel run through both packages from one numpy seed, whose
acquired values must be equal bit for bit. The fault-point case waits for
the port's fault points (ROADMAP A2).

Each package runs one store session (module fixtures).
"""

import asyncio
import contextlib
import uuid

import numpy as np
import pytest
import torch

import torchstore_tpu as ts_ref
import torchstore_tpu_torch as tst
from torchstore_tpu import config as ref_config
from torchstore_tpu.config import StoreConfig as RefStoreConfig
from torchstore_tpu.transport import shared_memory as ref_shm
from torchstore_tpu_torch import state_dict_utils as sdu
from torchstore_tpu_torch import stream_sync


def run(coro_fn, *args):
    return asyncio.run(asyncio.wait_for(coro_fn(*args), timeout=240))


def tol(x, qmax: float = 127.0) -> float:
    # One keyframe step per block bounds the tier's error.
    return float(np.max(np.abs(np.asarray(x)))) / qmax + 1e-6


def randn(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def counts() -> dict:
    return {**sdu.sync_counters(), "fallbacks": sum(stream_sync.stream_counters()["fallbacks"]
                                                    .values())}


def moved(after: dict, before: dict, key: str) -> float:
    return after[key] - before[key]


@contextlib.contextmanager
def reference_without_shm():
    # The reference over its RPC rung, without its stamped metadata and
    # one-sided planes (no ts_shm_* segments); the process's default
    # config is not first read under these switches.
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_config, "_default_config", None)
        mp.setattr(ref_shm, "is_available", lambda: False)
        mp.setenv("TORCHSTORE_TPU_META_STAMPED", "0")
        mp.setenv("TORCHSTORE_TPU_ONE_SIDED", "0")
        yield RefStoreConfig(shm_enabled=False, bulk_tcp_enabled=False)


# --------------------------------------------------------------------------
# a delta channel through either package
# --------------------------------------------------------------------------


async def parity_channel(pkg, store: str, to_leaf, to_np) -> list:
    """v0 keyframe, v1 an update of part of "hot", v2 no change (every key
    an alias), v3 another update; keyframe every 4, keep 4."""
    pub = pkg.WeightPublisher("pc", store_name=store, keep=4, transfer_quant="int8_block",
                              delta=True, keyframe_every=4)
    sub = pkg.WeightSubscriber("pc", store_name=store)
    hot, frozen = randn(1, 700), randn(2, 512)
    out = []
    for v in range(4):
        if v in (1, 3):
            hot[: 100 * v] += np.float32(0.05)
        await pub.publish({"hot": to_leaf(hot), "frozen": to_leaf(frozen)})
        sd, got = await sub.acquire(timeout=30)
        out.append((got, {k: to_np(sd[k]) for k in ("hot", "frozen")}))
    return out


async def reference_session() -> list:
    store = f"ref_{uuid.uuid4().hex[:8]}"
    with reference_without_shm() as config:
        await ts_ref.initialize(store_name=store, config=config)
        try:
            return await parity_channel(ts_ref, store, lambda a: a.copy(),
                                        lambda x: np.asarray(x).copy())
        finally:
            await ts_ref.shutdown(store)


# --------------------------------------------------------------------------
# the port's session
# --------------------------------------------------------------------------


async def delta_cases(store: str, out: dict) -> None:
    client = tst.client(store)

    # test_delta_channel_accuracy_and_unchanged
    pub = tst.WeightPublisher("dc", store_name=store, keep=5, transfer_quant="int8_block",
                              delta=True, keyframe_every=4)
    sub = tst.WeightSubscriber("dc", store_name=store)
    w = {"hot": torch.from_numpy(randn(3, 600)), "frozen": torch.from_numpy(randn(4, 600))}
    before = counts()
    rounds = []
    for v in range(4):
        if v:
            w["hot"][:100] += 0.05
        ver = await pub.publish(w)
        sd, got = await sub.acquire(timeout=30)
        rounds.append((
            ver, got,
            all(float((sd[k] - w[k]).abs().max()) <= tol(w[k]) for k in w),
            all(torch.equal(sub._delta_decoder().state[k]["blocks"],
                            pub._codec.entries[k]["baseline"]) for k in w),
        ))
    after = counts()
    sd2, v2 = await tst.WeightSubscriber("dc", store_name=store).acquire(timeout=30)
    out["accuracy"] = (rounds, moved(after, before, "delta_unchanged_keys"),
                       moved(after, before, "delta_keyframes"), v2,
                       all(torch.equal(sd2[k], sd[k]) for k in w))

    # test_delta_keyframe_cadence_bounds_chain
    pub = tst.WeightPublisher("kc", store_name=store, keep=4, transfer_quant="int8_block",
                              delta=True, keyframe_every=3)
    sub = tst.WeightSubscriber("kc", store_name=store)
    w = {"w": torch.from_numpy(randn(5, 512))}
    before = counts()
    for _ in range(7):
        w["w"][:64] += 0.01
        await pub.publish(w)
        await sub.acquire(timeout=30)
    out["cadence"] = moved(counts(), before, "delta_keyframes")

    # test_delta_requires_blockwise_and_retained_chain
    rules = []
    for kw in (dict(transfer_quant="int8", delta=True),
               dict(keep=2, transfer_quant="int8_block", delta=True, keyframe_every=8)):
        try:
            await tst.WeightPublisher("dv", store_name=store, **kw).publish({"w": torch.ones(8)})
            rules.append(None)
        except ValueError as exc:
            rules.append(str(exc))
    out["rules"] = rules

    # test_delta_broken_chain_fails_loudly (a fresh subscriber's acquire of
    # the newest version: pinned reads are ROADMAP A11)
    pub = tst.WeightPublisher("bc", store_name=store, keep=5, transfer_quant="int8_block",
                              delta=True, keyframe_every=4)
    w = {"w": torch.from_numpy(randn(6, 512))}
    await pub.publish(w)  # v0 keyframe
    w["w"][:64] += 0.5
    await pub.publish(w)  # v1 delta on v0
    await client.delete_prefix("bc/v0")  # the keyframe's bytes vanish
    try:
        await tst.WeightSubscriber("bc", store_name=store).acquire(timeout=30)
        out["broken"] = None
    except RuntimeError as exc:
        out["broken"] = str(exc)

    # test_streamed_unchanged_served_from_v1_bytes_zero_retransfer
    pub = tst.WeightPublisher("su", store_name=store, keep=5, transfer_quant="int8_block",
                              delta=True, keyframe_every=4)
    sub = tst.WeightSubscriber("su", store_name=store)
    layers = {str(i): torch.from_numpy(randn(10 + i, 256)) for i in range(3)}
    order = [f"layers/{i}" for i in range(3)]

    async def publish(churn: bool):
        cs = pub.stream()
        for i in range(3):
            if churn and i == 0:
                layers["0"][:32] += 0.1
            await cs.put({"layers": {str(i): layers[str(i)]}})
        return await cs.seal()

    before = counts()
    rounds = []
    for v in range(3):
        served: list = []
        acquire = asyncio.ensure_future(sub.acquire_streamed(
            key_order=order, on_layer=lambda fk, val: served.append(fk), timeout=30))
        await asyncio.sleep(0.05)
        sealed = await publish(churn=v > 0)
        sd, ver = await acquire
        rounds.append((ver, sealed, served == order, all(
            float((sd["layers"][str(i)] - layers[str(i)]).abs().max()) <= tol(layers[str(i)])
            for i in range(3))))
    after = counts()
    state = await client.stream_state("su/v2")
    aliased = list(state["aliases"])
    out["streamed_unchanged"] = (
        rounds, moved(after, before, "delta_unchanged_served"),
        moved(after, before, "fallbacks"), aliased,
        stream_sync.inconsistent_keys(state, aliased, state["version"]))

    # test_unchanged_alias_to_missing_base_fails_publish
    await client.stream_begin("ghost/v3")
    try:
        await client.stream_mark_unchanged("ghost/v3", 1, {"ghost/v3/w": ("ghost/v2/w", 2)})
        out["ghost"] = None
    except Exception as exc:  # noqa: BLE001 - the remote error, recorded
        out["ghost"] = str(exc)

    # test_recreated_channel_resets_delta_decoder
    pub = tst.WeightPublisher("re", store_name=store, keep=5, transfer_quant="int8_block",
                              delta=True, keyframe_every=4)
    sub = tst.WeightSubscriber("re", store_name=store)
    await pub.publish({"w": torch.from_numpy(randn(7, 512))})
    _, r0 = await sub.acquire(timeout=30)
    await pub.close(delete=True)
    pub2 = tst.WeightPublisher("re", store_name=store, keep=5, transfer_quant="int8_block",
                               delta=True, keyframe_every=4)
    new = {"w": torch.from_numpy(randn(8, 512))}
    n0 = await pub2.publish(new)
    new["w"][:64] += 0.1
    n1 = await pub2.publish(new)
    sd, r1 = await sub.acquire(timeout=30)
    out["recreated"] = (r0, n0, n1, r1, float((sd["w"] - new["w"]).abs().max()) <= tol(new["w"]),
                        torch.equal(sub._delta_decoder().state["w"]["blocks"],
                                    pub2._codec.entries["w"]["baseline"]))

    # test_stream_record_reuse_drops_stale_quant_meta
    x1 = torch.from_numpy(randn(9, 64))
    s = tst.state_dict_stream("rq", transfer_quant="int8_block", store_name=store)
    await s.put({"w": x1})
    await s.seal()
    got1 = await tst.get_state_dict("rq", stream=True, store_name=store)
    x2 = torch.from_numpy(randn(10, 64))
    s2 = tst.state_dict_stream("rq", store_name=store)
    await s2.put({"w": x2})
    await s2.seal()
    quant_meta = (await client.stream_state("rq"))["quant"]
    user = {"w": torch.zeros(64)}
    got2 = await tst.get_state_dict("rq", user_state_dict=user, stream=True, store_name=store)
    out["reuse"] = (float((got1["w"] - x1).abs().max()) <= tol(x1), quant_meta,
                    got2["w"] is user["w"], torch.equal(user["w"], x2))

    out["parity"] = await parity_channel(tst, store, lambda a: torch.from_numpy(a.copy()),
                                         lambda x: x.numpy().copy())


async def port_session() -> dict:
    store = f"qd_{uuid.uuid4().hex[:8]}"
    out: dict = {}
    await tst.initialize(store_name=store)
    try:
        await delta_cases(store, out)
    finally:
        await tst.shutdown(store)
    return out


@pytest.fixture(scope="module")
def port():
    return run(port_session)


@pytest.fixture(scope="module")
def reference():
    return run(reference_session)


def test_delta_channel_accuracy_and_unchanged(port):
    rounds, unchanged, keyframes, v2, fresh_equal = port["accuracy"]
    for v, (ver, got, accurate, baseline_equal) in enumerate(rounds):
        assert ver == got == v
        assert accurate and baseline_equal  # the reader bit-equal to the baseline
    assert unchanged >= 2 and keyframes >= 2
    assert v2 == 3 and fresh_equal  # a joining reader chain-walks to the same bytes


def test_delta_keyframe_cadence_bounds_chain(port):
    assert port["cadence"] == 3  # v0, v3, v6


def test_delta_requires_blockwise_and_retained_chain(port):
    blockwise, keep = port["rules"]
    assert "blockwise" in blockwise
    assert "keep >= keyframe" in keep


def test_delta_broken_chain_fails_loudly(port):
    assert "delta chain broken" in port["broken"]


def test_streamed_unchanged_served_from_v1_bytes_zero_retransfer(port):
    rounds, served, falls, aliased, inconsistent = port["streamed_unchanged"]
    for v, (ver, sealed, in_order, accurate) in enumerate(rounds):
        assert ver == sealed == v and in_order and accurate
    assert served >= 4  # two frozen layers at v1 and v2, served locally
    assert falls == 0
    assert aliased and inconsistent == []


def test_unchanged_alias_to_missing_base_fails_publish(port):
    assert "not committed" in port["ghost"]


def test_recreated_channel_resets_delta_decoder(port):
    r0, n0, n1, r1, accurate, baseline_equal = port["recreated"]
    assert (r0, n0, n1, r1) == (0, 0, 1, 1)
    assert accurate and baseline_equal


def test_stream_record_reuse_drops_stale_quant_meta(port):
    accurate, quant_meta, in_place, equal = port["reuse"]
    assert accurate and quant_meta is None and in_place and equal


@pytest.mark.parametrize("version", range(4))
def test_delta_channel_matches_reference(port, reference, version):
    got_v, got = port["parity"][version]
    want_v, want = reference[version]
    assert got_v == want_v == version
    for key in ("hot", "frozen"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
