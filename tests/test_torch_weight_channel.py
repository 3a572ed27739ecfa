"""The port's versioned weight channel (``WeightPublisher`` /
``WeightSubscriber``) and the waits it stands on, held to the JAX package.

- The reference's channel cases (``tests/test_weight_channel.py``) run on
  the port: sequence, timeout, GC keeps N, resumed numbering, skip to the
  newest, in place, a concurrent loop, GC of orphans, the direct stable
  key, a concurrent delete, close, duplicate wakeups, a recreated channel
  and a stale large generation; plus the waits' controller-death case and
  a long poll that outlives the client's RPC deadline.
- A parity script (publishes, acquires, a resume, a bf16 publish, a close
  and a recreate) runs through both packages' channels from one numpy
  seed: the versions returned, ``keys("policy")`` after each publish and
  the values (exact in fp32, bit-equal in bf16) must agree.

Each package runs one store session (module fixtures); the tests hold the
recorded results.
"""

import asyncio
import contextlib
import copy
import multiprocessing
import os
import uuid

import ml_dtypes
import numpy as np
import pytest
import torch

import torchstore_tpu as ts_ref
import torchstore_tpu_torch as tst
from torchstore_tpu import config as ref_config
from torchstore_tpu.config import StoreConfig as RefStoreConfig
from torchstore_tpu.transport import shared_memory as ref_shm
from torchstore_tpu_torch.client import LocalClient
from torchstore_tpu_torch.runtime import actors as port_actors
from torchstore_tpu_torch.transport import shared_memory as port_shm


def run(coro_fn, *args):
    return asyncio.run(asyncio.wait_for(coro_fn(*args), timeout=240))


def np_of(value) -> np.ndarray:
    """A leaf of either package as numpy: bf16 as its uint16 bits."""
    if isinstance(value, torch.Tensor):
        if value.dtype == torch.bfloat16:
            return value.view(torch.int16).numpy().view(np.uint16).copy()
        return value.numpy().copy()
    arr = np.asarray(value)
    if arr.dtype == ml_dtypes.bfloat16:
        return arr.view(np.uint16).copy()
    return arr.copy()


async def later(coro, delay: float):
    await asyncio.sleep(delay)
    return await coro


@contextlib.contextmanager
def reference_without_shm():
    # The reference over its RPC rung, without its stamped metadata and
    # one-sided planes: it then adds no ts_shm_* segments to the
    # machine-wide counts of its own tests. The process's default config is
    # read from the environment once, so it is not first read here.
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_config, "_default_config", None)
        mp.setattr(ref_shm, "is_available", lambda: False)
        mp.setenv("TORCHSTORE_TPU_META_STAMPED", "0")
        mp.setenv("TORCHSTORE_TPU_ONE_SIDED", "0")
        yield RefStoreConfig(shm_enabled=False, bulk_tcp_enabled=False)


# --------------------------------------------------------------------------
# the parity script, run by both packages
# --------------------------------------------------------------------------


def parity_dicts(n: int = 6, seed: int = 0) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"w": rng.standard_normal(64).astype(np.float32),
             "b": {"0": rng.standard_normal((4, 8)).astype(np.float32)}} for _ in range(n)]


async def parity_script(pkg, store: str, to_leaf, zeros, bf16) -> dict:
    """The scripted channel sequence; ``pkg`` is either package."""
    dicts = parity_dicts()
    tree = lambda i: {"w": to_leaf(dicts[i]["w"]), "b": {"0": to_leaf(dicts[i]["b"]["0"])}}  # noqa: E731
    out = {"versions": [], "acquired": [], "keys": [], "values": []}

    async def keys():
        out["keys"].append(await pkg.keys("policy", store_name=store))

    def record(sd):
        out["values"].append({"w": np_of(sd["w"]), "b": np_of(sd["b"]["0"])})

    pub = pkg.WeightPublisher("policy", store_name=store, keep=2)
    sub = pkg.WeightSubscriber("policy", store_name=store)
    out["versions"].append(await pub.publish(tree(0)))
    await keys()
    sd, v = await sub.acquire(timeout=30)
    out["acquired"].append(v)
    record(sd)
    for i in (1, 2):
        out["versions"].append(await pub.publish(tree(i)))
        await keys()
    sd, v = await sub.acquire(timeout=30)  # skips v1: the newest is v2
    out["acquired"].append(v)
    record(sd)
    resumed = pkg.WeightPublisher("policy", store_name=store, keep=2)
    out["versions"].append(await resumed.publish(tree(3)))
    await keys()
    user = {"w": zeros(64, None), "b": {"0": zeros((4, 8), None)}}
    sd, v = await sub.acquire(user_state_dict=user, timeout=30)
    out["acquired"].append(v)
    out["in_place"] = sd["w"] is user["w"]
    record(user)
    out["versions"].append(await resumed.publish(tree(4), transfer_dtype=bf16))
    await keys()
    sd, v = await sub.acquire(timeout=30)
    out["acquired"].append(v)
    record(sd)
    await resumed.close(delete=True)
    await keys()
    recreated = pkg.WeightPublisher("policy", store_name=store, keep=2)
    out["versions"].append(await recreated.publish(tree(5)))
    await keys()
    sd, v = await sub.acquire(timeout=30)
    out["acquired"].append(v)
    record(sd)
    return out


async def reference_session() -> dict:
    store = f"ref_{uuid.uuid4().hex[:8]}"
    with reference_without_shm() as config:
        await ts_ref.initialize(store_name=store, config=config)
        try:
            return await parity_script(
                ts_ref, store, lambda a: a.copy(),
                lambda shape, _: np.zeros(shape, np.float32), ml_dtypes.bfloat16,
            )
        finally:
            await ts_ref.shutdown(store)


# --------------------------------------------------------------------------
# the port's session: every channel case, recorded
# --------------------------------------------------------------------------


async def channel_cases(store: str, out: dict) -> None:
    def full(n, x):
        return torch.full((n,), float(x))

    # test_publish_acquire_sequence ("policy" is the parity script's)
    pub = tst.WeightPublisher("p1", store_name=store)
    sub = tst.WeightSubscriber("p1", store_name=store)
    v0 = await pub.publish({"w": full(8, 0.0)})
    sd0, a0 = await sub.acquire(timeout=10.0)
    task = asyncio.create_task(later(pub.publish({"w": full(8, 1.0)}), 0.1))
    sd1, a1 = await sub.acquire(timeout=10.0)
    await task
    out["sequence"] = (v0, a0, sd0["w"].tolist(), a1, sd1["w"].tolist())

    # test_acquire_timeout_when_no_new_version
    pub = tst.WeightPublisher("p2", store_name=store)
    sub = tst.WeightSubscriber("p2", store_name=store)
    await pub.publish({"w": torch.ones(2)})
    await sub.acquire(timeout=5.0)
    try:
        await sub.acquire(timeout=0.25)
        out["timeout"] = False
    except TimeoutError:
        out["timeout"] = True

    # test_gc_keeps_last_n_versions
    pub = tst.WeightPublisher("p3", store_name=store, keep=2)
    for i in range(4):
        await pub.publish({"w": full(4, i)})
    out["gc_keys"] = await tst.keys("p3", store_name=store)

    # test_publisher_resumes_numbering
    pub = tst.WeightPublisher("p4", store_name=store)
    await pub.publish({"w": torch.ones(2)})
    await pub.publish({"w": torch.ones(2)})
    out["resumed"] = await tst.WeightPublisher("p4", store_name=store).publish(
        {"w": torch.ones(2)})

    # test_subscriber_skips_to_newest
    pub = tst.WeightPublisher("p5", store_name=store)
    for i in range(3):
        await pub.publish({"w": full(2, i)})
    sd, v = await tst.WeightSubscriber("p5", store_name=store).acquire(timeout=5.0)
    out["newest"] = (v, sd["w"].tolist())

    # test_inplace_acquire
    pub = tst.WeightPublisher("p6", store_name=store)
    src = {"w": torch.arange(16, dtype=torch.float32).reshape(4, 4)}
    await pub.publish(src)
    user = {"w": torch.zeros(4, 4)}
    sd, _ = await tst.WeightSubscriber("p6", store_name=store).acquire(
        user_state_dict=user, timeout=5.0)
    out["in_place"] = (sd["w"] is user["w"], torch.equal(user["w"], src["w"]))

    # test_concurrent_producer_consumer_loop
    pub = tst.WeightPublisher("loop", store_name=store, keep=8)
    sub = tst.WeightSubscriber("loop", store_name=store)
    seen: list = []
    consistent = []

    async def producer():
        for i in range(5):
            await pub.publish({"w": full(4, i)})
            await asyncio.sleep(0.02)

    async def consumer():
        while not seen or seen[-1] < 4:
            sd, v = await sub.acquire(timeout=10.0)
            consistent.append(float(sd["w"][0]) == float(v))
            seen.append(v)

    await asyncio.gather(producer(), consumer())
    out["loop"] = (seen, all(consistent))

    # test_gc_reclaims_orphans
    pub = tst.WeightPublisher("p8", store_name=store, keep=8)
    for i in range(4):
        await pub.publish({"w": full(2, i)})
    v = await tst.WeightPublisher("p8", store_name=store, keep=1).publish({"w": torch.ones(2)})
    keys = await tst.keys("p8", store_name=store)
    out["orphans"] = (v, sorted({k.split("/")[1] for k in keys if k.split("/")[1][0] == "v"}))

    # test_direct_channel_stable_key
    pub = tst.WeightPublisher("pd", store_name=store)
    sub = tst.WeightSubscriber("pd", store_name=store)
    src = {"w": torch.full((16,), 1.0)}
    d0 = await pub.publish(src, direct=True)
    user = {"w": torch.zeros(16)}
    _, a0 = await sub.acquire(user_state_dict=user, direct=True, timeout=5.0)
    first = user["w"].tolist()
    src["w"][:] = 2.0  # the trainer updates in place; the publish refreshes
    d1 = await pub.publish(src, direct=True)
    _, a1 = await sub.acquire(user_state_dict=user, direct=True, timeout=5.0)
    keys = await tst.keys("pd", store_name=store)
    out["direct"] = (d0, a0, first, d1, a1, user["w"].tolist(),
                     [k for k in keys if k.split("/")[1].startswith("v")])

    # test_acquire_survives_concurrent_channel_delete
    pub = tst.WeightPublisher("p9", store_name=store)
    sub = tst.WeightSubscriber("p9", store_name=store)
    await pub.publish({"w": torch.ones(2)})
    await sub.acquire(timeout=5.0)

    async def delete_then_republish():
        await asyncio.sleep(0.05)
        await pub.close(delete=True)
        await asyncio.sleep(0.1)
        await tst.WeightPublisher("p9", store_name=store).publish({"w": full(2, 7.0)})

    task = asyncio.create_task(delete_then_republish())
    sd, _ = await sub.acquire(timeout=10.0)
    await task
    out["concurrent_delete"] = sd["w"].tolist()

    # test_close_deletes_channel
    pub = tst.WeightPublisher("p7", store_name=store)
    await pub.publish({"w": torch.ones(2)})
    await pub.close(delete=True)
    out["closed_keys"] = await tst.keys("p7", store_name=store)

    # test_duplicate_wakeup_not_redelivered
    pub = tst.WeightPublisher("dup", store_name=store)
    sub = tst.WeightSubscriber("dup", store_name=store)
    await pub.publish({"w": torch.zeros(4)})
    _, d0 = await sub.acquire(timeout=10.0)
    sub._last_gen -= 1  # as if woken for a publish whose successor it returned
    try:
        await sub.acquire(timeout=0.4)
        dup_timeout = False
    except TimeoutError:
        dup_timeout = True
    await pub.publish({"w": torch.ones(4)})
    sd, d1 = await sub.acquire(timeout=10.0)
    out["duplicate"] = (d0, dup_timeout, d1, float(sd["w"][0]))

    # test_recreated_channel_redelivers_same_version_number
    pub = tst.WeightPublisher("rc", store_name=store)
    sub = tst.WeightSubscriber("rc", store_name=store)
    await pub.publish({"w": full(2, 1.0)})
    await pub.publish({"w": full(2, 2.0)})
    sd, r1 = await sub.acquire(timeout=10.0)
    first = float(sd["w"][0])
    await pub.close(delete=True)
    pub2 = tst.WeightPublisher("rc", store_name=store)
    await pub2.publish({"w": full(2, 5.0)})
    await pub2.publish({"w": full(2, 6.0)})
    sd, r2 = await sub.acquire(timeout=10.0)
    out["recreated"] = (r1, first, r2, float(sd["w"][0]), pub._epoch != pub2._epoch)

    # test_stale_large_gen_wakes_immediately
    await tst.put("g", torch.ones(2), store_name=store)
    controller = tst.client(store).controller
    out["stale_gen"] = await asyncio.wait_for(
        controller.wait_for_change.call_one("g", 10_000_000, timeout=5.0), timeout=2.0)

    # A subscriber blocked in acquire(timeout=None) outlives its client's
    # RPC deadline: the long poll has none.
    own = copy.copy(controller)  # its own deadline, not the session client's
    short = LocalClient(own, tst.StoreConfig(rpc_timeout=1.0))
    pub = tst.WeightPublisher("lp", store_name=store)
    sub = tst.WeightSubscriber("lp", client=short)
    task = asyncio.create_task(later(pub.publish({"w": full(2, 3.0)}), 2.5))
    sd, v = await sub.acquire(timeout=None)
    await task
    short.close()
    out["long_poll"] = (v, float(sd["w"][0]), own.rpc_timeout)

    # Outside this slice: each names its ROADMAP item. Pinned reads
    # (version=) are ported: of a version the channel never held they raise
    # KeyError before any pull.
    raised = {}
    for name, fn in (
        ("version", lambda: tst.WeightSubscriber("x", store_name=store).acquire(version=0)),
        ("streamed_version",
         lambda: tst.WeightSubscriber("x", store_name=store).acquire_streamed(version=0)),
    ):
        try:
            await fn()
            raised[name] = None
        except (NotImplementedError, KeyError) as exc:
            raised[name] = (type(exc).__name__, str(exc))
    # register is ported (A11.3): a report of the provisioned working set.
    raised["register"] = await tst.WeightPublisher("x", store_name=store).register(
        {"w": torch.ones(65536)})
    try:
        tst.WeightSubscriber("x", store_name=store, relay=True)
        raised["relay"] = None
    except NotImplementedError as exc:
        raised["relay"] = (type(exc).__name__, str(exc))
    out["not_ported"] = raised


async def controller_death(out: dict) -> None:
    """A client blocked in wait_for surfaces the controller's death as an
    error, never a hang."""
    store = f"wcdie_{uuid.uuid4().hex[:8]}"
    await tst.initialize(store_name=store)
    try:
        waiter = asyncio.create_task(tst.wait_for("never", timeout=None, store_name=store))
        await asyncio.sleep(0.3)
        blocked = not waiter.done()
        mesh = port_actors._singletons[f"tst_{store}_controller"]
        for proc in mesh._processes:
            proc.kill()
            proc.join(5)
        try:
            await asyncio.wait_for(waiter, timeout=10.0)
            out["death"] = (blocked, None)
        except Exception as exc:  # noqa: BLE001 - recorded for the test
            out["death"] = (blocked, exc)
    finally:
        await tst.shutdown(store)


async def port_session() -> dict:
    store = f"wc_{uuid.uuid4().hex[:8]}"
    out: dict = {}
    await tst.initialize(store_name=store)
    pids = {p.pid for p in multiprocessing.active_children()} | {os.getpid()}
    try:
        await channel_cases(store, out)
        out["parity"] = await parity_script(
            tst, store, lambda a: torch.from_numpy(a.copy()),
            lambda shape, _: torch.zeros(shape), torch.bfloat16,
        )
    finally:
        await tst.shutdown(store)
    await controller_death(out)
    await asyncio.sleep(0.3)
    out["alive"] = [p.pid for p in multiprocessing.active_children() if p.pid in pids]
    out["segments"] = [n for n in os.listdir(port_shm.SHM_DIR)
                       if n.startswith(port_shm.PREFIX)
                       and int(n[len(port_shm.PREFIX):].split("_")[0]) in pids]
    return out


@pytest.fixture(scope="module")
def port():
    return run(port_session)


@pytest.fixture(scope="module")
def reference():
    return run(reference_session)


# --------------------------------------------------------------------------
# the reference's channel cases, on the port
# --------------------------------------------------------------------------


def test_publish_acquire_sequence(port):
    v0, a0, w0, a1, w1 = port["sequence"]
    assert v0 == a0 == 0 and w0 == [0.0] * 8
    assert a1 == 1 and w1 == [1.0] * 8


def test_acquire_timeout_when_no_new_version(port):
    assert port["timeout"]


def test_gc_keeps_last_n_versions(port):
    keys = port["gc_keys"]
    assert not any(k.startswith(("p3/v0/", "p3/v1/")) for k in keys)
    assert any(k.startswith("p3/v2/") for k in keys) and any(k.startswith("p3/v3/") for k in keys)


def test_publisher_resumes_numbering(port):
    assert port["resumed"] == 2


def test_subscriber_skips_to_newest(port):
    assert port["newest"] == (2, [2.0, 2.0])


def test_inplace_acquire(port):
    assert port["in_place"] == (True, True)


def test_concurrent_producer_consumer_loop(port):
    seen, consistent = port["loop"]
    assert seen[-1] == 4 and seen == sorted(seen) and consistent


def test_gc_reclaims_orphans(port):
    assert port["orphans"] == (4, ["v4"])


def test_direct_channel_stable_key(port):
    d0, a0, first, d1, a1, now, version_keys = port["direct"]
    assert (d0, a0, d1, a1) == (0, 0, 1, 1)
    assert first == [1.0] * 16 and now == [2.0] * 16
    assert version_keys == []  # one stable data key, no version keys


def test_acquire_survives_concurrent_channel_delete(port):
    assert port["concurrent_delete"] == [7.0, 7.0]


def test_close_deletes_channel(port):
    assert port["closed_keys"] == []


def test_duplicate_wakeup_not_redelivered(port):
    assert port["duplicate"] == (0, True, 1, 1.0)


def test_recreated_channel_redelivers_same_version_number(port):
    r1, first, r2, second, new_epoch = port["recreated"]
    assert (r1, first) == (1, 2.0)
    assert (r2, second) == (1, 6.0) and new_epoch  # same number, new channel


def test_stale_large_gen_wakes_immediately(port):
    change = port["stale_gen"]
    assert change["state"] == "committed" and change["gen"] < 10_000_000


def test_acquire_outlives_the_rpc_deadline(port):
    assert port["long_poll"] == (0, 3.0, 1.0)


def test_controller_death_fails_wait_loudly(port):
    blocked, exc = port["death"]
    assert blocked
    assert isinstance(exc, (port_actors.ActorDiedError, ConnectionError, OSError))
    assert not isinstance(exc, TimeoutError)  # a hung waiter would time out


@pytest.mark.parametrize("name", ["register", "version", "streamed_version", "relay"])
def test_out_of_slice_features_name_their_roadmap_item(port, name):
    if name == "register":
        # Ported with provisioning: the report the reference's register
        # test asserts (one segment for a 256 KiB state dict).
        report = port["not_ported"][name]
        assert report["ok"] and report["errors"] == {} and report["segments"] == 1
        return
    kind, message = port["not_ported"][name]
    if name in ("version", "streamed_version"):
        # Ported with the lease plane: an unretained version is a KeyError.
        assert kind == "KeyError" and "does not retain v0" in message
    else:
        assert kind == "NotImplementedError" and "A11" in message


def test_session_leaves_no_process_or_segment(port):
    assert port["alive"] == [] and port["segments"] == []


# --------------------------------------------------------------------------
# parity with the JAX package's channel
# --------------------------------------------------------------------------


def test_parity_versions_and_keys(port, reference):
    got, want = port["parity"], reference
    assert got["versions"] == want["versions"] == [0, 1, 2, 3, 4, 0]
    assert got["acquired"] == want["acquired"] == [0, 2, 3, 4, 0]
    assert got["keys"] == want["keys"]
    assert got["in_place"] and want["in_place"]


@pytest.mark.parametrize("step", range(5))
def test_parity_values(port, reference, step):
    got, want = port["parity"]["values"][step], reference["values"][step]
    for key in ("w", "b"):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_parity_values_are_the_published_ones(port):
    dicts = parity_dicts()
    values = port["parity"]["values"]
    for step, src in zip((0, 1, 2, 4), (0, 2, 3, 5)):
        np.testing.assert_array_equal(values[step]["w"], dicts[src]["w"])
    bf16 = torch.from_numpy(dicts[4]["w"]).to(torch.bfloat16)
    np.testing.assert_array_equal(values[3]["w"], np_of(bf16))

