"""Port parity for the device rung of direct weight sync (the twin of
``tests/test_device_transfer.py``): the port's source and dest against the
JAX package's device rung on its virtual 8-device CPU mesh, fed the same
seeded numpy inputs. fp32 results are compared bit for bit, bf16 as uint16
outside NaN payloads.

No card exists here, so the tests force the port's eligibility
(``device_rung_eligible``, which ``DirectWeightSyncSource._device_mode_eligible``
asks) for CPU leaves: the staging blocks live in host memory, and a dest in
the same process takes the in-process route, straight from the staging
tensors. Opening the blocks over CUDA IPC from another process runs only on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``'s ``direct_device``
phase). The forced fallback (a card this process cannot open) runs here in
full: the source copies its staging to ``/dev/shm`` and the dest reads it
over the host rung."""

import asyncio
import dataclasses
import pickle
import uuid

import anyio
import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P
from test_torch_sharding import fake_rank, placements
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor

import torchstore_tpu as ts_ref
import torchstore_tpu_torch as tst
from torchstore_tpu import sharding as ref_shd
from torchstore_tpu.direct_weight_sync import (
    DirectWeightSyncDest as RefDest,
    DirectWeightSyncSource as RefSource,
)
from torchstore_tpu.transport import device_transfer as ref_dt
from torchstore_tpu_torch import config as port_config
from torchstore_tpu_torch import direct_weight_sync as dws
from torchstore_tpu_torch.direct_weight_sync import DirectWeightSyncDest, DirectWeightSyncSource
from torchstore_tpu_torch.transport import device_transfer as dt

TIMEOUT_S = 60
BF16 = ml_dtypes.bfloat16

pytestmark = pytest.mark.skipif(
    not ref_dt.is_available(), reason="the JAX package's transfer engine is not in this build"
)


@pytest.fixture
def forced(monkeypatch):
    """CPU leaves count as on a card (while ``ici_enabled`` is set)."""
    monkeypatch.setattr(dws, "device_rung_eligible", lambda shards, config: config.ici_enabled)


def mesh(n=8, devices=None):
    devs = np.array(devices if devices is not None else jax.devices()[:n], dtype=object)
    return Mesh(devs.reshape(len(devs)), ("x",))


def rows(seed, shape, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def bits(x):
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.itemsize == 2 else x


def assert_same(port, ref, key=""):
    ref = np.asarray(ref)
    if port.dtype == torch.bfloat16:
        finite = ~np.isnan(ref.astype(np.float32))
        np.testing.assert_array_equal(bits(port)[finite], bits(ref)[finite], err_msg=key)
    else:
        np.testing.assert_array_equal(port.numpy(), ref, err_msg=key)


def counts():
    return (dws.DEVICE_LOCAL_PULLS.total(), dws.DEVICE_IPC_PULLS.total(),
            dws.DEVICE_FALLBACKS.total(), dws.PULL_RETRIES.total())


def moved(before):
    return tuple(a - b for a, b in zip(counts(), before))


def tampered(info):
    """``info`` as a dest that cannot see the source's card reads it."""
    out = dict(info)
    out["entries"] = [
        dataclasses.replace(e, spec=dataclasses.replace(
            e.spec, placement=dataclasses.replace(e.spec.placement, card="GPU-" + "0" * 32)))
        for e in info["entries"]
    ]
    return out


def ref_tampered(info):
    out = dict(info)
    out["entries"] = [
        dataclasses.replace(e, spec=dataclasses.replace(e.spec, sharding=dataclasses.replace(
            e.spec.sharding, device_ids=tuple(i + 1000 for i in e.spec.sharding.device_ids))))
        for e in info["entries"]
    ]
    return out


async def ref_device_pull(ranks, targets, transfer_dtype=None, update=None, tamper=False):
    """The JAX package's device rung: ``ranks`` is one state dict per
    source rank (registered as rank r of len(ranks)); returns the pulled
    dict as numpy, and after ``update`` (new state dicts) and a refresh the
    second pull's."""
    sources = [RefSource() for _ in ranks]
    dest = RefDest()
    try:
        for r, (source, sd) in enumerate(zip(sources, ranks)):
            await source.register(sd, r, transfer_dtype, num_ranks=len(ranks))
            assert source.device_info is not None
        infos = [s.device_info for s in sources]
        if tamper:
            infos = [ref_tampered(i) for i in infos]
        first = {k: np.array(v) for k, v in (await dest.pull_device(infos, targets)).items()}
        if update is None:
            return first, None
        for source, sd in zip(sources, update):
            source.update_sources(sd)
            await source.refresh()
        second = {k: np.array(v) for k, v in (await dest.pull_device(infos, targets)).items()}
        return first, second
    finally:
        await dest.close()
        for source in sources:
            await source.close()


# --------------------------------------------------------------------------
# descriptors
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int64], ids=str)
@pytest.mark.parametrize("shape", [(), (0,), (7, 3)], ids=str)
def test_descriptors_round_trip(shape, dtype):
    t = torch.zeros(shape, dtype=dtype)
    spec = dt.DeviceSpec.of(t)
    assert spec.shape == shape and spec.dtype == str(dtype).removeprefix("torch.")
    assert spec.placement == dt.Placement(dt.HOST_CARD, dws.get_hostname())
    assert getattr(torch, spec.dtype) == dtype
    entry = dws.DeviceEntry("a/b", spec, dws.full_slice(shape), block=1, offset=512)
    assert pickle.loads(pickle.dumps(entry)) == entry


def test_host_memory_is_no_card():
    assert dt.card_uuid(torch.device("cpu")) == dt.HOST_CARD
    assert dt.card_index(dt.HOST_CARD) is None
    assert dt.card_index("GPU-" + "0" * 32) is None
    assert dt.DeviceTransferEngine.get().ensure_server().endswith(f":{dws.os.getpid()}")


async def test_staging_blocks_are_aligned_views(forced):
    tree = {"a": torch.arange(3.0), "b": torch.ones(5, 7), "i": torch.arange(2),
            "empty": torch.zeros(0)}
    source = DirectWeightSyncSource(use_shm=False)
    try:
        assert await source.register(tree, transfer_dtype=torch.bfloat16) == {}
        info = source.device_info
        assert len(source._blocks) == 1 and info["keys"] == list(tree)
        for e in info["entries"]:
            assert e.offset % dws._ALIGN == 0 and e.block == 0
            view = dws._entry_view(source._blocks[0], e)
            assert view.data_ptr() == source._staged[e.flat_key][1].data_ptr()
            want = tree[e.flat_key]
            want = want.to(torch.bfloat16) if want.is_floating_point() else want
            assert torch.equal(view, want), e.flat_key
    finally:
        await source.close()


# --------------------------------------------------------------------------
# the device rung in process
# --------------------------------------------------------------------------


@pytest.fixture
async def port_store():
    name = f"dev_{uuid.uuid4().hex[:8]}"
    await tst.initialize(store_name=name)
    yield name
    await tst.shutdown(name)


@pytest.mark.parametrize("transfer", [None, torch.bfloat16], ids=["fp32", "bf16"])
async def test_direct_sync_rides_device_path(forced, port_store, transfer):
    """A direct put whose leaves are all "on a card": the rank publishes
    device entries and no handles; two pulls through the store (one after a
    republish of new values) serve the current weights in place, as the JAX
    package's device rung serves them."""
    w, b = rows(0, (64,)), np.ones(8, np.float32)
    sh = NamedSharding(mesh(), P("x"))
    ref_dtype = None if transfer is None else BF16
    np_dtype = np.float32 if transfer is None else BF16
    with anyio.fail_after(TIMEOUT_S):
        ref_first, ref_second = await ref_device_pull(
            [{"w": jax.device_put(w, sh), "b": jax.numpy.asarray(b)}],
            {"w": np.zeros(64, np_dtype), "b": np.zeros(8, np_dtype)}, ref_dtype,
            update=[{"w": jax.device_put(w * 2, sh), "b": jax.numpy.asarray(b * 3)}])
        src = {"w": torch.from_numpy(w.copy()), "b": torch.from_numpy(b.copy())}
        before = counts()
        await tst.put_state_dict("m", src, transfer_dtype=transfer, direct=True,
                                 store_name=port_store)
        published = await tst.get("m/rank_0", store_name=port_store)
        assert published["handles"] == {} and published["device"]["source_rank"] == 0
        tdtype = transfer or torch.float32
        target = {"w": torch.zeros(64, dtype=tdtype), "b": torch.zeros(8, dtype=tdtype)}
        out = await tst.get_state_dict("m", target, direct=True, store_name=port_store)
        assert all(out[k] is target[k] for k in target)
        for k in target:
            assert_same(out[k], ref_first[k], k)
        assert tst.direct_sync_stats("m", store_name=port_store)["rung"] == "device"
        src["w"].mul_(2)  # the training step, in place
        src["b"].mul_(3)
        await tst.put_state_dict("m", src, transfer_dtype=transfer, direct=True,
                                 store_name=port_store)
        out = await tst.get_state_dict("m", target, direct=True, store_name=port_store)
        for k in target:
            assert_same(out[k], ref_second[k], k)
    assert moved(before) == (2, 0, 0, 0)


async def test_device_path_reshards_to_target(forced):
    """The dest asks for another layout than the source published: Shard
    targets (column halves) and DTensor targets (one per rank of a 4-rank
    mesh, row-sharded) fill their region of the staged tensor in place."""
    w = rows(1, (8, 8))
    src_sh = NamedSharding(mesh(), P("x"))
    tgt_mesh = Mesh(np.array(jax.devices()[:8], dtype=object).reshape(4, 2), ("p", "q"))
    tgt_sh = NamedSharding(tgt_mesh, P(None, "p"))
    with anyio.fail_after(TIMEOUT_S):
        ref_sources = [RefSource()]
        ref = RefDest()
        try:
            await ref_sources[0].register({"w": jax.device_put(w, src_sh)})
            got = await ref.pull_device([ref_sources[0].device_info],
                                        {"w": jax.ShapeDtypeStruct((8, 8), np.float32,
                                                                   sharding=tgt_sh)})
            assert got["w"].sharding == tgt_sh
            ref_w = np.asarray(got["w"])
            ref_cols = {ref_shd._mesh_coords_map(tgt_mesh)[s.device]: np.asarray(s.data)
                        for s in got["w"].addressable_shards}
        finally:
            await ref.close()
            await ref_sources[0].close()
        source, dest = DirectWeightSyncSource(use_shm=False), DirectWeightSyncDest()
        try:
            await source.register({"w": torch.from_numpy(w.copy())})
            info = source.device_info
            for c in range(2):
                sl = tst.TensorSlice((0, 4 * c), (8, 4), (8, 8), (c,), (2,))
                target = {"w": tst.Shard(torch.zeros(8, 4), sl)}
                out = await dest.pull_device([info], target)
                assert out["w"] is target["w"].data
                assert_same(out["w"], ref_w[:, 4 * c:4 * c + 4])
                # The JAX target's column quarters (p) hold the same columns.
                assert_same(out["w"], np.concatenate(
                    [ref_cols[(2 * c, 0)], ref_cols[(2 * c + 1, 0)]], axis=1))
            for rank in range(4):
                with fake_rank(rank, 4):
                    m = init_device_mesh("cpu", (4,), mesh_dim_names=("x",))
                    target = distribute_tensor(torch.zeros(8, 8), m, placements(("x",), P("x")))
                    out = await dest.pull_device([info], {"w": target})
                    assert out["w"] is target
                    assert_same(target.to_local(), ref_w[2 * rank:2 * rank + 2])
        finally:
            await dest.close()
            await source.close()


def _halves(w, r, n=2):
    step = w.shape[0] // n
    sl = tst.TensorSlice((step * r, 0), (step, w.shape[1]), w.shape, (r,), (n,))
    return sl, w[step * r:step * (r + 1)]


async def test_multi_rank_device_path_in_process(forced):
    """Two source ranks each stage their half of a global tensor (as
    ``Shard``s); the dest merges both ranks' device entries, and after both
    republish, serves the new halves."""
    w = rows(2, (16, 8))
    devs = jax.devices()
    with anyio.fail_after(TIMEOUT_S):
        ranks, update = [], []
        for r in range(2):
            sh = NamedSharding(mesh(devices=devs[4 * r:4 * r + 4]), P("x"))
            sl, part = _halves(w, r)
            ref_sl = ts_ref.TensorSlice(sl.offsets, sl.local_shape, sl.global_shape, (r,), (2,))
            ranks.append({"w": ts_ref.Shard(jax.device_put(part, sh), ref_sl)})
            update.append({"w": ts_ref.Shard(jax.device_put(part * 3, sh), ref_sl)})
        ref_first, ref_second = await ref_device_pull(
            ranks, {"w": np.zeros((16, 8), np.float32)}, update=update)
        sources = [DirectWeightSyncSource(use_shm=False) for _ in range(2)]
        dest = DirectWeightSyncDest()
        try:
            parts = []
            for r, source in enumerate(sources):
                sl, part = _halves(w, r)
                parts.append(torch.from_numpy(part.copy()))
                assert await source.register({"w": tst.Shard(parts[-1], sl)}, r,
                                             num_ranks=2) == {}
            infos = [s.device_info for s in sources]
            assert [i["source_rank"] for i in infos] == [0, 1]
            target = torch.zeros(16, 8)
            out = await dest.pull_device(infos, {"w": target})
            assert out["w"] is target
            assert_same(target, ref_first["w"])
            for part, source in zip(parts, sources):
                part.mul_(3)
                await source.refresh()
            await dest.pull_device(infos, {"w": target})
            assert_same(target, ref_second["w"])
        finally:
            await dest.close()
            for source in sources:
                await source.close()


@pytest.mark.parametrize("transfer", [None, torch.bfloat16], ids=["fp32", "bf16"])
async def test_multi_rank_device_pull_to_host_target(forced, transfer):
    """A plain-tensor consumer of a two-rank device publication: each rank's
    part lands in its region of the target, in place; a buffer-less Shard
    target gets its region in the source's dtype."""
    w = rows(3, (8, 8))
    devs = jax.devices()
    with anyio.fail_after(TIMEOUT_S):
        ranks = []
        for r in range(2):
            sl, part = _halves(w, r)
            ref_sl = ts_ref.TensorSlice(sl.offsets, sl.local_shape, sl.global_shape, (r,), (2,))
            local = jax.device_put(part, jax.sharding.SingleDeviceSharding(devs[4 * r]))
            ranks.append({"w": ts_ref.Shard(local, ref_sl)})
        np_dtype = np.float32 if transfer is None else BF16
        ref, _ = await ref_device_pull(ranks, {"w": np.zeros((8, 8), np_dtype)},
                                       None if transfer is None else BF16)
        sources = [DirectWeightSyncSource(use_shm=False) for _ in range(2)]
        dest = DirectWeightSyncDest()
        try:
            for r, source in enumerate(sources):
                sl, part = _halves(w, r)
                await source.register({"w": tst.Shard(torch.from_numpy(part.copy()), sl)}, r,
                                      transfer, num_ranks=2)
            infos = [s.device_info for s in sources]
            target = torch.zeros(8, 8, dtype=transfer or torch.float32)
            out = await dest.pull_device(infos, {"w": target})
            assert out["w"] is target
            assert_same(target, ref["w"])
            mid = tst.TensorSlice((2, 0), (4, 8), (8, 8), (0,), (1,))
            out = await dest.pull_device(infos, {"w": tst.Shard(None, mid)})
            assert out["w"].dtype == (transfer or torch.float32)
            assert_same(out["w"], ref["w"][2:6])
        finally:
            await dest.close()
            for source in sources:
                await source.close()


async def test_uncovered_target_region_raises(forced):
    source, dest = DirectWeightSyncSource(use_shm=False), DirectWeightSyncDest()
    try:
        sl, part = _halves(rows(4, (8, 4)), 0)
        await source.register({"w": tst.Shard(torch.from_numpy(part.copy()), sl)}, 0,
                              num_ranks=2)
        with pytest.raises(ValueError, match="do not cover"):
            await dest.pull_device([source.device_info], {"w": torch.zeros(8, 4)})
        with pytest.raises(KeyError, match="no source rank published"):
            await dest.pull_device([source.device_info], {"v": torch.zeros(8, 4)})
    finally:
        await dest.close()
        await source.close()


# --------------------------------------------------------------------------
# the host-staging fallback
# --------------------------------------------------------------------------


@pytest.mark.parametrize("use_shm", [True, False], ids=["shm", "tcp"])
async def test_card_mismatch_falls_back_to_host_staging(forced, use_shm):
    """A dest that cannot see the source's card (its UUID tampered, as a
    process that does not see the card reads it) asks for the source's
    host staging and reads it over the host rung; the bytes are current,
    and the fallback is counted once a pull. (The JAX package cannot serve
    a second fallback pull after a publish: its host copy is a read-only
    view of the first generation's arrays, so the new content is held
    against a fresh JAX source's first fallback pull.)"""
    w = rows(5, (64,))
    sh = NamedSharding(mesh(), P("x"))
    with anyio.fail_after(TIMEOUT_S):
        ref, _ = await ref_device_pull([{"w": jax.device_put(w, sh)}],
                                       {"w": np.zeros(64, BF16)}, BF16, tamper=True)
        ref2, _ = await ref_device_pull([{"w": jax.device_put(w + 1, sh)}],
                                        {"w": np.zeros(64, BF16)}, BF16, tamper=True)
        source, dest = DirectWeightSyncSource(use_shm=use_shm), DirectWeightSyncDest()
        try:
            src = torch.from_numpy(w.copy())
            await source.register({"w": src}, transfer_dtype=torch.bfloat16)
            info = tampered(source.device_info)
            assert dest._route(info) == "host" and dest._route(source.device_info) == "local"
            before = counts()
            target = torch.zeros(64, dtype=torch.bfloat16)
            await dest.pull_device([info], {"w": target})
            assert_same(target, ref["w"])
            src.add_(1)
            await source.refresh()
            await dest.pull_device([info], {"w": target})
            assert_same(target, ref2["w"])
            assert moved(before) == (0, 0, 2, 0)
            assert source.host_materializations == 2
            assert (len(source.segments) == 1) == use_shm
        finally:
            await dest.close()
            await source.close()


async def test_concurrent_fallback_pulls_share_one_staging(forced):
    """Two dests that cannot open the source's staging pull it at once (the
    RL fan-out): the host copy is made once per content generation and
    never moves the generation, so both see one stable generation, share
    ONE materialization and deliver exact dicts with one data attempt each.
    A publish invalidates the copy: the next fallback pull makes a new one
    and serves the new content. (The reference's twin of this test wraps
    ``_pull_once`` with a stub of its old two-argument signature; this one
    matches the port's.)"""
    w = rows(6, (16, 16))
    source = DirectWeightSyncSource(use_shm=True)
    dests = [DirectWeightSyncDest() for _ in range(2)]
    calls = {"mat": 0, "pull_once": 0}
    try:
        with anyio.fail_after(TIMEOUT_S):
            src = torch.from_numpy(w.copy())
            await source.register({"w": src})
            info = tampered(source.device_info)
            real_mat = source._materialize_host_handles

            def counting_mat():
                calls["mat"] += 1
                return real_mat()

            source._materialize_host_handles = counting_mat
            for d in dests:
                async def counted(handles, sd, key_order=None, on_layer=None,
                                  _real=d._pull_once):
                    calls["pull_once"] += 1
                    return await _real(handles, sd, key_order, on_layer)

                d._pull_once = counted
            gen = source._read_gen()
            outs = await asyncio.gather(*(d.pull_device([info], {"w": torch.zeros(16, 16)})
                                          for d in dests))
            for out in outs:
                assert_same(out["w"], w)
            assert calls == {"mat": 1, "pull_once": 2}
            assert source._read_gen() == gen
            src.mul_(2)
            await source.refresh()
            out = await dests[0].pull_device([info], {"w": torch.zeros(16, 16)})
            assert_same(out["w"], w * 2)
            assert calls["mat"] == 2
    finally:
        for d in dests:
            await d.close()
        await source.close()


# --------------------------------------------------------------------------
# what stays on (or is refused by) the device rung
# --------------------------------------------------------------------------


async def test_device_refresh_rejects_resharded_republish(forced):
    """A republish that keeps the shape but changes a leaf's placement must
    fail loudly: staging it against the published entries would land it at
    stale offsets. The port snapshots at publish, so the republish itself
    raises (and the generation stays); the JAX package stages per pull, so
    its pull raises."""
    sh0 = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    sh1 = jax.sharding.SingleDeviceSharding(jax.devices()[3])
    ref = RefSource()
    ref_dest = RefDest()
    try:
        await ref.register({"w": jax.device_put(jax.numpy.arange(32.0), sh0)})
        ref.update_sources({"w": jax.device_put(jax.numpy.arange(32.0) * 2, sh1)})
        await ref.refresh()
        with pytest.raises(Exception, match="re-register|no device-mode|stage"):
            await ref_dest.pull_device([ref.device_info], {"w": np.zeros(32, np.float32)})
    finally:
        await ref_dest.close()
        await ref.close()
    source = DirectWeightSyncSource(use_shm=False)
    dest = DirectWeightSyncDest()
    try:
        w = torch.arange(32.0)
        await source.register({"w": w})
        gen = source._read_gen()
        # Same shape, now the second half of a tensor twice as long.
        moved_to = tst.TensorSlice((32,), (32,), (64,), (1,), (2,))
        source.update_sources({"w": tst.Shard(w * 2, moved_to)})
        with pytest.raises(ValueError, match="re-register"):
            await source.refresh()
        assert source._read_gen() == gen
        out = await dest.pull_device([source.device_info], {"w": torch.zeros(32)})
        assert torch.equal(out["w"], w)  # the last publish, untouched
    finally:
        await dest.close()
        await source.close()


async def test_host_leaf_dict_stays_on_the_host_rung(port_store):
    """CPU leaves without a card take the host rung (handles, no device
    entries), as the JAX package's numpy dicts do."""
    w = rows(7, (128,))
    with anyio.fail_after(TIMEOUT_S):
        ref = RefSource(use_shm=False)  # no ts_shm_* segment (see test_torch_direct_ext)
        try:
            handles = await ref.register({"w": w})
            assert ref.device_info is None and handles["w"]
        finally:
            await ref.close()
        await tst.put_state_dict("h", {"w": torch.from_numpy(w.copy())}, direct=True,
                                 store_name=port_store)
        published = await tst.get("h/rank_0", store_name=port_store)
        assert published["handles"]["w"] and "device" not in published
        out = await tst.get_state_dict("h", {"w": torch.zeros(128)}, direct=True,
                                       store_name=port_store)
        assert_same(out["w"], w)
        assert tst.direct_sync_stats("h", store_name=port_store)["rung"] == "host"


@pytest.mark.parametrize("how", ["env", "device=False"])
async def test_ici_disabled_takes_the_host_rung(forced, monkeypatch, how):
    if how == "env":
        monkeypatch.setenv(port_config.ENV_ICI_ENABLED, "0")
        monkeypatch.setattr(port_config, "_default_config", None)
        source = DirectWeightSyncSource(use_shm=False)
    else:
        source = DirectWeightSyncSource(use_shm=False, device=False)
    dest = DirectWeightSyncDest()
    try:
        handles = await source.register({"w": torch.arange(32.0)})
        assert source.device_info is None and handles["w"]
        out = await dest.pull(handles, {"w": torch.zeros(32)})
        assert torch.equal(out["w"], torch.arange(32.0))
    finally:
        await dest.close()
        await source.close()


async def test_pull_after_close_raises_key_error(forced):
    """A closed source's staging is gone from the in-process route and its
    server stops: the pull raises KeyError (which the state-dict layer's
    one retry turns into fresh handles), and never reads the old staging."""
    source, dest = DirectWeightSyncSource(use_shm=False), DirectWeightSyncDest()
    try:
        await source.register({"w": torch.ones(8)})
        info = source.device_info
        await dest.pull_device([info], {"w": torch.zeros(8)})
        await source.close()
        assert dest._route(info) == "host"
        with pytest.raises(KeyError):
            await dest.pull_device([info], {"w": torch.zeros(8)})
    finally:
        await dest.close()
        await source.close()


async def test_staging_buffers_are_card_side_and_copy_free(forced):
    """``staging_state_dict`` hands out the staging views themselves: a
    trainer that writes into them publishes with nothing to copy."""
    source, dest = DirectWeightSyncSource(use_shm=False), DirectWeightSyncDest()
    try:
        await source.register({"w": torch.zeros(6), "step": 3})
        staged = source.staging_state_dict()
        assert staged["step"] == 3
        assert staged["w"].data_ptr() == source._blocks[0].data_ptr()
        staged["w"].fill_(5.0)
        source.update_sources(staged)
        await source.refresh()
        out = await dest.pull_device([source.device_info], {"w": torch.zeros(6)})
        assert torch.equal(out["w"], torch.full((6,), 5.0))
    finally:
        await dest.close()
        await source.close()
