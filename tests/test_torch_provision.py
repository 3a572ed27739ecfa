"""Port parity for cold-start provisioning (the twin of
``tests/test_provision.py`` but for its two direct-path cases, which
``tests/test_torch_provision_direct.py`` twins, and of the manifest
key-order case of ``tests/test_streamed_sync.py``).

- The pure functions (manifest, planner, clamp) take the same inputs, made
  from a numpy seed, through the JAX package and the port; the results are
  equal: keys, shapes, dtype names, request sizes, segment sizes with and
  without arena packing, per-volume plans, kept and clamped bytes.
- The store-level behaviour (prewarm, the controller's reservations, the
  auto hint, ``WeightPublisher.register``) runs on the port alone and is
  held to the numbers the reference's own tests assert: the reference's
  segments are named ``ts_shm_`` and its leak tests count every such
  segment on the machine, so its shared-memory rung never runs here.
"""

import asyncio
import os
import uuid

import anyio
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Shard as DShard
from torch.distributed.tensor import distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore

import torchstore_tpu_torch as tst
from torchstore_tpu import provision as ref_provision
from torchstore_tpu.provision import planner as ref_planner
from torchstore_tpu.transport import bulk as ref_bulk
from torchstore_tpu_torch import provision
from torchstore_tpu_torch.provision import executors
from torchstore_tpu_torch.provision.manifest import ManifestEntry, StateDictManifest
from torchstore_tpu_torch.provision.planner import VolumePlan, clamp_to_grant, plan_provisioning
from torchstore_tpu_torch.transport import bulk
from torchstore_tpu_torch.transport import shared_memory as shm
from torchstore_tpu_torch.transport.shared_memory import ShmServerCache

TIMEOUT_S = 60
DTYPES = ("float32", "float16", "bfloat16", "float64", "int32", "int64", "int8", "uint8", "bool")
QUANT = [(None, 256), ("int8", 256), ("int8_block", 256), ("int8_block", 64),
         ("int4_block", 256), ("int4_block", 32)]


# --------------------------------------------------------------------------
# inputs from a numpy seed, one per package
# --------------------------------------------------------------------------


def _np_dtype(name: str):
    return ml_dtypes.bfloat16 if name == "bfloat16" else np.dtype(name)


def random_state_dicts(seed: int) -> tuple[dict, dict]:
    """(numpy state dict for the JAX package, torch twin for the port): the
    same nested keys, shapes (scalars, empty dims, tensors past the arena
    threshold) and dtypes, and non-tensor leaves the manifest skips."""
    rng = np.random.default_rng(seed)
    ref, port = {}, {}
    for layer in range(int(rng.integers(2, 5))):
        ref_layer, port_layer = {}, {}
        for leaf in range(int(rng.integers(1, 6))):
            rank = int(rng.integers(0, 4))
            shape = tuple(int(rng.choice([0, 1, 3, 64, 300, 700])) for _ in range(rank))
            name = str(rng.choice(DTYPES))
            ref_layer[f"w{leaf}"] = np.zeros(shape, _np_dtype(name))
            port_layer[f"w{leaf}"] = torch.zeros(shape, dtype=getattr(torch, name))
        ref_layer["step"] = port_layer["step"] = int(rng.integers(0, 100))
        ref[f"layer_{layer}"] = ref_layer
        port[f"layer_{layer}"] = port_layer
    big = (int(rng.integers(300, 400)), 256)  # over the 256 KiB arena threshold in fp32
    ref["embed"] = np.zeros(big, np.float32)
    port["embed"] = torch.zeros(big)
    ref["name"] = port["name"] = "policy"
    return ref, port


def entries_of(manifest) -> list:
    return [(e.key, tuple(e.shape), e.dtype, tuple(e.request_nbytes)) for e in manifest.entries]


def assert_same_manifest(ref, port) -> None:
    assert entries_of(port) == entries_of(ref)
    assert port.total_bytes == ref.total_bytes
    assert port.key_order == ref.key_order
    assert port.max_request_nbytes() == ref.max_request_nbytes()
    assert port.device_resident == ref.device_resident
    for arena in (0, 1024, 256 << 10, 1 << 30):
        assert port.segment_sizes(arena) == ref.segment_sizes(arena), arena
        assert port.arena_hint(arena) == ref.arena_hint(arena), arena


# --------------------------------------------------------------------------
# the manifest
# --------------------------------------------------------------------------


def test_manifest_from_numpy_state_dict():
    """The reference's state dict, as torch tensors in the port."""
    ref = ref_provision.StateDictManifest.from_state_dict(
        {"layers": {"0": np.zeros((4, 8), np.float32), "1": np.zeros((16,), np.float64)},
         "step": 7})
    m = StateDictManifest.from_state_dict(
        {"layers": {"0": torch.zeros(4, 8), "1": torch.zeros(16, dtype=torch.float64)},
         "step": 7})
    assert_same_manifest(ref, m)
    # The numbers the reference's test asserts.
    assert len(m.entries) == 2 and m.total_bytes == 256
    assert m.segment_sizes() == {128: 2} and not m.device_resident


def test_manifest_transfer_dtype_halves_floating_leaves():
    ref = ref_provision.StateDictManifest.from_state_dict(
        {"w": np.zeros((64,), np.float32), "ids": np.zeros((64,), np.int32)},
        transfer_dtype="bfloat16")
    m = StateDictManifest.from_state_dict(
        {"w": torch.zeros(64), "ids": torch.zeros(64, dtype=torch.int32)},
        transfer_dtype=torch.bfloat16)
    assert_same_manifest(ref, m)
    assert m.segment_sizes() == {128: 1, 256: 1}


def test_manifest_from_sharded_jax_array():
    """The reference's 4-way sharded (8, 4) f32 array: one request per
    shard. A torch rank holds one shard, so each rank's DTensor (and the
    same shard as a ``Shard``) gives that shard's request."""
    jax = pytest.importorskip("jax")
    from jax.sharding import NamedSharding, PartitionSpec as P

    from torchstore_tpu import parallel

    arr = np.arange(32, dtype=np.float32).reshape(8, 4)
    mesh = parallel.make_mesh({"x": 4})
    ref = ref_provision.StateDictManifest.from_state_dict(
        {"w": jax.device_put(arr, NamedSharding(mesh, P("x", None)))})
    (ref_entry,) = ref.entries
    assert ref_entry.request_nbytes == (32, 32, 32, 32)
    got = []
    for rank in range(4):
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=4)
        try:
            dmesh = init_device_mesh("cpu", (4,), mesh_dim_names=("x",))
            dt = distribute_tensor(torch.from_numpy(arr), dmesh, (DShard(0),),
                                   src_data_rank=None)
            m = StateDictManifest.from_state_dict({"w": dt})
        finally:
            dist.destroy_process_group()
        (entry,) = m.entries
        assert (entry.key, entry.shape, entry.dtype) == (ref_entry.key, ref_entry.shape,
                                                         ref_entry.dtype)
        assert m.segment_sizes() == {32: 1}
        got.extend(entry.request_nbytes)
        ts = tst.TensorSlice((2 * rank, 0), (2, 4), (8, 4), (rank,), (4,))
        shard = StateDictManifest.from_state_dict({"w": tst.Shard(torch.zeros(2, 4), ts)})
        assert shard.entries[0].request_nbytes == entry.request_nbytes
    assert tuple(got) == ref_entry.request_nbytes  # metadata only, no bytes moved


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("transfer", [None, "bfloat16", "float16"])
def test_manifest_equals_reference(seed, transfer):
    ref_sd, port_sd = random_state_dicts(seed)
    ref = ref_provision.StateDictManifest.from_state_dict(ref_sd, transfer_dtype=transfer)
    port = StateDictManifest.from_state_dict(
        port_sd, transfer_dtype=None if transfer is None else getattr(torch, transfer))
    assert_same_manifest(ref, port)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("quant,block", QUANT, ids=str)
def test_quant_manifest_equals_reference(seed, quant, block):
    """Floating leaves weighed as the fused blobs a quantized publish puts
    (scale slot included); other leaves as they are."""
    ref_sd, port_sd = random_state_dicts(seed)
    ref = ref_provision.StateDictManifest.from_state_dict(ref_sd, transfer_quant=quant,
                                                          quant_block=block)
    port = StateDictManifest.from_state_dict(port_sd, transfer_quant=quant, quant_block=block)
    assert_same_manifest(ref, port)


def test_manifest_key_order_preserves_insertion_order():
    sd = {"embed": torch.zeros(8), "layer_1": torch.zeros(8), "layer_0": torch.zeros(8),
          "meta": "not-a-tensor"}
    m = StateDictManifest.from_state_dict(sd)
    ref = ref_provision.StateDictManifest.from_state_dict(
        {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in sd.items()})
    assert_same_manifest(ref, m)
    assert [e.key for e in m.entries] == ["embed", "layer_0", "layer_1"]
    assert m.key_order == ["embed", "layer_1", "layer_0"]


def test_meta_tensors_make_a_manifest_before_weights_exist():
    """Tensors on the meta device carry shapes and dtypes only."""
    sd = {"w": torch.empty(1024, 512, device="meta"), "b": torch.empty(512, device="meta")}
    m = StateDictManifest.from_state_dict(sd, transfer_dtype=torch.bfloat16)
    real = StateDictManifest.from_state_dict({"w": torch.zeros(1024, 512), "b": torch.zeros(512)},
                                             transfer_dtype=torch.bfloat16)
    assert entries_of(m) == entries_of(real) and m.total_bytes == 1024 * 512 * 2 + 1024


# --------------------------------------------------------------------------
# the planner and the clamp
# --------------------------------------------------------------------------


def _plans_equal(ref, port) -> None:
    assert (port.manifest_bytes, port.replicas, port.device_server, port.planned_bytes,
            port.clamped_bytes) == (ref.manifest_bytes, ref.replicas, ref.device_server,
                                    ref.planned_bytes, ref.clamped_bytes)
    assert sorted(port.volumes) == sorted(ref.volumes)
    for vid, vp in port.volumes.items():
        rp = ref.volumes[vid]
        assert (vp.volume_id, vp.transport, vp.segment_sizes, vp.dials, vp.clamped_bytes,
                vp.planned_bytes) == (rp.volume_id, rp.transport, rp.segment_sizes, rp.dials,
                                      rp.clamped_bytes, rp.planned_bytes), vid


def test_plan_replication_fanout_and_transport_split():
    ref = ref_planner.plan_provisioning(
        ref_provision.StateDictManifest.from_state_dict({"a": np.zeros((1024,), np.float32)}),
        ["v0", "v1", "v2"], {"v0": "shm", "v1": "bulk", "v2": "rpc"})
    plan = plan_provisioning(StateDictManifest.from_state_dict({"a": torch.zeros(1024)}),
                             ["v0", "v1", "v2"], {"v0": "shm", "v1": "bulk", "v2": "rpc"})
    _plans_equal(ref, plan)
    assert plan.replicas == 3
    assert plan.volumes["v0"].segment_sizes == {4096: 1} and plan.volumes["v0"].dials == 0
    assert plan.volumes["v1"].segment_sizes == {} and plan.volumes["v1"].dials == 1
    assert plan.volumes["v2"].segment_sizes == {} and plan.volumes["v2"].dials == 0
    assert plan.planned_bytes == 4096  # only the shm leg carries segments


def test_plan_bulk_stripe_dials_above_threshold():
    assert (bulk.STRIPE_CONNS, bulk.STRIPE_THRESHOLD) == (ref_bulk.STRIPE_CONNS,
                                                          ref_bulk.STRIPE_THRESHOLD)
    for nbytes, dials in ((bulk.STRIPE_THRESHOLD, 1), (bulk.STRIPE_THRESHOLD + 1,
                                                       bulk.STRIPE_CONNS)):
        m = StateDictManifest(entries=[ManifestEntry("big", (1,), "float32", (nbytes,))])
        ref = ref_provision.StateDictManifest(
            entries=[ref_provision.ManifestEntry("big", (1,), "float32", (nbytes,))])
        plan = plan_provisioning(m, ["v0"], {"v0": "bulk"})
        _plans_equal(ref_planner.plan_provisioning(ref, ["v0"], {"v0": "bulk"}), plan)
        assert plan.volumes["v0"].dials == dials
        assert provision.expected_bulk_conns(m) == ref_provision.expected_bulk_conns(ref)


@pytest.mark.parametrize("seed", range(8))
def test_plan_and_clamp_equal_reference(seed):
    """Random manifests over random fleets, then random grants (none, zero,
    a fraction of the ask, more than it) on every volume."""
    ref_sd, port_sd = random_state_dicts(seed)
    rng = np.random.default_rng(100 + seed)
    vids = [f"v{i}" for i in range(int(rng.integers(1, 5)))]
    transports = {v: str(rng.choice(["shm", "bulk", "rpc"])) for v in vids}
    arena = int(rng.choice([0, 4096, 256 << 10]))
    ici = bool(rng.integers(0, 2))
    ref = ref_planner.plan_provisioning(ref_provision.StateDictManifest.from_state_dict(ref_sd),
                                        vids, transports, ici, arena)
    port = plan_provisioning(StateDictManifest.from_state_dict(port_sd), vids, transports, ici,
                             arena)
    _plans_equal(ref, port)
    for vid in vids:
        ask = port.volumes[vid].planned_bytes
        grant = rng.choice([None, 0, int(ask * rng.random()), ask + 1])
        grant = None if grant is None else int(grant)
        ref_planner.clamp_to_grant(ref.volumes[vid], grant)
        clamp_to_grant(port.volumes[vid], grant)
        assert port.volumes[vid].planned_bytes <= (ask if grant is None else grant)
    _plans_equal(ref, port)


@pytest.mark.parametrize("seed", range(8))
def test_clamp_equals_reference(seed):
    rng = np.random.default_rng(seed)
    sizes = {int(s): int(rng.integers(1, 6)) for s in rng.integers(1, 1 << 20, size=6)}
    want = sum(s * c for s, c in sizes.items())
    for grant in (None, 0, int(rng.integers(0, want)), want, want * 2):
        ref = ref_planner.clamp_to_grant(ref_planner.VolumePlan("v0", "shm", dict(sizes)), grant)
        port = clamp_to_grant(VolumePlan("v0", "shm", dict(sizes)), grant)
        assert (port.segment_sizes, port.clamped_bytes) == (ref.segment_sizes, ref.clamped_bytes)


def test_clamp_keeps_largest_segments_first():
    vp = VolumePlan("v0", "shm", segment_sizes={100: 3, 1000: 2, 10: 5})
    clamp_to_grant(vp, 2150)  # both 1000s and one 100: the big allocations win
    assert vp.segment_sizes == {1000: 2, 100: 1, 10: 5}
    assert vp.clamped_bytes == 200 and vp.planned_bytes <= 2150


def test_clamp_zero_grant_drops_plan_and_none_is_ungoverned():
    vp = VolumePlan("v0", "shm", segment_sizes={64: 2})
    clamp_to_grant(vp, 0)
    assert vp.segment_sizes == {} and vp.clamped_bytes == 128
    vp2 = VolumePlan("v0", "shm", segment_sizes={64: 2})
    clamp_to_grant(vp2, None)
    assert vp2.segment_sizes == {64: 2} and vp2.clamped_bytes == 0


def test_clamp_ignores_non_shm_legs():
    vp = VolumePlan("v0", "bulk", dials=4)
    clamp_to_grant(vp, 0)
    assert vp.dials == 4


# --------------------------------------------------------------------------
# the volume's pool provisioning, on the cache
# --------------------------------------------------------------------------


async def test_pool_provision_counts_the_pool_and_clamps_to_the_cap():
    """Largest first within the pool cap; pooled and reserved segments
    count against the want; a second provision makes nothing."""
    cache = ShmServerCache()
    cache.pool_cap = 3 * 8192 + 4096
    try:
        got = await cache.provision({8192: 3, 4096: 2, 1024: 1})
        assert (got["created"], got["bytes"], got["clamped_bytes"]) == (4, 3 * 8192 + 4096,
                                                                         4096 + 1024)
        assert sorted(size for _, size in got["names"]) == [4096, 8192, 8192, 8192]
        assert cache.free_bytes == 3 * 8192 + 4096
        seg = cache.take_free(8192)
        cache.reserved[seg.name] = (seg, 0.0)
        again = await cache.provision({8192: 3, 4096: 1})
        assert (again["created"], again["already_pooled"]) == (0, 4)
        assert cache.stats()["segments_created"] == 4
    finally:
        cache.clear()
    assert not any(os.path.exists(shm.ShmSegment.path(n)) for n, _ in got["names"])


async def test_clear_during_provision_unlinks_what_it_made(monkeypatch):
    """A volume cleared while its provisioning runs leaks no segment."""
    cache = ShmServerCache()
    made = []
    create = shm.ShmSegment.create_provisioned

    def slow_create(size, nthreads=0):
        seg = create(size, nthreads)
        made.append(seg.name)
        cache.clear()  # the clear lands while the segments are being made
        return seg

    monkeypatch.setattr(shm.ShmSegment, "create_provisioned", staticmethod(slow_create))
    got = await cache.provision({4096: 2})
    assert len(made) == 2 and got["created"] == 0 and got["names"] == []
    assert got["rotation"] == 0 and not cache.rotation  # no twin after the clear either
    assert not any(os.path.exists(shm.ShmSegment.path(n)) for n in made)


async def test_provision_makes_twins_within_the_cap_for_the_second_put():
    """Each segment made gets a twin, largest first within what the cap
    leaves, populated in the background; the twins count against the cap
    and the next provision's budget, and a clear unlinks them."""
    cache = ShmServerCache()
    cache.pool_cap = 3 * 8192 + 4096 + 8192 + 4096
    try:
        got = await cache.provision({8192: 3, 4096: 1})
        assert (got["created"], got["bytes"]) == (4, 3 * 8192 + 4096)
        assert (got["rotation"], got["rotation_bytes"]) == (2, 8192 + 4096)
        stats = cache.stats()
        assert stats["rotation_segments"] == 2 and stats["segments_created"] == 6
        assert cache.spare_bytes() == cache.pool_cap
        await cache.wait_warmups()
        assert cache.stats()["warming"] == 0 and cache.unpopulated_bytes() == 0
        twins = [t.name for ts in cache.rotation.values() for t in ts]
        assert (await cache.provision({1024: 1}))["clamped_bytes"] == 1024  # cap is full
    finally:
        cache.clear()
    assert not any(os.path.exists(shm.ShmSegment.path(n)) for n in twins)


# --------------------------------------------------------------------------
# prewarm on a store: it never raises, and the lazy path always serves
# --------------------------------------------------------------------------


async def _round_trip(sd: dict, store: str, key: str = "k/sd") -> None:
    await tst.put_state_dict(key, sd, store_name=store)
    out = await tst.get_state_dict(key, store_name=store)
    for name, value in sd.items():
        assert torch.equal(out[name], value), name


async def _volume_created(store: str) -> int:
    stats = await tst.client(store).controller.stats.call_one(include_volumes=True)
    return sum(v.get("shm", {}).get("segments_created", 0) for v in stats["volumes"].values())


@pytest.fixture
def store_name():
    return f"pv_{uuid.uuid4().hex[:8]}"


async def test_prewarm_on_uninitialized_store_reports_not_raises(store_name):
    before = executors.ERRORS.total()
    report = await tst.prewarm({"w": torch.zeros(8)}, store_name="no_such_store")
    assert report["ok"] is False and report["errors"]
    assert executors.ERRORS.total() > before
    # A store that exists serves on the lazy path meanwhile.
    await tst.initialize(store_name=store_name)
    try:
        with anyio.fail_after(TIMEOUT_S):
            await _round_trip({"w": torch.arange(8.0)}, store_name)
    finally:
        await tst.shutdown(store_name)


async def test_prewarm_volume_executor_failure_degrades_to_lazy_path(monkeypatch, store_name):
    """A broken volume-side provisioner (colocated, so the patch reaches it)
    leaves ok False with the stage named, counts the error, and the put and
    get after it work unchanged."""
    async def boom(self, sizes):
        raise RuntimeError("injected provision failure")

    await tst.initialize(store_name=store_name, colocated=True)
    try:
        with anyio.fail_after(TIMEOUT_S):
            monkeypatch.setattr(ShmServerCache, "provision", boom)
            sd = {"w": torch.from_numpy(np.random.default_rng(0).random(65536, np.float32))}
            before = executors.ERRORS.total()
            report = await tst.prewarm(sd, store_name=store_name)
            assert report["ok"] is False
            assert any(k.startswith("volume:") for k in report["errors"])
            assert executors.ERRORS.total() > before
            await _round_trip(sd, store_name)
    finally:
        await tst.shutdown(store_name)


async def test_prewarm_clamped_by_tiny_pool_then_sync_succeeds(store_name):
    """A pool cap far under the working set: the grant clamps the plan
    (nothing made, the clamped bytes reported) and the sync completes on
    the lazy path."""
    await tst.initialize(store_name=store_name,
                         config=tst.StoreConfig(shm_pool_max_bytes=4096, prewarm_auto=False))
    try:
        with anyio.fail_after(TIMEOUT_S):
            rng = np.random.default_rng(1)
            sd = {str(i): torch.from_numpy(rng.random(65536, np.float32)) for i in range(4)}
            report = await tst.prewarm(sd, store_name=store_name)
            assert report["segments"] == 0
            assert report["clamped_bytes"] >= 4 * 262144 - 4096
            await _round_trip(sd, store_name)
    finally:
        await tst.shutdown(store_name)


async def test_first_put_after_prewarm_creates_zero_segments(store_name):
    """After prewarm of the working set the first put draws every segment
    from the provisioned pool: the volume creates none across it, the
    client creates none cold, and its one offer (the arena) is a hit."""
    await tst.initialize(store_name=store_name,
                         strategy=tst.SingletonStrategy(default_transport_type="shm"),
                         config=tst.StoreConfig(prewarm_auto=False))
    try:
        with anyio.fail_after(TIMEOUT_S):
            rng = np.random.default_rng(2)
            sd = {"layers": {str(i): torch.from_numpy(rng.random(65536, np.float32))
                             for i in range(3)}}
            report = await tst.prewarm(sd, store_name=store_name)
            assert report["ok"] and not report["errors"], report
            # 256 KiB is the arena threshold: the three tensors pack into one
            # arena segment, which is what the first put's handshake asks for.
            assert report["segments"] == 1 and report["bytes"] == 3 * 262144
            assert report["pre_attached"] == 1
            client = tst.client(store_name)
            created = await _volume_created(store_name)
            mine = client.shm_stats()
            await tst.put_state_dict("m/sd", sd, store_name=store_name)
            assert await _volume_created(store_name) == created, "the first put created segments"
            after = client.shm_stats()
            assert after["cold_create"] == mine["cold_create"]
            assert after["offer_hit"] == mine["offer_hit"] + 1
            out = await tst.get_state_dict("m/sd", store_name=store_name)
            for k, v in sd["layers"].items():
                assert torch.equal(out["layers"][k], v)
    finally:
        await tst.shutdown(store_name)


async def test_second_put_after_prewarm_draws_the_twin_spares(store_name):
    """The first put after a prewarm takes the provisioned set and
    announces its twins; the second put, while the first is live, is
    offered those spares: no segment made by the volume or the client
    across it, and the get returns the second put's values."""
    await tst.initialize(store_name=store_name,
                         strategy=tst.SingletonStrategy(default_transport_type="shm"),
                         config=tst.StoreConfig(prewarm_auto=False))
    try:
        with anyio.fail_after(TIMEOUT_S):
            rng = np.random.default_rng(6)
            sd = {"big": torch.from_numpy(rng.random(131072, np.float32)),
                  "layers": {str(i): torch.from_numpy(rng.random(1024, np.float32))
                             for i in range(3)}}
            report = await tst.prewarm(sd, store_name=store_name)
            assert report["ok"] and not report["errors"], report
            # One segment for the big tensor, one arena for the three small.
            assert (report["segments"], report["rotation_segments"]) == (2, 2)
            assert report["rotation_bytes"] == report["bytes"]
            client = tst.client(store_name)
            await tst.put_state_dict("m/sd", sd, store_name=store_name)
            stats = await client.controller.stats.call_one(include_volumes=True)
            (vstats,) = stats["volumes"].values()
            assert vstats["shm"]["spares_announced"] == 2
            assert vstats["shm"]["rotation_segments"] == 0
            created = await _volume_created(store_name)
            mine = client.shm_stats()
            second = {"big": sd["big"] + 1, "layers": {k: v * 2 for k, v in sd["layers"].items()}}
            await tst.put_state_dict("m/sd", second, store_name=store_name)
            assert await _volume_created(store_name) == created, "the second put created segments"
            after = client.shm_stats()
            assert after["cold_create"] == mine["cold_create"]
            assert after["offer_hit"] == mine["offer_hit"] + 2
            stats = await client.controller.stats.call_one(include_volumes=True)
            (vstats,) = stats["volumes"].values()
            assert vstats["shm"]["offers"]["spare"] == 2 and vstats["shm"]["offers"]["miss"] == 0
            out = await tst.get_state_dict("m/sd", store_name=store_name)
            assert torch.equal(out["big"], second["big"])
            for k, v in second["layers"].items():
                assert torch.equal(out["layers"][k], v)
    finally:
        await tst.shutdown(store_name)


async def test_prewarm_bulk_predials_promoted_connection(store_name):
    await tst.initialize(store_name=store_name,
                         strategy=tst.SingletonStrategy(default_transport_type="bulk"),
                         config=tst.StoreConfig(prewarm_auto=False))
    try:
        with anyio.fail_after(TIMEOUT_S):
            sd = {"w": torch.from_numpy(np.random.default_rng(3).random(65536, np.float32))}
            report = await tst.prewarm(sd, store_name=store_name)
            assert report["ok"] and not report["errors"], report
            assert report["dials"] == 1
            assert report["skipped"] == {"registrations": executors.REGISTRATIONS_SKIPPED}
            client = tst.client(store_name)
            volume = next(iter(client._volume_refs.values()))
            cache = volume.transport_context.get_cache(bulk.BulkClientCache)
            conn = cache.get_alive(volume.volume_id)
            assert conn is not None
            await tst.put_state_dict("m/sd", sd, store_name=store_name)
            # The put rode the pre-dialed promoted connection, not a fresh one.
            assert cache.get_alive(volume.volume_id) is conn
            out = await tst.get_state_dict("m/sd", store_name=store_name)
            assert torch.equal(out["w"], sd["w"])
    finally:
        await tst.shutdown(store_name)


async def test_auto_prewarm_hint_fires_once_per_signature(store_name):
    config = tst.StoreConfig(prewarm_auto=True, prewarm_auto_min_bytes=1024)
    await tst.initialize(store_name=store_name, config=config)
    try:
        with anyio.fail_after(TIMEOUT_S):
            sd = {"w": torch.from_numpy(np.random.default_rng(4).random(65536, np.float32))}
            before = executors.RUNS.total()
            await tst.put_state_dict("m/sd", sd, store_name=store_name)
            assert executors.RUNS.total() == before + 1  # fired ahead of the commit
            await tst.put_state_dict("m/sd", sd, store_name=store_name)
            assert executors.RUNS.total() == before + 1  # same signature: once only
            await tst.put_state_dict("m2/sd", sd, store_name=store_name)
            assert executors.RUNS.total() == before + 1  # another key, same signature
            await tst.put_state_dict("tiny/sd", {"w": torch.zeros(4)}, store_name=store_name)
            assert executors.RUNS.total() == before + 1  # below min_bytes: no hint
            out = await tst.get_state_dict("m2/sd", store_name=store_name)
            assert torch.equal(out["w"], sd["w"])
    finally:
        await tst.shutdown(store_name)


async def _headroom(client, vid: str) -> int:
    cap = await client._volume_refs[vid].actor.shm_capacity.call_one()
    return min(cap["available_bytes"], cap["pool_cap"] - cap["pool_bytes"])


async def test_reservations_prevent_oversubscription(store_name):
    """Two reservations cannot both take the headroom; a release returns
    it; the reserved-bytes gauge follows and reads 0 after shutdown."""
    await tst.initialize(store_name=store_name, config=tst.StoreConfig(prewarm_auto=False))
    try:
        with anyio.fail_after(TIMEOUT_S):
            client = tst.client(store_name)
            await client._ensure_setup()
            vid = next(iter(client._volume_refs))
            ask = await _headroom(client, vid)
            reserve = client.controller.reserve_prewarm.call_one
            r1 = await reserve("r1", {vid: ask})
            assert r1["grants"][vid] == ask
            r2 = await reserve("r2", {vid: ask})
            assert r2["grants"][vid] == 0  # fully reserved
            gauge = (await client.controller.stats.call_one())["metrics"][
                "ts_prewarm_reserved_bytes"]
            assert [s["value"] for s in gauge["series"]] == [ask]
            await client.controller.release_prewarm.call_one("r1")
            r3 = await reserve("r3", {vid: ask})
            assert r3["grants"][vid] == ask  # the release returned the capacity
            await client.controller.release_prewarm.call_one("r2")
            await client.controller.release_prewarm.call_one("r3")
            await client.controller.release_prewarm.call_one("r3")  # idempotent
            r4 = await reserve("r4", {vid: ask})  # left for the teardown to clear
            assert r4["grants"][vid] == ask
            await client.controller.teardown.call_one()
            gauge = (await client.controller.stats.call_one())["metrics"][
                "ts_prewarm_reserved_bytes"]
            assert [s["value"] for s in gauge["series"]] == [0]
    finally:
        await tst.shutdown(store_name)


async def test_reservations_net_tmpfs_per_host(store_name):
    """Co-located volumes share /dev/shm: their grants are netted against
    one host budget, not each volume's own view of the same tmpfs."""
    await tst.initialize(store_name=store_name, num_storage_volumes=2,
                         config=tst.StoreConfig(prewarm_auto=False))
    try:
        with anyio.fail_after(TIMEOUT_S):
            client = tst.client(store_name)
            await client._ensure_setup()
            vids = sorted(client._volume_refs)
            avail = shm.shm_available_bytes()
            # Pool caps far above tmpfs: the host budget binds. Each volume
            # asks 80% of the tmpfs.
            big = tst.StoreConfig(shm_pool_max_bytes=avail * 4, prewarm_auto=False)
            ask = int(avail * 0.8)
            res = await client.controller.reserve_prewarm.call_one(
                "host1", {vids[0]: ask, vids[1]: ask}, config=big)
            grants = res["grants"]
            assert sum(grants.values()) <= avail, (grants, avail)
            assert grants[vids[1]] < ask  # the second volume got the remainder only
            await client.controller.release_prewarm.call_one("host1")
    finally:
        await tst.shutdown(store_name)


async def test_concurrent_reservations_cannot_overgrant(store_name):
    """Two reservations issued at once (the endpoint suspends on the
    volumes' capacity RPCs) grant no more than the headroom together: the
    placeholder set before the await closes the race."""
    await tst.initialize(store_name=store_name, config=tst.StoreConfig(prewarm_auto=False))
    try:
        with anyio.fail_after(TIMEOUT_S):
            client = tst.client(store_name)
            await client._ensure_setup()
            vid = next(iter(client._volume_refs))
            headroom = await _headroom(client, vid)
            reserve = client.controller.reserve_prewarm.call_one
            r1, r2 = await asyncio.gather(reserve("c1", {vid: headroom}),
                                          reserve("c2", {vid: headroom}))
            assert r1["grants"][vid] + r2["grants"][vid] <= headroom, (r1, r2)
            await client.controller.release_prewarm.call_one("c1")
            await client.controller.release_prewarm.call_one("c2")
    finally:
        await tst.shutdown(store_name)


async def test_weight_publisher_register_prewarms_channel(store_name):
    await tst.initialize(store_name=store_name, config=tst.StoreConfig(prewarm_auto=False))
    try:
        with anyio.fail_after(TIMEOUT_S):
            sd = {"w": torch.from_numpy(np.random.default_rng(5).random(65536, np.float32))}
            pub = tst.WeightPublisher("policy", store_name=store_name)
            report = await pub.register(sd)
            assert report["ok"] and report["segments"] == 1, report
            created = await _volume_created(store_name)
            version = await pub.publish(sd)
            assert await _volume_created(store_name) == created  # no cold segment
            sub = tst.WeightSubscriber("policy", store_name=store_name)
            out, got = await sub.acquire(timeout=60.0)
            assert got == version and torch.equal(out["w"], sd["w"])
            # A quantized channel provisions for its blobs.
            qpub = tst.WeightPublisher("q", store_name=store_name, transfer_quant="int8_block")
            qreport = await qpub.register(sd)
            ref = ref_provision.StateDictManifest.from_state_dict(
                {"w": sd["w"].numpy()}, transfer_quant="int8_block")
            assert qreport["ok"] and qreport["bytes"] == ref.total_bytes, qreport
    finally:
        await tst.shutdown(store_name)
