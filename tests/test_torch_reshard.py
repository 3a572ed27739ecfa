"""Port parity for resharding through the store and direct sync: the same
seeded numpy tensors go through the JAX package (sharded ``jax.Array``s on
its 8 virtual CPU devices) and through the port (``Shard``s laid out by
``shards_from_numpy``, and DTensors on torch's fake process group), put in
one layout and fetched in another. The port's in-place ``Shard`` and
DTensor targets must equal the JAX result at every coordinate, bit for bit
(bf16 compared as uint16).

Each package runs one store session for all cases (``reference`` and
``port`` below); the tests hold their results against each other. The
multi-rank DTensor leg runs on 4 spawned gloo ranks against a store this
process starts (``test_torch_sp_worker``)."""

import asyncio
import contextlib
import uuid

import anyio
import jax
import ml_dtypes
import numpy as np
import pytest
import torch
import test_torch_sp_worker as worker
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P
from test_resharding import CASES
from test_torch_sharding import axis_spec, fake_rank, placements
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor

import torchstore_tpu as ts_ref
import torchstore_tpu_torch as tst
from torchstore_tpu import sharding as ref_shd
from torchstore_tpu import config as ref_config
from torchstore_tpu.config import StoreConfig as RefStoreConfig
from torchstore_tpu.direct_weight_sync import (
    DirectWeightSyncDest as RefDest,
    DirectWeightSyncSource as RefSource,
)
from torchstore_tpu.transport import shared_memory as ref_shm
from torchstore_tpu_torch import sharding

BF16 = ml_dtypes.bfloat16
GLOBAL = np.random.default_rng(2).standard_normal((16, 32)).astype(np.float32)
CUBE = np.random.default_rng(3).standard_normal((8, 8, 4)).astype(np.float32)
UNEVEN = np.random.default_rng(4).standard_normal((10, 6)).astype(np.float32)
ROWS = [(0, 4), (4, 7), (7, 10)]  # explicit uneven shards of UNEVEN

# name -> (array, source layout, destination layout); a layout is (mesh
# shape, axis names, PartitionSpec).
MATRIX = {f"case{i}": (GLOBAL, case[:3], case[3:]) for i, case in enumerate(CASES)}
MATRIX["hsdp"] = (GLOBAL, ((2, 4), ("dp", "fsdp"), P("fsdp")), ((8,), ("x",), P("x")))
MATRIX["cube-2d"] = (CUBE, ((8,), ("x",), P("x")), ((2, 4), ("x", "y"), P("y", None, "x")))

# A small state dict, FSDP-sharded for the trainer (dim 0 over 8) and
# tensor-parallel for the generator (4 coordinates: q on dim 1, o on dim 0,
# the norm replicated), as chip_smoke.py's reshard phase lays out
# Llama-3-8B.
_rng = np.random.default_rng(5)
TREE = {
    "q": _rng.standard_normal((16, 32)).astype(np.float32),
    "o": _rng.standard_normal((32, 16)).astype(np.float32),
    "norm": _rng.standard_normal(32).astype(np.float32),
}
TRAINER = ((8,), ("fsdp",), {"q": P("fsdp"), "o": P("fsdp"), "norm": P("fsdp")})
GENERATOR = ((4,), ("tp",), {"q": P(None, "tp"), "o": P("tp"), "norm": P()})
STEP = 7  # a non-tensor leaf rides along


def jax_array(arr, layout):
    mesh_shape, names, spec = layout
    devs = np.array(jax.devices()[: int(np.prod(mesh_shape))]).reshape(mesh_shape)
    return jax.device_put(arr, NamedSharding(Mesh(devs, names), spec))


def by_coords(arr) -> dict:
    """{mesh coordinates: host data} of a jax.Array's shards."""
    coords = ref_shd._mesh_coords_map(arr.sharding.mesh)
    return {coords[s.device]: np.asarray(s.data) for s in arr.addressable_shards}


def port_shards(arr, layout, dtype=None):
    mesh_shape, names, spec = layout
    return tst.shards_from_numpy(arr, mesh_shape, axis_spec(names, spec), "cpu", dtype)


def bits(x):
    x = x.view(torch.int16).numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(np.uint16) if x.dtype.itemsize == 2 else x


def tree_layout(layout, key):
    mesh_shape, names, specs = layout
    return mesh_shape, names, specs[key]


def run(coro_fn, *args):
    return asyncio.run(coro_fn(*args))


@contextlib.contextmanager
def reference_without_shm():
    # The reference over its RPC rung, without its stamped metadata and
    # one-sided planes: its results do not depend on the rung, and it adds
    # no ts_shm_* segments to the machine-wide counts of its own tests.
    # The process's default config is read from the environment once: it
    # must not be first read here, or the reference's own tests that run
    # later in this process would inherit these switches.
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_config, "_default_config", None)
        mp.setattr(ref_shm, "is_available", lambda: False)
        mp.setenv("TORCHSTORE_TPU_META_STAMPED", "0")
        mp.setenv("TORCHSTORE_TPU_ONE_SIDED", "0")
        yield RefStoreConfig(shm_enabled=False, bulk_tcp_enabled=False)


# --------------------------------------------------------------------------
# the two sessions
# --------------------------------------------------------------------------


async def reference_session() -> dict:
    store = f"ref_{uuid.uuid4().hex[:8]}"
    out: dict = {}
    with reference_without_shm() as config:
        await ts_ref.initialize(store_name=store, config=config)
        try:
            for name, (arr, src, dst) in MATRIX.items():
                await ts_ref.put(name, jax_array(arr, src), store_name=store)
                like = jax_array(np.zeros_like(arr), dst)
                out[name] = by_coords(await ts_ref.get(name, like=like, store_name=store))
            out["sharded_to_full"] = np.asarray(await ts_ref.get("case2", store_name=store))
            await ts_ref.put("plain", GLOBAL, store_name=store)
            like = jax_array(np.zeros_like(GLOBAL), ((4, 2), ("x", "y"), P("x", "y")))
            out["full_to_sharded"] = by_coords(
                await ts_ref.get("plain", like=like, store_name=store)
            )
            for i, (lo, hi) in enumerate(ROWS):
                sl = ts_ref.TensorSlice((lo, 0), (hi - lo, 6), UNEVEN.shape, (i,), (3,))
                await ts_ref.put("uneven", ts_ref.Shard(UNEVEN[lo:hi], sl), store_name=store)
            out["uneven"] = np.asarray(await ts_ref.get("uneven", store_name=store))
            want = ts_ref.TensorSlice((1, 3), (6, 20), GLOBAL.shape, (), ())
            out["slice_across"] = np.asarray(await ts_ref.get("case0", like=want,
                                                              store_name=store))
            await ts_ref.put("repub", jax_array(GLOBAL, ((8,), ("x",), P("x"))),
                             store_name=store)
            await ts_ref.put("repub", jax_array(GLOBAL * 10, ((2, 2), ("a", "b"), P("a", "b"))),
                             store_name=store)
            out["republish"] = np.asarray(await ts_ref.get("repub", store_name=store))
            sd = {k: jax_array(v, tree_layout(TRAINER, k)) for k, v in TREE.items()}
            sd["step"] = STEP
            await ts_ref.put_state_dict("sd", sd, transfer_dtype=BF16, store_name=store)
            targets = {k: jax_array(np.zeros(v.shape, BF16), tree_layout(GENERATOR, k))
                       for k, v in TREE.items()}
            got = await ts_ref.get_state_dict("sd", {**targets, "step": 0}, store_name=store)
            out["state_dict"] = {k: by_coords(got[k]) for k in TREE}
            out["state_dict_step"] = got["step"]
        finally:
            await ts_ref.shutdown(store)
    # The JAX package's direct sync (host path) between the same layouts.
    source, dest = RefSource(use_shm=False, device=False), RefDest()
    try:
        sd = {k: jax_array(v, tree_layout(TRAINER, k)) for k, v in TREE.items()}
        handles = await source.register(sd, transfer_dtype=BF16)
        targets = {k: jax_array(np.zeros(v.shape, BF16), tree_layout(GENERATOR, k))
                   for k, v in TREE.items()}
        got = await dest.pull(handles, targets)
        out["direct"] = {k: by_coords(got[k]) for k in TREE}
        source.update_sources({k: jax_array(v + 1.0, tree_layout(TRAINER, k))
                               for k, v in TREE.items()})
        await source.refresh()
        got = await dest.pull(handles, targets)
        out["direct_refreshed"] = {k: by_coords(got[k]) for k in TREE}
    finally:
        await dest.close()
        await source.close()
    return out


def dtensor_targets(arr, layout):
    """(coordinates, DTensor of zeros) at every rank of ``layout``."""
    mesh_shape, names, spec = layout
    world = int(np.prod(mesh_shape))
    for rank in range(world):
        with fake_rank(rank, world):
            mesh = init_device_mesh("cpu", mesh_shape, mesh_dim_names=names)
            yield mesh.get_coordinate(), mesh, placements(names, spec)


async def port_session() -> dict:
    store = f"port_{uuid.uuid4().hex[:8]}"
    out: dict = {"shard": {}, "dtensor": {}, "inplace": {}}
    await tst.initialize(store_name=store)
    client = tst.client(store)
    try:
        for name, (arr, src, dst) in MATRIX.items():
            for shard in port_shards(arr, src):
                await client.put(name, shard)
            res = {}
            for shard in port_shards(np.zeros_like(arr), dst):
                got = await client.get(name, shard)
                out["inplace"][name] = out["inplace"].get(name, True) and got is shard.data
                res[shard.tensor_slice.coordinates] = shard.data.numpy()
            out["shard"][name] = res
            # The same reshard with DTensors on each side, rank by rank.
            dkey = f"{name}_dt"
            for coords, mesh, pl in dtensor_targets(arr, src):
                await client.put(dkey, distribute_tensor(torch.from_numpy(arr), mesh, pl,
                                                         src_data_rank=None))
            res = {}
            for coords, mesh, pl in dtensor_targets(arr, dst):
                target = distribute_tensor(torch.zeros(arr.shape), mesh, pl, src_data_rank=None)
                got = await client.get(dkey, target)
                assert got is target
                res[tuple(coords)] = target.to_local().numpy().copy()
            out["dtensor"][name] = res
        out["sharded_to_full"] = (await client.get("case2")).numpy()
        await client.put("plain", torch.from_numpy(GLOBAL))
        out["full_to_sharded"] = {
            s.tensor_slice.coordinates: (await client.get("plain", s)).numpy()
            for s in port_shards(np.zeros_like(GLOBAL), ((4, 2), ("x", "y"), P("x", "y")))
        }
        for i, (lo, hi) in enumerate(ROWS):
            sl = tst.TensorSlice((lo, 0), (hi - lo, 6), UNEVEN.shape, (i,), (3,))
            await client.put("uneven", tst.Shard(torch.from_numpy(UNEVEN[lo:hi]), sl))
        out["uneven"] = (await client.get("uneven")).numpy()
        # Uneven into uneven: rows split 4/4/2 and columns 3/3 as torch splits.
        out["uneven_into"] = {}
        for r0, r1 in ((0, 4), (4, 8), (8, 10)):
            for c0, c1 in ((0, 3), (3, 6)):
                want = tst.TensorSlice((r0, c0), (r1 - r0, c1 - c0), UNEVEN.shape, (), ())
                out["uneven_into"][(r0, c0)] = (await client.get("uneven", want)).numpy()
        want = tst.TensorSlice((1, 3), (6, 20), GLOBAL.shape, (), ())
        before = client.parts_fetched
        out["slice_across"] = (await client.get("case0", want)).numpy()
        out["slice_across_parts"] = client.parts_fetched - before
        for shard in port_shards(GLOBAL, ((8,), ("x",), P("x"))):
            await client.put("repub", shard)
        for shard in port_shards(GLOBAL * 10, ((2, 2), ("a", "b"), P("a", "b"))):
            await client.put("repub", shard)
        out["republish"] = (await client.get("repub")).numpy()
        out["republish_keys"] = await client.keys()
        out.update(await port_state_dicts(store))
    finally:
        await tst.shutdown(store)
    return out


def rank_trees(layout, trees_of, dtype=None):
    """Per coordinate of ``layout`` (row-major), a state dict of the
    coordinate's ``Shard`` of every leaf of ``TREE`` and the step."""
    per_key = {k: port_shards(trees_of(v), tree_layout(layout, k), dtype)
               for k, v in TREE.items()}
    n = int(np.prod(layout[0]))
    return [{**{k: shards[c] for k, shards in per_key.items()}, "step": STEP} for c in range(n)]


async def port_state_dicts(store: str) -> dict:
    bf16 = torch.bfloat16
    out: dict = {}
    sources = rank_trees(TRAINER, lambda v: v)
    for rank, sd in enumerate(sources):
        await tst.put_state_dict("sd", sd, transfer_dtype=bf16, store_name=store)
    targets = rank_trees(GENERATOR, lambda v: np.zeros(v.shape, np.float32), bf16)
    res, steps = {k: {} for k in TREE}, set()
    for sd in targets:
        got = await tst.get_state_dict("sd", {**sd, "step": 0}, store_name=store)
        steps.add(got["step"])
        for k in TREE:
            assert got[k] is sd[k].data  # filled in place
            res[k][sd[k].tensor_slice.coordinates] = sd[k].data.clone()
    out["state_dict"], out["state_dict_steps"] = res, steps
    for rank, sd in enumerate(sources):
        await tst.put_state_dict("sd_direct", sd, transfer_dtype=bf16, direct=True,
                                 rank=rank, num_ranks=len(sources), store_name=store)
    for leg in ("direct", "direct_refreshed"):
        res = {k: {} for k in TREE}
        for sd in targets:
            await tst.get_state_dict("sd_direct", sd, direct=True, store_name=store)
            for k in TREE:
                res[k][sd[k].tensor_slice.coordinates] = sd[k].data.clone()
        out[leg] = res
        for rank, sd in enumerate(sources):
            for k in TREE:
                sd[k].data.add_(1.0)  # the training step, in place
            await tst.put_state_dict("sd_direct", sd, transfer_dtype=bf16, direct=True,
                                     rank=rank, num_ranks=len(sources), store_name=store)
    return out


@pytest.fixture(scope="module")
def reference():
    return run(reference_session)


@pytest.fixture(scope="module")
def port():
    return run(port_session)


def assert_coords_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for c, arr in want.items():
        np.testing.assert_array_equal(bits(got[c]), bits(arr), err_msg=str(c))


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(MATRIX))
def test_reshard_into_shards_matches_reference(reference, port, name):
    assert port["inplace"][name]
    assert_coords_equal(port["shard"][name], reference[name])


@pytest.mark.parametrize("name", list(MATRIX))
def test_reshard_dtensor_matches_reference(reference, port, name):
    assert_coords_equal(port["dtensor"][name], reference[name])


def test_sharded_to_full_and_full_to_sharded(reference, port):
    np.testing.assert_array_equal(port["sharded_to_full"], reference["sharded_to_full"])
    assert_coords_equal(port["full_to_sharded"], reference["full_to_sharded"])


def test_uneven_explicit_shards(reference, port):
    np.testing.assert_array_equal(port["uneven"], reference["uneven"])
    for (r0, c0), got in port["uneven_into"].items():
        np.testing.assert_array_equal(got, reference["uneven"][r0:r0 + got.shape[0],
                                                               c0:c0 + got.shape[1]])


def test_slice_read_across_shards(reference, port):
    np.testing.assert_array_equal(port["slice_across"], reference["slice_across"])
    # case0 stores 8 row shards of 2: rows 1..6 cross 4 of them.
    assert port["slice_across_parts"] == 4


def test_republish_under_another_layout(reference, port):
    np.testing.assert_array_equal(port["republish"], reference["republish"])
    np.testing.assert_array_equal(port["republish"], GLOBAL * 10)


@pytest.mark.parametrize("leg", ["state_dict", "direct", "direct_refreshed"])
def test_sharded_state_dict_matches_reference(reference, port, leg):
    for k in TREE:
        assert_coords_equal(port[leg][k], reference[leg][k])
    if leg == "state_dict":
        assert port["state_dict_steps"] == {reference["state_dict_step"]} == {STEP}


def test_refresh_moved_the_weights(port):
    assert not torch.equal(port["direct"]["q"][(0,)], port["direct_refreshed"]["q"][(0,)])


async def test_partial_commit_and_empty_shards():
    """A key is readable only once every coordinate is stored, empty ones
    included: torch splits 6 columns over 4 as 2, 2, 2, 0."""
    store = f"port_{uuid.uuid4().hex[:8]}"
    x = torch.from_numpy(UNEVEN)
    with anyio.fail_after(120):
        await tst.initialize(store_name=store)
        try:
            shards = []
            for rank in range(4):
                with fake_rank(rank, 4):
                    mesh = init_device_mesh("cpu", (4,))
                    dt = distribute_tensor(x, mesh, placements(("x",), (None, "x")),
                                           src_data_rank=None)
                    shards.append(tst.Shard(dt.to_local(), sharding.local_slice(dt)))
            assert shards[3].data.numel() == 0
            for shard in shards[:3]:
                await tst.put("p", shard, store_name=store)
            assert await tst.exists("p", store_name=store)  # present but partial
            with pytest.raises(KeyError, match="partially committed"):
                await tst.get("p", store_name=store)
            await tst.put("p", shards[3], store_name=store)
            assert torch.equal(await tst.get("p", store_name=store), x)
            with pytest.raises(ValueError, match="no tensor data"):
                await tst.put("w", tst.Shard(None, shards[0].tensor_slice), store_name=store)
            with pytest.raises(ValueError, match="local_shape"):
                await tst.put("w", tst.Shard(torch.zeros(3), shards[0].tensor_slice),
                              store_name=store)
        finally:
            await tst.shutdown(store)


async def test_shard_put_without_data_rejected_by_both():
    store = f"ref_{uuid.uuid4().hex[:8]}"
    sl = ts_ref.TensorSlice((0, 0), (4, 32), (16, 32), (0,), (4,))
    with reference_without_shm() as config:
        await ts_ref.initialize(store_name=store, config=config)
        try:
            with pytest.raises(ValueError, match="no tensor data"):
                await ts_ref.put("w", ts_ref.Shard(None, sl), store_name=store)
        finally:
            await ts_ref.shutdown(store)


async def test_dtensor_round_trip_on_four_gloo_ranks(reference):
    """Shard(0) on (4,) -> (Shard(0), Shard(1)) on (2, 2), four ranks each
    putting and getting their own shard through one store."""
    store = f"port_{uuid.uuid4().hex[:8]}"
    controller = await tst.initialize(store_name=store)
    try:
        results = await anyio.to_thread.run_sync(
            worker.spawn, "dtensor", {"controller": controller, "global": GLOBAL}
        )
    finally:
        await tst.shutdown(store)
    want = by_coords(jax_array(GLOBAL, ((2, 2), ("x", "y"), P("x", "y"))))
    assert_coords_equal({tuple(r["coords"]): r["local"] for r in results}, want)
    for r in results:
        assert r["filled_in_place"]
        np.testing.assert_array_equal(r["full"], GLOBAL)
