"""Port parity for the sharding layer: the DTensor bridge
(``torchstore_tpu_torch/sharding.py``), ``shards_from_numpy``, and the
reshard helpers of ``utils.py`` and ``transport/types.py`` against the JAX
package on its 8 virtual CPU devices.

Every layout of ``tests/test_resharding.py`` (plus HSDP and a 3-D tensor on
a 2-D mesh) is built on both sides: a ``NamedSharding`` on the JAX mesh,
and at every rank of torch's fake process group a DTensor with the
matching placements (mesh dimension i shards tensor dimension d when the
PartitionSpec names axis i at d). Rank r's coordinates are those of JAX
device r. The port's ``TensorSlice`` of each coordinate must equal the one
the JAX package's ``put_requests`` and ``target_slices`` give, exactly."""

import contextlib

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P
from test_resharding import CASES
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, distribute_tensor
from torch.distributed.tensor import Shard as DShard
from torch.testing._internal.distributed.fake_pg import FakeStore

import torchstore_tpu_torch as tst
from torchstore_tpu import sharding as ref_shd
from torchstore_tpu import utils as ref_utils
from torchstore_tpu.transport import types as ref_types
from torchstore_tpu_torch import sharding
from torchstore_tpu_torch import utils as port_utils
from torchstore_tpu_torch.state_dict_utils import _leaf_signature
from torchstore_tpu_torch.transport import types as port_types

GLOBAL = np.random.default_rng(0).standard_normal((16, 32)).astype(np.float32)
CUBE = np.random.default_rng(1).standard_normal((4, 8, 6)).astype(np.float32)

# (mesh shape, axis names, PartitionSpec) of every layout held here: both
# sides of each resharding case, HSDP, and a 3-D tensor on a 2-D mesh.
LAYOUTS = {f"case{i}-{side}": layout for i, case in enumerate(CASES)
           for side, layout in (("src", case[:3]), ("dst", case[3:]))}
LAYOUTS["hsdp"] = ((2, 4), ("dp", "fsdp"), P("fsdp"))
LAYOUTS["cube-2d"] = ((2, 4), ("x", "y"), P("y", None, "x"))


def placements(names, spec) -> tuple:
    """DTensor placements of a PartitionSpec: one per mesh axis."""
    out = []
    for name in names:
        dims = [d for d, entry in enumerate(spec)
                if entry == name or (isinstance(entry, tuple) and name in entry)]
        out.append(DShard(dims[0]) if dims else Replicate())
    return tuple(out)


def axis_spec(names, spec) -> tuple:
    """The PartitionSpec with axis indices in place of names."""
    return tuple(None if e is None else names.index(e) for e in spec)


@contextlib.contextmanager
def fake_rank(rank: int, world: int):
    """This process as ``rank`` of a fake process group of ``world`` ranks:
    meshes and DTensors without collectives."""
    if dist.is_initialized():  # left by a generator an earlier failure abandoned
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def dtensors(arr, mesh_shape, names, spec):
    """Rank r's DTensor of ``arr`` for every rank r, as (rank, DTensor)."""
    world = int(np.prod(mesh_shape))
    for rank in range(world):
        with fake_rank(rank, world):
            mesh = init_device_mesh("cpu", mesh_shape, mesh_dim_names=names)
            dt = distribute_tensor(torch.from_numpy(arr), mesh, placements(names, spec),
                                   src_data_rank=None)
            yield rank, dt


def jax_array(arr, mesh_shape, names, spec):
    devs = np.array(jax.devices()[: int(np.prod(mesh_shape))]).reshape(mesh_shape)
    return jax.device_put(arr, NamedSharding(Mesh(devs, names), spec))


def slice_fields(ts) -> tuple:
    return (ts.offsets, ts.local_shape, ts.global_shape, ts.coordinates, ts.mesh_shape)


def layout_arr(name):
    return CUBE if name == "cube-2d" else GLOBAL


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_put_requests_match_jax(name):
    mesh_shape, names, spec = LAYOUTS[name]
    arr = layout_arr(name)
    ref = {r.tensor_slice.coordinates: r for r in
           ref_shd.put_requests("w", jax_array(arr, mesh_shape, names, spec))}
    assert len(ref) == int(np.prod(mesh_shape))
    for rank, dt in dtensors(arr, mesh_shape, names, spec):
        (req,) = sharding.put_requests("w", dt)
        want = ref[req.tensor_slice.coordinates]
        assert req.tensor_slice.coordinates == tuple(np.unravel_index(rank, mesh_shape))
        assert slice_fields(req.tensor_slice) == slice_fields(want.tensor_slice)
        np.testing.assert_array_equal(req.tensor_val.numpy(), np.asarray(want.tensor_val))
        assert req.meta_only().tensor_slice == req.tensor_slice


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_target_slices_match_jax(name):
    mesh_shape, names, spec = LAYOUTS[name]
    arr = layout_arr(name)
    like = jax_array(np.zeros_like(arr), mesh_shape, names, spec)
    ref = {ts.coordinates: ts for _, ts in ref_shd.target_slices(like)}
    for _, dt in dtensors(np.zeros_like(arr), mesh_shape, names, spec):
        ts = sharding.target_slice(dt)
        assert slice_fields(ts) == slice_fields(ref[ts.coordinates])
        assert tuple(sharding.local_tensor(dt).shape) == ts.local_shape


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_shards_from_numpy_match_jax(name):
    mesh_shape, names, spec = LAYOUTS[name]
    arr = layout_arr(name)
    ref = {r.tensor_slice.coordinates: r for r in
           ref_shd.put_requests("w", jax_array(arr, mesh_shape, names, spec))}
    shards = tst.shards_from_numpy(arr, mesh_shape, axis_spec(names, spec), "cpu")
    assert [s.tensor_slice.coordinates for s in shards] == list(np.ndindex(*mesh_shape))
    for s in shards:
        want = ref[s.tensor_slice.coordinates]
        assert slice_fields(s.tensor_slice) == slice_fields(want.tensor_slice)
        np.testing.assert_array_equal(s.data.numpy(), np.asarray(want.tensor_val))


def test_shards_from_numpy_bf16_and_uneven():
    x = GLOBAL[:, :6]
    shards = tst.shards_from_numpy(x, (2,), (None, 0), "cpu", dtype=torch.bfloat16)
    for s in shards:
        want = x[s.tensor_slice.box.to_index()].astype(ml_dtypes.bfloat16).view(np.uint16)
        np.testing.assert_array_equal(s.data.view(torch.int16).numpy().view(np.uint16), want)
    with pytest.raises(ValueError, match="does not split"):
        tst.shards_from_numpy(x, (4,), (None, 0), "cpu")


def test_demotion_and_partial():
    """A mesh of one rank or an all-Replicate placement is a plain tensor
    (as the JAX package demotes single-device and fully replicated
    arrays); a Partial placement is refused."""
    g = torch.from_numpy(GLOBAL)
    for rank in range(4):
        with fake_rank(rank, 4):
            mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("a", "b"))
            rep = distribute_tensor(g, mesh, (Replicate(), Replicate()), src_data_rank=None)
            (req,) = sharding.put_requests("w", rep)
            assert req.tensor_slice is None and torch.equal(req.tensor_val, g)
            assert sharding.target_slice(rep) == port_types.full_slice(GLOBAL.shape)
            sub = sharding.local_slice(
                distribute_tensor(g, mesh["a"], (DShard(0),), src_data_rank=None)
            )  # a sub-mesh of 2 ranks
            assert sub.mesh_shape == (2,) and sub.coordinates == (rank // 2,)
            part = DTensor.from_local(torch.zeros(2), mesh, (Partial(), Replicate()),
                                      run_check=False)
            with pytest.raises(ValueError, match="Partial"):
                sharding.put_requests("w", part)
    with fake_rank(0, 1):
        single = init_device_mesh("cpu", (1,))
        dt = distribute_tensor(g, single, (DShard(0),), src_data_rank=None)
        assert sharding.local_slice(dt) is None
    assert ref_shd._is_demotable(jax_array(GLOBAL, (1,), ("x",), P("x")).sharding)


def test_uneven_and_empty_local_slices():
    """torch's Shard splits unevenly (ceil-sized pieces): (10, 6) on dim 1
    over 4 gives widths 2, 2, 2, 0; the empty coordinate still has a slice,
    so its put counts toward the commit."""
    x = torch.arange(60.0).reshape(10, 6)
    widths, offsets = [], []
    for rank in range(4):
        with fake_rank(rank, 4):
            mesh = init_device_mesh("cpu", (4,))
            dt = distribute_tensor(x, mesh, (DShard(1),), src_data_rank=None)
            (req,) = sharding.put_requests("w", dt)
            ts = req.tensor_slice
            assert ts.coordinates == (rank,) and ts.mesh_shape == (4,)
            assert torch.equal(req.tensor_val, x[ts.box.to_index()])
            widths.append(ts.local_shape[1])
            offsets.append(ts.offsets[1])
    assert widths == [2, 2, 2, 0] and offsets == [0, 2, 4, 6]


def test_plan_signature_includes_mesh_and_placements():
    g = torch.from_numpy(GLOBAL)
    sigs = set()
    for layout in ((4,), (2, 2)):
        for spec in ((DShard(0),), (DShard(1),)):
            if len(layout) == 2:
                spec = spec + (Replicate(),)
            with fake_rank(0, 4):
                mesh = init_device_mesh("cpu", layout)
                sigs.add(_leaf_signature(distribute_tensor(g, mesh, spec, src_data_rank=None)))
    assert len(sigs) == 4
    ts = port_types.full_slice((16, 32))
    assert _leaf_signature(tst.Shard(None, ts)) != _leaf_signature(
        tst.Shard(None, ts.with_box(port_utils.Box((0, 0), (8, 32))))
    )
    assert sharding.plan_signature(g) is None and not sharding.is_dtensor(g)


# --------------------------------------------------------------------------
# utils and types
# --------------------------------------------------------------------------


def parts_of(arr, boxes):
    return [(arr[b.to_index()], b.offsets) for b in boxes]


@pytest.mark.parametrize(
    "boxes",
    [
        [((0, 0), (8, 32)), ((8, 0), (8, 32))],
        [((0, 0), (8, 16)), ((0, 16), (8, 16)), ((8, 0), (8, 16)), ((8, 16), (8, 16))],
        [((2, 4), (3, 2))],
        [((0, 0), (16, 32)), ((0, 0), (16, 32))],  # replicas overlap fully
        [((4, 0), (4, 32)), ((8, 0), (2, 32))],  # an offset region
    ],
    ids=["rows", "quadrants", "single", "replicas", "offset"],
)
def test_assemble_tensor_matches_reference(boxes):
    boxes = [port_utils.Box(*b) for b in boxes]
    ref_out, ref_off = ref_utils.assemble_tensor(parts_of(GLOBAL, boxes))
    out, off = port_utils.assemble_tensor(parts_of(torch.from_numpy(GLOBAL), boxes))
    assert off == ref_off
    np.testing.assert_array_equal(out.numpy(), ref_out)
    ref_bbox = ref_utils.bounding_box([ref_utils.Box(b.offsets, b.shape) for b in boxes])
    bbox = port_utils.bounding_box(boxes)
    assert (bbox.offsets, bbox.shape) == (ref_bbox.offsets, ref_bbox.shape)


def test_assemble_tensor_refuses_holes_and_mixed_dtypes():
    t = torch.from_numpy(GLOBAL)
    with pytest.raises(ValueError, match="uncovered"):
        port_utils.assemble_tensor([(t[0:4], (0, 0)), (t[8:12], (8, 0))])
    with pytest.raises(ValueError, match="dtype"):
        port_utils.assemble_tensor([(t[0:4], (0, 0)), (t[4:8].double(), (4, 0))])
    with pytest.raises(ValueError, match="no parts"):
        port_utils.assemble_tensor([])


def test_tensors_overlap_in_memory_and_byte_view():
    dest = torch.zeros(8, 8)
    assert port_utils.tensors_overlap_in_memory(dest, [dest[0:2], dest[:, 3:5], dest[7]])
    assert not port_utils.tensors_overlap_in_memory(dest, [dest[0:2].clone()])
    assert not port_utils.tensors_overlap_in_memory(dest, [torch.zeros(2)])
    assert ref_utils.tensors_overlap_in_memory(np.zeros((8, 8)), [np.zeros(2)]) is False
    view = port_utils.to_byte_view(dest[2:4])
    assert view.dtype == torch.uint8 and view.numel() == 64
    with pytest.raises(ValueError, match="contiguous"):
        port_utils.to_byte_view(dest.t())


def test_request_from_tensor_slice_and_with_box():
    ts = port_types.TensorSlice((4, 0), (4, 32), (16, 32), (1,), (4,))
    ref_ts = ref_types.TensorSlice(ts.offsets, ts.local_shape, ts.global_shape, (1,), (4,))
    req = port_types.Request.from_tensor_slice("w", ts, torch.zeros(4, 32))
    meta = req.meta_only()
    assert meta.tensor_slice == ts and meta.tensor_val is None
    assert req.meta_only() is meta  # memoized
    assert "_meta_only" not in req.__getstate__()
    with pytest.raises(ValueError, match="local_shape"):
        port_types.Request.from_tensor_slice("w", ts, torch.zeros(3, 32))
    with pytest.raises(ValueError, match="local_shape"):
        ref_types.Request.from_tensor_slice("w", ref_ts, np.zeros((3, 32)))
    box = port_utils.Box((5, 2), (2, 3))
    sub = ts.with_box(box)
    ref_sub = ref_ts.with_box(ref_utils.Box(box.offsets, box.shape))
    assert slice_fields(sub) == slice_fields(ref_sub)
    assert port_types.Request.meta_request("w") == port_types.Request(key="w")


@pytest.mark.parametrize("spec,axes", [(P(("x", "y")), ((0, 1),)), (P(None, ("y", "x")), (None, (1, 0)))],
                         ids=["dim0-over-xy", "dim1-over-yx"])
def test_shards_from_numpy_split_over_several_axes(spec, axes):
    ref = {r.tensor_slice.coordinates: r for r in
           ref_shd.put_requests("w", jax_array(GLOBAL, (2, 4), ("x", "y"), spec))}
    for s in tst.shards_from_numpy(GLOBAL, (2, 4), axes, "cpu"):
        want = ref[s.tensor_slice.coordinates]
        assert slice_fields(s.tensor_slice) == slice_fields(want.tensor_slice)
        np.testing.assert_array_equal(s.data.numpy(), np.asarray(want.tensor_val))
