"""Port parity: the reshard math and wire vocabulary of torchstore_tpu_torch
against torchstore_tpu's (``transport/types.py``, ``utils.py``), with
hypothesis-generated boxes and exact equality."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from torchstore_tpu import utils as ref_utils
from torchstore_tpu.transport import types as ref_types
from torchstore_tpu_torch import utils as port_utils
from torchstore_tpu_torch.transport import types as port_types


@st.composite
def box_pairs(draw):
    ndim = draw(st.integers(1, 4))
    dims = st.integers(0, 12)
    sizes = st.integers(1, 12)
    a = ([draw(dims) for _ in range(ndim)], [draw(sizes) for _ in range(ndim)])
    b = ([draw(dims) for _ in range(ndim)], [draw(sizes) for _ in range(ndim)])
    return a, b


def _as(mod, box):
    return mod.Box(tuple(box[0]), tuple(box[1]))


@settings(max_examples=200, deadline=None)
@given(box_pairs())
def test_intersect_boxes_matches_reference(pair):
    a, b = pair
    ref = ref_utils.intersect_boxes(_as(ref_utils, a), _as(ref_utils, b))
    port = port_utils.intersect_boxes(_as(port_utils, a), _as(port_utils, b))
    if ref is None:
        assert port is None
    else:
        assert (port.offsets, port.shape) == (ref.offsets, ref.shape)
        assert port.size == ref.size
        assert _as(port_utils, a).contains(port) == _as(ref_utils, a).contains(ref)


@settings(max_examples=100, deadline=None)
@given(st.lists(box_pairs(), min_size=1, max_size=4))
def test_boxes_cover_matches_reference(pairs):
    ndim = len(pairs[0][0][0])
    pairs = [p for p in pairs if len(p[0][0]) == ndim]
    region = pairs[0][0]
    covers = [p[1] for p in pairs] + [p[0] for p in pairs[1:]]
    assert port_utils.boxes_cover(
        _as(port_utils, region), [_as(port_utils, c) for c in covers]
    ) == ref_utils.boxes_cover(
        _as(ref_utils, region), [_as(ref_utils, c) for c in covers]
    )


@settings(max_examples=150, deadline=None)
@given(box_pairs(), st.booleans())
def test_get_destination_view_matches_reference(pair, require_contiguous):
    (dest_off, dest_shape), (reg_off, reg_shape) = pair
    dest_box = (dest_off, dest_shape)
    arr = np.arange(int(np.prod(dest_shape)), dtype=np.float32).reshape(dest_shape)
    ref = ref_utils.get_destination_view(
        arr, _as(ref_utils, dest_box), _as(ref_utils, (reg_off, reg_shape)),
        require_contiguous=require_contiguous,
    )
    port = port_utils.get_destination_view(
        torch.from_numpy(arr.copy()), _as(port_utils, dest_box),
        _as(port_utils, (reg_off, reg_shape)), require_contiguous=require_contiguous,
    )
    if ref is None:
        assert port is None
    else:
        np.testing.assert_array_equal(port.numpy(), ref)


@settings(max_examples=60, deadline=None)
@given(box_pairs())
def test_tensor_slice_box_matches_reference(pair):
    (off, local), (_, extra) = pair
    glob = tuple(o + s + e for o, s, e in zip(off, local, extra))
    kwargs = dict(
        offsets=tuple(off), local_shape=tuple(local), global_shape=glob,
        coordinates=(0,), mesh_shape=(1,),
    )
    ref = ref_types.TensorSlice(**kwargs)
    port = port_types.TensorSlice(**kwargs)
    assert (port.box.offsets, port.box.shape) == (ref.box.offsets, ref.box.shape)
    assert port.nelements == ref.nelements
    assert port.is_full() == ref.is_full()
    full = port_types.full_slice(glob)
    assert full.is_full() and full.box.shape == glob


DTYPES = [
    (torch.float32, np.float32),
    (torch.float64, np.float64),
    (torch.float16, np.float16),
    (torch.bfloat16, None),
    (torch.int8, np.int8),
    (torch.int16, np.int16),
    (torch.int32, np.int32),
    (torch.int64, np.int64),
    (torch.uint8, np.uint8),
    (torch.bool, np.bool_),
    (torch.complex64, np.complex64),
]


@pytest.mark.parametrize("torch_dtype,np_dtype", DTYPES, ids=lambda d: str(d))
def test_dtype_names_round_trip_like_reference(torch_dtype, np_dtype):
    if np_dtype is None:
        import ml_dtypes

        np_dtype = ml_dtypes.bfloat16
    shape = (3, 5)
    ref_meta = ref_types.TensorMeta.of(np.zeros(shape, np_dtype))
    port_meta = port_types.TensorMeta.of(torch.zeros(shape, dtype=torch_dtype))
    assert port_meta.dtype == ref_meta.dtype
    assert port_meta.shape == ref_meta.shape
    assert port_meta.nbytes == ref_meta.nbytes
    assert port_types.torch_dtype(port_meta.dtype) is torch_dtype
    assert port_meta.torch_dtype is torch_dtype


def test_unknown_wire_dtype_is_refused():
    with pytest.raises(TypeError):
        port_types.torch_dtype("not_a_dtype")


def test_request_meta_only_strips_data():
    req = port_types.Request.from_tensor("k", torch.ones(4, 2, dtype=torch.bfloat16))
    req.destination_view = torch.zeros(4, 2)
    meta = req.meta_only()
    assert meta.tensor_val is None and meta.destination_view is None
    assert meta.tensor_meta == port_types.TensorMeta((4, 2), "bfloat16")
    assert req.nbytes == 16
    assert "destination_view" in req.__getstate__()
    assert req.__getstate__()["destination_view"] is None
