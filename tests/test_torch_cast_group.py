"""The grouped cast (torchstore_tpu_torch.ops.staging.cast_group) on the CPU.

What runs here: the planner (grouping by dtype pair, chunks bounded by
output bytes and by table entries), the table layout shared with
``csrc/cast.cu`` and the split of each entry into work units (emulated in
numpy as the kernel walks it), the plain version against the reference's
Pallas kernel (interpret mode) and its ``device_cast``, and the two callers
on CPU leaves: the buffered leg's ``cast_floating_tensors`` against the
reference's, and the direct-sync source's register and refresh against the
plain per-leaf cast. Tolerance: bit-equal outside NaN, NaN positions equal.
The kernel itself needs a GPU (tests/test_torch_cuda.py).
"""

import re
import struct
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from test_torch_staging import BITS, JNP, NP, all_16bit, assert_cast_equal, f32_inputs
from torchstore_tpu import state_dict_utils as ref_sdu
from torchstore_tpu.ops import device_cast as ref_device_cast
from torchstore_tpu.ops import pallas_cast
from torchstore_tpu_torch import state_dict_utils as port_sdu
from torchstore_tpu_torch.direct_weight_sync import DirectWeightSyncSource
from torchstore_tpu_torch.ops import staging

CAST_CU = Path(staging.__file__).resolve().parent.parent / "csrc" / "cast.cu"
F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16


def meta(dtype, n):
    """A tensor of ``n`` elements that has dtype and size but no storage."""
    return torch.empty(n, dtype=dtype, device="meta")


def random_src(src: torch.dtype, n: int, seed: int) -> np.ndarray:
    """``n`` values of ``src`` as numpy (special values first for fp32,
    random 16-bit patterns otherwise)."""
    if src == F32:
        return f32_inputs(n, seed)
    pats = all_16bit(src)
    return pats[np.random.default_rng(seed).integers(0, pats.size, n)]


def as_torch(x: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    int_t, np_bits = BITS[x.itemsize]
    return torch.from_numpy(np.ascontiguousarray(x).view(np_bits).copy()).view(int_t).view(dtype)


# --------------------------------------------------------------------------
# the planner
# --------------------------------------------------------------------------


def test_plan_keeps_order_and_groups_by_pair():
    ts = [meta(F16, 5), meta(F32, 10), meta(F16, 3), meta(F32, 0), meta(F32, 4)]
    plan = staging.plan_chunks(ts, BF16)
    assert [(c.pair, c.indices) for c in plan] == [((F16, BF16), (0, 2)), ((F32, BF16), (1, 4))]
    assert [c.out_bytes for c in plan] == [16, 28]


@pytest.mark.parametrize("src", [torch.float64, BF16], ids=str)
def test_plan_refuses_uncovered_pair(src):
    with pytest.raises(TypeError, match="does not cover"):
        staging.plan_chunks([meta(F32, 4), meta(src, 4)], BF16)


@pytest.mark.parametrize(
    "sizes,bound,want",
    [
        ([100, 100, 100], 400, [(0, 1), (2,)]),  # 400 bytes fit; the third would not
        ([100, 100, 100], 600, [(0, 1, 2)]),
        ([10, 500, 10, 10], 100, [(0,), (1,), (2, 3)]),  # 1000 bytes > bound: alone
        ([500], 100, [(0,)]),
        ([0, 5, 0, 5], 1 << 30, [(1, 3)]),  # empty tensors: in no chunk
        ([0, 0], 1 << 30, []),
    ],
)
def test_plan_bounds_chunks_by_bytes(sizes, bound, want):
    plan = staging.plan_chunks([meta(F32, n) for n in sizes], BF16, max_chunk_bytes=bound)
    assert [c.indices for c in plan] == want
    for c in plan:
        assert c.out_bytes == 2 * sum(sizes[i] for i in c.indices)
        assert c.out_bytes <= bound or len(c.indices) == 1


@pytest.mark.parametrize("count", [2500, 1000, 1001, 999])
def test_plan_bounds_chunks_by_entries(count):
    k = staging.MAX_ENTRIES
    plan = staging.plan_chunks([meta(F16, 3)] * count, F32)
    assert [len(c.indices) for c in plan] == [k] * (count // k) + ([count % k] if count % k else [])
    assert [i for c in plan for i in c.indices] == list(range(count))


def test_plan_of_llama_state_dict_counts_chunks_by_gib():
    """A Llama-3-8B publish (fp32 -> bf16, 16.06 GB out) is 16 chunks of at
    most 1 GiB, not 291 launches."""
    from torchstore_tpu_torch.workloads import LLAMA3_8B, llama_shapes

    def leaves(tree):
        for v in tree.values():
            yield from leaves(v) if isinstance(v, dict) else [v]

    shapes = list(leaves(llama_shapes(**LLAMA3_8B)))
    plan = staging.plan_chunks([meta(F32, int(np.prod(s))) for s in shapes], BF16)
    assert len(shapes) == 291
    out_bytes = sum(c.out_bytes for c in plan)
    assert out_bytes == 2 * sum(int(np.prod(s)) for s in shapes)
    assert len(plan) == 16 and all(c.out_bytes <= 1 << 30 for c in plan)


# --------------------------------------------------------------------------
# the table shared with csrc/cast.cu, and the kernel's walk over it
# --------------------------------------------------------------------------


def cu_constant(name: str) -> int:
    m = re.search(rf"constexpr\s+\w+\s+{name}\s*=\s*(0x[0-9A-Fa-f]+|\d+)u?;", CAST_CU.read_text())
    assert m, f"{name} not found in cast.cu"
    return int(m.group(1), 0)


def test_table_layout_matches_cast_cu():
    src = CAST_CU.read_text()
    body = re.search(r"struct Entry \{(.*?)\};", src, re.S).group(1)
    codes = {"uint64_t": "Q", "int64_t": "q", "uint32_t": "I"}
    fields = re.findall(r"^\s*(\w+)\s+(\w+);", body, re.M)
    assert [f for _, f in fields] == ["src", "dst", "n", "first", "head"]
    assert "<" + "".join(codes[t] for t, _ in fields) == staging.ENTRY.format
    assert f"sizeof(Entry) == {staging.ENTRY.size}" in src
    assert cu_constant("kUnitElems") == staging.UNIT_ELEMS
    assert cu_constant("kMaxEntries") == staging.MAX_ENTRIES
    assert cu_constant("kNoBody") == staging.NO_BODY
    # The largest table fits the kernel parameter limit (32,764 bytes).
    assert 8 + staging.MAX_ENTRIES * staging.ENTRY.size <= 32764


def test_pack_table_fields_and_units():
    u = staging.UNIT_ELEMS
    entries = [(0x1000, 0x2000, u, 4, 2), (0x1004, 0x3000, 2 * u + 7, 4, 2),
               (0x1008, 0x4000, 5, 2, 4), (0x1008, 0x4000, u + 4, 2, 4),
               (0x5000, 0x6000, 1, 2, 2)]
    table, units = staging.pack_table(entries)
    rows = list(staging.ENTRY.iter_unpack(table))
    heads = [0, staging.NO_BODY, 4, 4, 0]
    # u | 2u + 7 one by one | 5 - 4 after the head | u after the head | 1
    counts = [1, 3, 1, 1, 1]
    assert [r[4] for r in rows] == heads
    assert [r[3] for r in rows] == [0, 1, 4, 5, 6]
    assert units == sum(counts)
    assert [r[:3] for r in rows] == [e[:3] for e in entries]


@pytest.mark.parametrize("in_size,out_size", [(4, 2), (2, 4), (2, 2)])
def test_entry_head_is_first_common_alignment(in_size, out_size):
    for src_off in range(0, 16, in_size):
        for dst_off in range(0, 16, out_size):
            for n in (1, 3, 8, 100):
                want = next(
                    (h for h in range(n)
                     if (src_off + h * in_size) % 16 == 0 and (dst_off + h * out_size) % 16 == 0),
                    staging.NO_BODY,
                )
                got = staging.entry_head(0x7000 + src_off, 0x9000 + dst_off, n, in_size, out_size)
                assert got == want, (src_off, dst_off, n)


def emulate_kernel(table: bytes, units: int, memory: dict, in_size: int, out_size: int) -> None:
    """Walk every work unit of a packed table as ``cast.cu``'s ``plan_unit``
    does, checking each bulk body's alignment and size, and cast through
    the plain version into ``memory`` (pointer -> (x, y, written))."""
    rows = list(staging.ENTRY.iter_unpack(table))
    firsts = [r[3] for r in rows]
    for u in range(units):
        e = max(i for i, f in enumerate(firsts) if f <= u)  # the binary search's answer
        src, dst, n, first, head = rows[e]
        x, y, written = memory[src]
        j = u - first
        ranges = []
        if head == staging.NO_BODY:
            ranges.append((j * staging.UNIT_ELEMS, min((j + 1) * staging.UNIT_ELEMS, n)))
        else:
            start = head + j * staging.UNIT_ELEMS
            end = min(start + staging.UNIT_ELEMS, n)
            body = (end - start) & ~7
            if body:
                assert (src + start * in_size) % 16 == 0 and (dst + start * out_size) % 16 == 0
                assert (body * in_size) % 16 == 0 and (body * out_size) % 16 == 0
            ranges += [(start, start + body), (start + body, end)]
            if j == 0:
                ranges.append((0, head))
        for a, b in ranges:
            y[a:b] = staging.cast_reference(x[a:b], y.dtype)
            written[a:b] += 1


@pytest.mark.parametrize("src,dst", staging.PAIRS, ids=str)
def test_units_cover_every_element_once(src, dst):
    """Entries at every alignment of their pointers, sizes around the unit
    and the 8-element body step: each element is cast exactly once and
    every bulk body is 16-byte aligned on both sides."""
    in_size, out_size = staging._ITEMSIZE[src], staging._ITEMSIZE[dst]
    rng = np.random.default_rng(7)
    u = staging.UNIT_ELEMS
    sizes = [1, 7, 8, 9, 15, u - 1, u, u + 1, 2 * u + 8, 3 * u + 5]
    memory, entries = {}, []
    for k, n in enumerate(sizes * 2):
        src_ptr = (k + 1) << 20 | int(rng.integers(0, 16 // in_size)) * in_size
        dst_ptr = (k + 1) << 40 | int(rng.integers(0, 16 // out_size)) * out_size
        x = as_torch(random_src(src, n, seed=k), src)
        memory[src_ptr] = (x, torch.empty(n, dtype=dst), torch.zeros(n, dtype=torch.int32))
        entries.append((src_ptr, dst_ptr, n, in_size, out_size))
    table, units = staging.pack_table(entries)
    emulate_kernel(table, units, memory, in_size, out_size)
    for x, y, written in memory.values():
        assert bool((written == 1).all())
        assert_cast_equal(y, staging.cast_reference(x, dst).view(BITS[out_size][0]).numpy()
                          .view(BITS[out_size][1]).view(NP[dst]))


# --------------------------------------------------------------------------
# the plain version against the reference
# --------------------------------------------------------------------------


@pytest.mark.parametrize("src,dst", staging.PAIRS, ids=str)
def test_plain_group_matches_pallas_kernel_and_reference_cast(src, dst):
    sizes = [1024, 7, 8 * 1024, 1023, 0, 3 * 1024, 1]
    xs = [random_src(src, n, seed=31 * i + n) for i, n in enumerate(sizes)]
    before = staging.cast_kernel.launches
    got = staging.cast_group([as_torch(x, src) for x in xs], dst)
    assert staging.cast_kernel.launches == before  # CPU tensors: the plain version
    assert len(got) == len(sizes)
    for x, y in zip(xs, got):
        assert y.dtype == dst and y.shape == (x.size,)
        assert_cast_equal(y, np.asarray(ref_device_cast(jnp.asarray(x), NP[dst])))
        if x.size % 1024 == 0 and x.size:
            ref = pallas_cast(jnp.asarray(x.reshape(-1, 128)), JNP[dst], interpret=True)
            assert_cast_equal(y, np.asarray(ref))


def test_cast_group_of_nothing_is_nothing():
    assert staging.cast_group([], BF16) == []


def test_kernel_checks_tensors_before_launching():
    before = staging.cast_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        staging.cast_kernel.group([torch.zeros(4), torch.zeros(4)], BF16)
    with pytest.raises(TypeError, match="does not cover"):
        staging.cast_kernel.group([torch.zeros(4), torch.zeros(4, dtype=torch.float64)], BF16)
    assert staging.cast_kernel.launches == before


# --------------------------------------------------------------------------
# the callers on CPU leaves
# --------------------------------------------------------------------------


def mixed_leaves(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "w": f32_inputs(2048, seed).reshape(16, 128),
        "b": rng.standard_normal(7).astype(np.float32),
        "h": rng.standard_normal((3, 5)).astype(np.float16),
        "g": rng.standard_normal(9).astype(np.float32).astype(ml_dtypes.bfloat16),
        "steps": np.arange(4, dtype=np.int64),
        "lr": 0.5,
    }


def to_port(v):
    if not isinstance(v, np.ndarray):
        return v
    if v.dtype == ml_dtypes.bfloat16:
        return as_torch(v, BF16)
    return torch.from_numpy(v.copy())


@pytest.mark.parametrize("transfer", [BF16, F16], ids=str)
def test_buffered_leg_cast_matches_reference(transfer):
    flat = mixed_leaves(3)
    ref = ref_sdu.cast_floating_tensors(flat, NP[transfer])
    port = port_sdu.cast_floating_tensors({k: to_port(v) for k, v in flat.items()}, transfer)
    assert port.keys() == ref.keys()
    assert port["lr"] == 0.5
    assert torch.equal(port["steps"], torch.from_numpy(ref["steps"]))
    for k in ("w", "b", "h", "g"):
        assert port[k].dtype == transfer, k
        assert_cast_equal(port[k], np.asarray(ref[k]))


@pytest.mark.parametrize("transfer", [BF16, F16, None], ids=str)
async def test_register_and_refresh_stage_plain_cast_bytes(transfer):
    tree = {k: to_port(v) for k, v in mixed_leaves(4).items()}
    source = DirectWeightSyncSource(use_shm=False)
    try:
        handles = await source.register(tree, transfer_dtype=transfer)

        def check():
            for k, (h,) in handles.items():
                staged = source.server.buffers[h.buffer_id]
                v = tree[k]
                want = v.to(transfer) if transfer is not None and v.is_floating_point() else v
                assert staged.dtype == want.dtype and staged.shape == want.shape, k
                assert torch.equal(staged.view(torch.uint8), want.contiguous().view(torch.uint8)), k

        check()
        for k, v in tree.items():
            if isinstance(v, torch.Tensor):
                v.copy_(torch.flip(v, [0]))  # the training step, in place
        await source.refresh()
        check()
    finally:
        await source.close()
