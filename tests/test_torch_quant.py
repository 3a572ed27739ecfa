"""The port's quantized wire tier against the JAX package's.

- Blobs: for the same f32 input (made from a numpy seed) the port's
  ``quantize_transfer`` blob equals ``torchstore_tpu.state_dict_utils``'s
  byte for byte in all three modes, over f32 / bf16 / f16 leaves and empty,
  scalar, ragged-tail and odd-int4-block shapes; ``parse_quant_blob``
  agrees field by field and the dequant is bit-equal.
- Delta: one ``DeltaEncoder`` sequence (keyframe, delta, all unchanged,
  cadence keyframe, restructure) through both packages gives byte-equal
  blobs and bit-equal baselines, and each package's ``DeltaDecoder``
  accumulates the other's blobs to the same state.
- Store round trips (the port alone; one store session for every case):
  the reference's ``tests/test_quantized_sync.py`` and the non-channel
  cases of ``tests/test_quant_delta.py``, with the reference's tolerance
  (one keyframe step, ``max|x| / qmax``), plus the delta chain through
  ``delta_ctx`` / ``delta_state``.

The JAX codec needs no store: no reference store starts here and no
``ts_shm_*`` segment is made.
"""

import asyncio
import contextlib
import dataclasses
import importlib

import ml_dtypes
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Shard as DShard, distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore

import torchstore_tpu_torch as tst
from torchstore_tpu import state_dict_utils as ref_sdu
from torchstore_tpu.transport import landing as ref_landing
from torchstore_tpu_torch import config as port_config
from torchstore_tpu_torch.transport import landing
from torchstore_tpu_torch.transport.types import TensorSlice

sdu = importlib.import_module("torchstore_tpu_torch.state_dict_utils")

SHAPES = {"scalar": (), "empty": (0, 8), "ragged": (300, 17), "exact": (1024,), "rank3": (3, 5, 7)}
DTYPES = {"float32": np.float32, "float16": np.float16, "bfloat16": ml_dtypes.bfloat16}


def make(seed: int, shape, dtype=np.float32, scale: float = 1.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.asarray(rng.standard_normal(shape) * scale).astype(np.float32).astype(dtype)


def as_torch(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def tol(arr, qmax=127.0) -> float:
    # The reference's bound: one keyframe step.
    return float(np.max(np.abs(np.asarray(arr, np.float32)), initial=0.0)) / qmax + 1e-6


def np_of(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same_fields(port: dict, ref: dict) -> None:
    assert set(port) == set(ref)
    for k, want in ref.items():
        got = np_of(port[k]) if isinstance(port[k], torch.Tensor) else port[k]
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), k
        else:
            assert got == want, k


# --------------------------------------------------------------------------
# blobs against the JAX package
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("fmt", sdu.QUANT_MODES)
def test_blob_bytes_match_reference(fmt, dtype, shape):
    seed = (100 * sdu.QUANT_MODES.index(fmt) + 10 * list(DTYPES).index(dtype)
            + list(SHAPES).index(shape))
    arr = make(seed, SHAPES[shape], DTYPES[dtype], scale=3.0)
    ref_out, ref_meta = ref_sdu.quantize_transfer({"w": arr, "n": 3}, fmt, 256)
    out, meta = sdu.quantize_transfer({"w": as_torch(arr), "n": 3}, fmt, 256)
    assert meta == ref_meta and out["n"] == 3
    blob = out["w"]
    assert blob.dtype == torch.uint8 and blob.dim() == 1
    assert blob.numpy().tobytes() == ref_out["w"].tobytes()
    info, ref_info = sdu.parse_quant_blob(blob), ref_sdu.parse_quant_blob(ref_out["w"])
    assert_same_fields(info, ref_info)
    got = sdu._dequant_codes(info["codes"], info["scales"][:, None])
    want = ref_sdu._dequant_codes(ref_info["codes"], ref_info["scales"][:, None])
    assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("block", [1, 7, 255, 257])
@pytest.mark.parametrize("fmt", ["int8_block", "int4_block"])
def test_odd_blocks_match_reference(fmt, block):
    arr = make(block, (1000,), scale=0.02)
    ref_out, _ = ref_sdu.quantize_transfer({"w": arr}, fmt, block)
    out, _ = sdu.quantize_transfer({"w": as_torch(arr)}, fmt, block)
    assert out["w"].numpy().tobytes() == ref_out["w"].tobytes()
    assert_same_fields(sdu.parse_quant_blob(out["w"]), ref_sdu.parse_quant_blob(ref_out["w"]))


def test_quantize_int8_and_async_match_reference():
    arr = make(5, (64, 33))
    ref_out, ref_meta = ref_sdu.quantize_int8({"w": arr})
    out, meta = sdu.quantize_int8({"w": torch.from_numpy(arr)})
    assert meta == ref_meta and out["w"].numpy().tobytes() == ref_out["w"].tobytes()

    async def encode():
        return await sdu.quantize_transfer_async(
            {"a": torch.from_numpy(arr), "b": torch.from_numpy(arr[:3]), "i": torch.arange(4)},
            "int4_block", 64)

    aout, ameta = asyncio.run(encode())
    ref_aout, ref_ameta = ref_sdu.quantize_transfer({"a": arr, "b": arr[:3], "i": np.arange(4)},
                                                    "int4_block", 64)
    assert ameta == ref_ameta and list(aout) == ["a", "b", "i"]
    for k in ("a", "b"):
        assert aout[k].numpy().tobytes() == ref_aout[k].tobytes()
    assert torch.equal(aout["i"], torch.arange(4))


@pytest.mark.parametrize("seed", range(4))
def test_dequant_and_mask_packing_match_reference(seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-127, 128, (16, 64)).astype(np.int8)
    scales = (np.abs(rng.standard_normal((16, 1))) + 1e-3).astype(np.float32)
    got = sdu._dequant_codes(torch.from_numpy(codes), torch.from_numpy(scales))
    assert got.numpy().tobytes() == ref_sdu._dequant_codes(codes, scales).tobytes()
    mask = rng.random(1 + 37 * seed) < 0.4
    packed = sdu._pack_mask(torch.from_numpy(mask))
    want = np.packbits(mask.astype(np.uint8), bitorder="little")
    assert packed.numpy().tobytes() == want.tobytes()
    assert np.array_equal(sdu._unpack_mask(packed, mask.size).numpy(), mask)


@pytest.mark.parametrize("fmt", sdu.QUANT_MODES)
def test_blob_layout_matches_reference(fmt):
    for sizes, scales in (([64, 3, 100], [0, 0, 12]), ([1, 0, 5], [4, 8, 0]), ([130], [7])):
        assert (landing.compute_arena_layout(sizes, scale_sizes=scales)
                == ref_landing.compute_arena_layout(sizes, scale_sizes=scales))
    for rank, nblocks, changed, block in ((0, 1, 1, 1), (2, 9, 4, 255), (5, 300, 300, 256)):
        assert (landing.quant_blob_layout(rank, nblocks, changed, fmt, block)
                == ref_landing.quant_blob_layout(rank, nblocks, changed, fmt, block))
        assert (landing.quant_wire_nbytes(fmt, block, nblocks * 7, rank)
                == ref_landing.quant_wire_nbytes(fmt, block, nblocks * 7, rank))
    assert landing.QUANT_HEADER_BYTES == ref_landing.QUANT_HEADER_BYTES


def test_not_a_blob_parses_as_none():
    assert sdu.parse_quant_blob(torch.zeros(128, dtype=torch.uint8)) is None
    assert sdu.parse_quant_blob(torch.zeros(8, dtype=torch.uint8)) is None
    assert sdu.parse_quant_blob(torch.zeros(128, dtype=torch.float32)) is None
    assert sdu.parse_quant_blob("blob") is None


@pytest.mark.parametrize("fmt", ["int8", "int8_block"])
def test_nonfinite_block_names_key_and_block(fmt):
    bad = make(1, (1024,))
    bad[700] = np.nan  # block 2 at block size 256
    for mod, leaf in ((sdu, torch.from_numpy(bad)), (ref_sdu, bad)):
        with pytest.raises(ValueError, match=r"'w'.*non-finite") as err:
            mod.quantize_transfer({"w": leaf}, fmt, 256)
        if fmt == "int8_block":
            assert "block 2" in str(err.value)
    bad[700] = np.inf
    with pytest.raises(ValueError, match="non-finite"):
        sdu.quantize_transfer({"w": torch.from_numpy(bad)}, fmt, 256)


@contextlib.contextmanager
def fake_rank(rank: int, world: int):
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_dtensor_and_shard_leaves():
    """A DTensor on a one-rank mesh quantizes as its whole tensor; one whose
    mesh spans more ranks is refused with the reference's advice; a
    ``Shard`` leaf passes through unquantized."""
    x = torch.from_numpy(make(3, (8, 6)))
    plain, _ = sdu.quantize_transfer({"w": x}, "int8_block", 16)
    with fake_rank(0, 1):
        dt = distribute_tensor(x, init_device_mesh("cpu", (1,)), (DShard(0),))
        out, meta = sdu.quantize_transfer({"w": dt}, "int8_block", 16)
        assert meta["keys"] == ["w"] and torch.equal(out["w"], plain["w"])
    with fake_rank(1, 4):
        dt = distribute_tensor(x, init_device_mesh("cpu", (4,)), (DShard(0),),
                               src_data_rank=None)
        with pytest.raises(NotImplementedError, match="spans 4 ranks.*transfer_dtype"):
            sdu.quantize_transfer({"w": dt}, "int8_block", 16)
    shard = tst.Shard(x[:4], TensorSlice((0, 0), (4, 6), (8, 6), (0,), (2,)))
    out, meta = sdu.quantize_transfer({"s": shard}, "int8_block", 16)
    assert out["s"] is shard and meta["keys"] == []


# --------------------------------------------------------------------------
# the delta codec against the JAX package
# --------------------------------------------------------------------------

DELTA_STEPS = ("keyframe", "delta", "unchanged", "cadence keyframe", "restructure")


def delta_versions(seed: int):
    """(step, {key: f32 array}) per version: v0 keyframe; v1 a change in
    some blocks of "hot"; v2 nothing changed; v3 the cadence keyframe
    (keyframe_every=3); v4 "hot" with a new shape."""
    hot, frozen = make(seed, (700,)), make(seed + 1, (20, 30), scale=0.1)
    out = [{"hot": hot.copy(), "frozen": frozen.copy()}]
    hot[:100] += 0.05
    hot[500] -= 0.3
    out.append({"hot": hot.copy(), "frozen": frozen.copy()})
    out.append({"hot": hot.copy(), "frozen": frozen.copy()})
    hot[200:260] *= 1.5
    out.append({"hot": hot.copy(), "frozen": frozen.copy()})
    out.append({"hot": make(seed + 2, (350, 3)), "frozen": frozen.copy()})
    return list(zip(DELTA_STEPS, out))


def run_delta_sequence(fmt: str, block: int, skip_eps: float, seed: int) -> list:
    async def go():
        ref = ref_sdu.DeltaEncoder(fmt, block, keyframe_every=3, skip_eps=skip_eps)
        port = sdu.DeltaEncoder(fmt, block, keyframe_every=3, skip_eps=skip_eps)
        ref_dec, port_dec = ref_sdu.DeltaDecoder(), sdu.DeltaDecoder()
        steps = []
        for v, (step, tree) in enumerate(delta_versions(seed)):
            for key, arr in tree.items():
                ref_blob, ref_base = await ref.encode(key, arr, v)
                blob, base = await port.encode(key, torch.from_numpy(arr), v)
                steps.append((step, key, ref_blob, ref_base, blob, base))
                assert np_of(port.entries[key]["baseline"]).tobytes() == (
                    ref.entries[key]["baseline"].tobytes()), (step, key)
                if blob is not None:
                    # Each package's reader takes the other's bytes.
                    await port_dec.decode(key, torch.from_numpy(ref_blob))
                    await ref_dec.decode(key, blob.numpy())
                assert np_of(port_dec.state[key]["blocks"]).tobytes() == (
                    ref.entries[key]["baseline"].tobytes())
                assert ref_dec.state[key]["blocks"].tobytes() == (
                    ref.entries[key]["baseline"].tobytes())
        return steps

    return asyncio.run(go())


@pytest.mark.parametrize("skip_eps", [0.0, 0.01])
@pytest.mark.parametrize("fmt,block", [("int8_block", 256), ("int4_block", 256),
                                       ("int8_block", 33), ("int4_block", 33)])
def test_delta_sequence_matches_reference(fmt, block, skip_eps):
    kinds = set()
    for step, key, ref_blob, ref_base, blob, base in run_delta_sequence(fmt, block, skip_eps, 7):
        assert base == ref_base, (step, key)
        assert (blob is None) == (ref_blob is None), (step, key)
        if blob is not None:
            assert blob.numpy().tobytes() == ref_blob.tobytes(), (step, key)
            flags = sdu.parse_quant_blob(blob)["flags"]
            kinds.add((step, key, "delta" if flags & sdu._FLAG_DELTA else "keyframe"))
        else:
            kinds.add((step, key, "alias"))
    assert ("keyframe", "hot", "keyframe") in kinds
    assert ("delta", "hot", "delta") in kinds
    assert ("delta", "frozen", "alias") in kinds
    assert ("unchanged", "hot", "alias") in kinds
    assert ("cadence keyframe", "frozen", "keyframe") in kinds
    assert ("restructure", "hot", "keyframe") in kinds


def test_delta_encoder_refuses_backward_versions_and_per_tensor_mode():
    with pytest.raises(ValueError, match="blockwise"):
        sdu.DeltaEncoder("int8", 256, 4)
    enc = sdu.DeltaEncoder("int8_block", 256, 4)
    x = torch.from_numpy(make(0, (512,)))
    asyncio.run(enc.encode("w", x, 3))
    with pytest.raises(RuntimeError, match="moved backwards"):
        asyncio.run(enc.encode("w", x, 2))
    enc.drop("w")
    blob, _ = asyncio.run(enc.encode("w", x, 2))  # dropped: keyframes again
    assert sdu.parse_quant_blob(blob)["flags"] & sdu._FLAG_KEYFRAME


def test_decoder_without_chain_context_raises():
    enc = sdu.DeltaEncoder("int8_block", 64, 8)
    x = torch.from_numpy(make(0, (512,)))
    asyncio.run(enc.encode("w", x, 0))
    x[:64] += 1.0
    delta, _ = asyncio.run(enc.encode("w", x, 1))
    with pytest.raises(RuntimeError, match="no chain context"):
        asyncio.run(sdu.DeltaDecoder().decode("w", delta))


# --------------------------------------------------------------------------
# store round trips (one port store session)
# --------------------------------------------------------------------------

STORE = "quant"


async def store_session() -> dict:
    await tst.initialize(store_name=STORE)
    rec: dict = {}
    client = tst.client(STORE)

    async def attempt(name, coro):
        try:
            await coro
            rec[name] = None
        except Exception as exc:  # noqa: BLE001 - the tests read the error
            rec[name] = exc

    try:
        # Round trip per mode (test_roundtrip_accuracy, test_blockwise_roundtrip).
        for fmt in sdu.QUANT_MODES:
            sd = {"w": make(1, (300, 17)), "b": make(2, (5,), scale=0.01), "step": 7}
            await tst.put_state_dict(f"rt/{fmt}", tst.from_numpy_tree(sd, "cpu"),
                                     transfer_quant=fmt, store_name=STORE)
            rec[f"rt/{fmt}"] = (sd, await tst.get_state_dict(f"rt/{fmt}", store_name=STORE))
        # Wire bytes (test_wire_bytes_are_int8, test_scales_ride_the_payload_segment).
        before = (await volume_stats(client))["stored_bytes"]
        await tst.put_state_dict("wire", {"w": torch.from_numpy(make(3, (256, 256)))},
                                 transfer_quant="int8_block", store_name=STORE)
        rec["wire_bytes"] = (await volume_stats(client))["stored_bytes"] - before
        # In-place targets (test_inplace_numpy_target / _torch_target).
        src = {"w": make(4, (32, 32)), "h": make(5, (32,), np.float16)}
        await tst.put_state_dict("inplace", tst.from_numpy_tree(src, "cpu"),
                                 transfer_quant="int8_block", store_name=STORE)
        user = {"w": torch.zeros(32, 32), "h": torch.zeros(32, dtype=torch.float16)}
        out = await tst.get_state_dict("inplace", user, store_name=STORE)
        rec["inplace"] = (src, user, out)
        # bf16 leaves keep their dtype (test_bf16_leaves).
        bf = {"w": make(6, (64,), ml_dtypes.bfloat16)}
        await tst.put_state_dict("bf16", tst.from_numpy_tree(bf, "cpu"),
                                 transfer_quant="int8", store_name=STORE)
        rec["bf16"] = (bf, await tst.get_state_dict("bf16", store_name=STORE))
        # Invalid combinations (test_invalid_combinations).
        ones = {"w": torch.ones(4)}
        await attempt("both", tst.put_state_dict("x", ones, transfer_quant="int8",
                                                 transfer_dtype=torch.float16, store_name=STORE))
        await attempt("direct", tst.put_state_dict("x", ones, transfer_quant="int8",
                                                   direct=True, store_name=STORE))
        await attempt("unknown", tst.put_state_dict("x", ones, transfer_quant="int4",
                                                    store_name=STORE))
        await attempt("delta_int8", sdu.put_state_dict(
            client, "x", ones, transfer_quant="int8",
            delta_ctx={"codec": None, "version": 0, "channel": "x"}))
        # The config's default mode (test_env_default_mode).
        orig = client._config
        client._config = dataclasses.replace(orig, transfer_quant="int8_block")
        try:
            env = {"w": make(7, (128,))}
            await tst.put_state_dict("env", tst.from_numpy_tree(env, "cpu"), store_name=STORE)
            marker = await client.get("env/MAPPING")
            rec["env"] = (env, marker, await tst.get_state_dict("env", store_name=STORE))
            # An explicit transfer_dtype wins over the default.
            await tst.put_state_dict("env_cast", tst.from_numpy_tree(env, "cpu"),
                                     transfer_dtype=torch.bfloat16, store_name=STORE)
            rec["env_cast"] = await client.get("env_cast/MAPPING")
        finally:
            client._config = orig
        # Non-finite leaves (test_nonfinite_weights_rejected).
        bad = make(8, (1024,))
        bad[700] = np.nan
        await attempt("nan", tst.put_state_dict("nf", {"w": torch.from_numpy(bad)},
                                                transfer_quant="int8_block", store_name=STORE))
        bad[700] = np.inf
        await attempt("inf", tst.put_state_dict("nf", {"w": torch.from_numpy(bad)},
                                                transfer_quant="int8", store_name=STORE))
        rec["nf_exists"] = await client.exists("nf/MAPPING")
        # Zero, empty and scalar leaves (test_zero_tensor_quantizes,
        # test_empty_and_nonaddressable_leaves).
        odd = {"z": torch.zeros(16), "e": torch.zeros(0, 8), "s": torch.tensor(2.5)}
        await tst.put_state_dict("odd", odd, transfer_quant="int8", store_name=STORE)
        rec["odd"] = (odd, await tst.get_state_dict("odd", store_name=STORE))
        # Shard targets: each fills its box of the decoded tensor.
        halves = [tst.Shard(torch.zeros(16, 32), TensorSlice((16 * r, 0), (16, 32), (32, 32),
                                                            (r,), (2,))) for r in range(2)]
        for shard in halves:
            await tst.get_state_dict("inplace", {"w": shard, "h": torch.zeros_like(user["h"])},
                                     store_name=STORE)
        rec["shards"] = (out["w"].clone(), [h.data for h in halves])
        # A target of another shape fails loudly.
        await attempt("shape", tst.get_state_dict("inplace", {"w": torch.zeros(16, 64),
                                                              "h": user["h"]},
                                                  store_name=STORE))
        # The delta chain through delta_ctx / delta_state.
        rec["delta"] = await delta_chain(client)
    finally:
        await tst.shutdown(STORE)
    return rec


async def volume_stats(client) -> dict:
    stats = await client.controller.stats.call_one(include_volumes=True)
    (vstats,) = stats["volumes"].values()
    return vstats


async def delta_chain(client) -> dict:
    """v0..v4 of a channel with keyframe_every=4: keyframe, update, no
    change, update, cadence keyframe; a warm reader (``delta_state``), a
    fresh reader at v3 (chain walk), then the chain broken under v1."""
    enc = sdu.DeltaEncoder("int8_block", 256, keyframe_every=4)
    dec = sdu.DeltaDecoder()
    w = {"hot": torch.from_numpy(make(10, (600,))),
         "frozen": torch.from_numpy(make(11, (600,))), "step": 0}
    out: dict = {"versions": []}
    served0 = sdu._DELTA_UNCHANGED_SERVED.total()
    for v in range(5):
        if v in (1, 3):
            w["hot"][:100] += 0.05
        w["step"] = v
        before = (await volume_stats(client))["stored_bytes"]
        await sdu.put_state_dict(client, f"ch/v{v}", w, transfer_quant="int8_block",
                                 delta_ctx={"codec": enc, "version": v, "channel": "ch"})
        stored = (await volume_stats(client))["stored_bytes"] - before
        marker = await client.get(f"ch/v{v}/MAPPING")
        got = await sdu.get_state_dict(client, f"ch/v{v}", delta_state=dec)
        out["versions"].append({
            "aliases": marker["quant"]["delta"]["aliases"],
            "stored": stored,
            "keys": await client.keys(f"ch/v{v}"),
            "equal": {k: torch.equal(dec.state[k]["blocks"], enc.entries[k]["baseline"])
                      for k in ("hot", "frozen")},
            "src": {k: w[k].clone() for k in ("hot", "frozen")},
            "got": got,
        })
    out["served"] = sdu._DELTA_UNCHANGED_SERVED.total() - served0
    # A fresh reader of v3 (a delta on v2, aliases to v1) walks the chain.
    fresh = sdu.DeltaDecoder()
    out["fresh"] = await sdu.get_state_dict(client, "ch/v3", delta_state=fresh)
    # A plain get of a delta version walks the chain on a throwaway decoder.
    out["plain"] = await sdu.get_state_dict(client, "ch/v3")
    # The keyframe's bytes vanish: a reader of v1's delta of "hot" fails
    # loudly.
    await client.delete_prefix("ch/v0")
    try:
        await sdu.get_state_dict(client, "ch/v1", {"hot": torch.zeros(600)}, strict=False,
                                 delta_state=sdu.DeltaDecoder())
        out["broken"] = None
    except RuntimeError as exc:
        out["broken"] = exc
    return out


@pytest.fixture(scope="module")
def session():
    return asyncio.run(asyncio.wait_for(store_session(), timeout=240))


@pytest.mark.parametrize("fmt", sdu.QUANT_MODES)
def test_store_round_trip_accuracy(session, fmt):
    sd, out = session[f"rt/{fmt}"]
    qmax = sdu._QMAX[fmt]
    assert out["step"] == 7
    for k in ("w", "b"):
        assert out[k].dtype == torch.float32 and tuple(out[k].shape) == sd[k].shape
        np.testing.assert_allclose(out[k].numpy(), sd[k], atol=tol(sd[k], qmax))
    # The decode is the reference's dequant of the reference's blob.
    ref_out, _ = ref_sdu.quantize_transfer({"w": sd["w"]}, fmt, 256)
    info = ref_sdu.parse_quant_blob(ref_out["w"])
    want = ref_sdu._dequant_codes(info["codes"], info["scales"][:, None]).reshape(-1)
    assert out["w"].numpy().reshape(-1).tobytes() == want[: sd["w"].size].tobytes()


def test_wire_bytes_are_the_fused_blob(session):
    n = 256 * 256
    expect = landing.quant_wire_nbytes("int8_block", 256, n, 2)
    assert session["wire_bytes"] < expect + 4096  # the blob and its marker
    assert expect < n * 1.05  # scale slots cost ~1.6 % at block 256


def test_inplace_targets(session):
    src, user, out = session["inplace"]
    assert out["w"] is user["w"] and out["h"] is user["h"]
    assert user["h"].dtype == torch.float16
    np.testing.assert_allclose(user["w"].numpy(), src["w"], atol=tol(src["w"]))
    np.testing.assert_allclose(user["h"].float().numpy(), src["h"].astype(np.float32),
                               atol=tol(src["h"]) + 2e-3)


def test_bf16_leaves_keep_their_dtype(session):
    bf, out = session["bf16"]
    assert out["w"].dtype == torch.bfloat16
    np.testing.assert_allclose(out["w"].float().numpy(), bf["w"].astype(np.float32),
                               atol=tol(bf["w"]) + 0.02)


def test_invalid_combinations(session):
    assert "mutually exclusive" in str(session["both"])
    assert "buffered-path" in str(session["direct"])
    assert "unsupported" in str(session["unknown"])
    assert "requires transfer_quant int8_block/int4_block" in str(session["delta_int8"])


def test_env_default_mode(session, monkeypatch):
    env, marker, out = session["env"]
    assert marker["quant"]["fmt"] == "int8_block" and marker["quant"]["keys"] == ["w"]
    np.testing.assert_allclose(out["w"].numpy(), env["w"], atol=tol(env["w"]))
    assert "quant" not in session["env_cast"]
    monkeypatch.setenv(port_config.ENV_TRANSFER_QUANT, "int4_block")
    monkeypatch.setenv(port_config.ENV_TRANSFER_QUANT_BLOCK, "64")
    monkeypatch.setenv(port_config.ENV_PLAN_CACHE, "0")
    cfg = port_config.StoreConfig()
    assert (cfg.transfer_quant, cfg.quant_block, cfg.plan_cache) == ("int4_block", 64, False)
    assert sdu.resolve_transfer_quant(None, None, cfg) == "int4_block"
    assert sdu.resolve_transfer_quant(None, torch.bfloat16, cfg) is None
    assert sdu.resolve_transfer_quant("none", None, cfg) is None


def test_nonfinite_leaves_rejected(session):
    assert "'w' (block 2)" in str(session["nan"]) and "non-finite" in str(session["nan"])
    assert "non-finite" in str(session["inf"])
    assert not session["nf_exists"]  # nothing was committed


def test_zero_empty_and_scalar_leaves(session):
    odd, out = session["odd"]
    assert torch.equal(out["z"], odd["z"])
    assert tuple(out["e"].shape) == (0, 8)
    assert out["s"].shape == () and abs(float(out["s"]) - 2.5) <= 2.5 / 127 + 1e-6


def test_shard_targets_take_their_box(session):
    whole, halves = session["shards"]
    assert torch.equal(torch.cat(halves), whole)


def test_target_of_another_shape_fails_loudly(session):
    assert isinstance(session["shape"], ValueError)


def test_delta_chain_through_the_store(session):
    delta = session["delta"]
    versions = delta["versions"]
    assert [sorted(v["aliases"]) for v in versions] == [
        [], ["frozen"], ["frozen", "hot"], ["frozen"], []]
    assert versions[2]["aliases"] == {"hot": 1, "frozen": 0}
    for v in versions:
        assert all(v["equal"].values())  # reader state == publisher baseline, bit for bit
        for k, src in v["src"].items():
            np.testing.assert_allclose(v["got"][k].numpy(), src.numpy(), atol=tol(src.numpy()))
    # v2 changed nothing: its floating keys ship no bytes (no key of theirs).
    assert versions[2]["keys"] == ["ch/v2/MAPPING", "ch/v2/step"]
    assert versions[2]["stored"] < versions[1]["stored"] < versions[0]["stored"]
    assert delta["served"] == 4  # v1 frozen, v2 hot and frozen, v3 frozen
    for k in ("hot", "frozen"):
        assert torch.equal(delta["fresh"][k], versions[3]["got"][k])
        assert torch.equal(delta["plain"][k], versions[3]["got"][k])
    assert delta["fresh"]["step"] == 3
    assert "delta chain broken" in str(delta["broken"])
