"""State-dict sync: flatten, commit marker, transfer-dtype cast, the
quantized wire tier, unflatten, and the transfer-plan cache.

Port of ``torchstore_tpu/state_dict_utils.py``. Every tensor entry is put
under ``key/<flat_path>`` first and ``key/MAPPING`` is written LAST as the
commit marker: its presence means the state dict is complete, and readers
fetch it first and fail with ``NoMatchingPush`` when it is absent.
``direct=True`` publishes the source's staging-buffer handles instead
(``direct_weight_sync.py``). A leaf may be a tensor, a ``Shard`` or a
DTensor: a sharded leaf is put (and cast) as its rank's local shard, and a
``Shard`` or DTensor target of a get is filled with its region of the
stored tensor.

``transfer_quant`` ships every floating leaf as one self-describing uint8
blob, [header + shape | changed-block bitmap | packed codes | f32 scale
table] (``transport/landing.quant_blob_layout``): int8 per tensor, int8 per
block, or int4 per block. The codec is torch code that runs where the data
is: a CUDA leaf is encoded on its card and the blob is a CUDA tensor the
put path stages like any other; a CUDA target is decoded on its card from
the blob's bytes. Its f32 arithmetic repeats the reference's step for step
(amax = max(max(x), -min(x)); scale = amax / qmax, 0 -> 1; codes =
rint(x * (1 / scale)) clipped; delta codes = rint(residual / scale);
dequant = f32(codes) * f32(scales)), so a blob is byte-identical to the
JAX package's for the same input, on the card as on the CPU. Divisors on
the card are tensors there: torch turns a CPU-scalar divisor into a
reciprocal product, which is not the IEEE quotient.

The delta tier (``DeltaEncoder`` / ``DeltaDecoder``, driven through
``delta_ctx`` / ``delta_state``) ships quantized residuals against the
publisher's baseline, skips blocks within half a keyframe step, and makes
fully unchanged keys aliases of the previous version (zero bytes). With
the client's ``SyncPlanCache`` a warm put skips the epoch bump and a warm
get skips the commit marker, the structure checks and the locate: one
placement-epoch read validates its plan. Layer-streamed publishes and
acquires live in ``stream_sync.py``: ``stream_state_dict`` opens one, and
``get_state_dict(stream=True)`` (or a ``key_order`` / ``on_layer``) reads
one layer by layer.
"""

from __future__ import annotations

import asyncio
import math
import struct
import weakref
from typing import Any, Optional

import numpy as np
import torch

from torchstore_tpu_torch import faults, sharding
from torchstore_tpu_torch.client import _PLAN_HITS, _PLAN_INVALIDATIONS, _PLAN_MISSES, Shard
from torchstore_tpu_torch.logging import LatencyTracker, get_logger
from torchstore_tpu_torch.observability import metrics as obs_metrics
from torchstore_tpu_torch.ops import staging
from torchstore_tpu_torch.ops.staging import cast_reference
from torchstore_tpu_torch.transport import landing
from torchstore_tpu_torch.transport.types import TensorSlice, dtype_name, torch_dtype

logger = get_logger("torchstore_tpu_torch.state_dict")

MAPPING_KEY = "MAPPING"
_SEP = "/"


class NoMatchingPush(KeyError):
    pass


# --------------------------------------------------------------------------
# flatten / unflatten
# --------------------------------------------------------------------------


def flatten_state_dict(sd: Any) -> tuple[dict[str, Any], dict]:
    """Returns ({flat_path: leaf}, mapping). ``mapping`` is a picklable
    template of the container structure, equal to the reference's for the
    same tree."""
    flat: dict[str, Any] = {}
    mapping = _flatten_rec(sd, [], flat)
    return flat, mapping


def _flatten_rec(value: Any, path: list[str], flat: dict[str, Any]) -> dict:
    if isinstance(value, dict):
        return {
            "kind": "dict",
            "items": {
                str(k): _flatten_rec(v, path + [str(k)], flat) for k, v in value.items()
            },
            "key_types": {str(k): "int" if isinstance(k, int) else "str" for k in value},
        }
    if isinstance(value, (list, tuple)):
        entry: dict = {
            "kind": "list" if isinstance(value, list) else "tuple",
            "items": [_flatten_rec(v, path + [str(i)], flat) for i, v in enumerate(value)],
        }
        if isinstance(value, tuple) and hasattr(value, "_fields"):
            entry["kind"] = "namedtuple"
            entry["cls"] = f"{type(value).__module__}:{type(value).__qualname__}"
        return entry
    flat_key = _SEP.join(path)
    if flat_key in flat:
        raise ValueError(f"duplicate flattened key {flat_key!r}")
    flat[flat_key] = value
    return {"kind": "leaf", "key": flat_key}


def unflatten_state_dict(flat: dict[str, Any], mapping: dict) -> Any:
    return _unflatten_rec(mapping, flat)


def _unflatten_rec(entry: dict, flat: dict[str, Any]) -> Any:
    kind = entry["kind"]
    if kind == "leaf":
        return flat[entry["key"]]
    if kind == "dict":
        key_types = entry.get("key_types", {})
        return {
            (int(k) if key_types.get(k) == "int" else k): _unflatten_rec(v, flat)
            for k, v in entry["items"].items()
        }
    children = [_unflatten_rec(v, flat) for v in entry["items"]]
    if kind == "list":
        return children
    if kind == "tuple":
        return tuple(children)
    if kind == "namedtuple":
        cls = _resolve_class(entry["cls"])
        return tuple(children) if cls is None else cls(*children)
    raise ValueError(f"corrupt mapping entry {entry!r}")


def _resolve_class(spec: str):
    import importlib

    mod_name, _, qual = spec.partition(":")
    try:
        obj = importlib.import_module(mod_name)
        for part in qual.split("."):
            obj = getattr(obj, part)
        return obj
    except (ImportError, AttributeError):
        logger.warning("cannot resolve NamedTuple class %s; using plain tuple", spec)
        return None


def _leaf_keys(mapping: dict) -> set[str]:
    out: set[str] = set()

    def rec(entry: dict) -> None:
        if entry["kind"] == "leaf":
            out.add(entry["key"])
        elif entry["kind"] == "dict":
            for v in entry["items"].values():
                rec(v)
        else:
            for v in entry["items"]:
                rec(v)

    rec(mapping)
    return out


# --------------------------------------------------------------------------
# trees from numpy, dtype cast
# --------------------------------------------------------------------------


def from_numpy_tree(tree: Any, device, dtype: Optional[torch.dtype] = None) -> Any:
    """A nested dict/list/tuple of numpy arrays as torch tensors on
    ``device``, with the same structure (so flat keys and the mapping match
    the reference's for the same tree). With ``dtype=torch.bfloat16``, a
    uint16 leaf is taken as bf16 bits and a floating leaf is cast (round to
    nearest even). A numpy bf16 leaf (named "bfloat16") keeps its bits.
    Other leaves pass through."""
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [from_numpy_tree(v, device, dtype) for v in tree]
    if isinstance(tree, tuple):
        return tuple(from_numpy_tree(v, device, dtype) for v in tree)
    if not isinstance(tree, np.ndarray):
        return tree
    arr = np.ascontiguousarray(tree)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    elif dtype == torch.bfloat16 and arr.dtype == np.uint16:
        t = torch.from_numpy(arr.copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
    return t.to(device)


def shards_from_numpy(
    arr: np.ndarray, mesh_shape: tuple, spec: tuple, device, dtype: Optional[torch.dtype] = None
) -> list[Shard]:
    """The ``Shard`` of every mesh coordinate (row-major) of a global numpy
    array laid out as JAX's ``NamedSharding(mesh, PartitionSpec(*spec))``
    lays it out, on ``device`` (leaves converted as ``from_numpy_tree``
    does). ``spec`` holds per tensor dimension None, a mesh axis index or a
    tuple of them (the dimension split over those axes, the first one
    outermost); a shorter ``spec`` leaves the last dimensions whole. Every
    split dimension must divide evenly, as JAX requires."""
    axes = [() if a is None else (a,) if isinstance(a, int) else tuple(a) for a in spec]
    axes += [()] * (arr.ndim - len(axes))
    shards = []
    for coords in np.ndindex(*mesh_shape):
        offsets, local = [], []
        for dim, dim_axes in enumerate(axes):
            pieces, piece = 1, 0
            for a in dim_axes:
                pieces, piece = pieces * mesh_shape[a], piece * mesh_shape[a] + coords[a]
            if arr.shape[dim] % pieces:
                raise ValueError(f"dim {dim} of {arr.shape} does not split into {pieces}")
            size = arr.shape[dim] // pieces
            offsets.append(piece * size)
            local.append(size)
        ts = TensorSlice(tuple(offsets), tuple(local), arr.shape, coords, tuple(mesh_shape))
        data = from_numpy_tree(np.ascontiguousarray(arr[ts.box.to_index()]), device, dtype)
        shards.append(Shard(data, ts))
    return shards


def _local_leaf(value: Any):
    """(local tensor, rewrap) of a tensor leaf, or (None, None): a tensor
    is its own local tensor; a ``Shard`` has its data; a DTensor its rank's
    shard, put back as a ``Shard`` of its slice (as a plain tensor when it
    is stored as one). ``rewrap`` puts a cast of the local tensor in the
    leaf's place."""
    if isinstance(value, Shard):
        if value.data is None:
            return None, None
        ts = value.tensor_slice
        return value.data, lambda y: Shard(y, ts)
    if sharding.is_dtensor(value):
        ts = sharding.local_slice(value)
        return sharding.local_tensor(value), (lambda y: y) if ts is None else (
            lambda y: Shard(y, ts)
        )
    if isinstance(value, torch.Tensor):
        return value, lambda y: y
    return None, None


def cast_floating_tensors(flat: dict[str, Any], transfer_dtype) -> dict[str, Any]:
    """Cast floating leaves (a sharded leaf's local shard) to
    ``transfer_dtype`` before transfer: the CUDA leaves of each card through
    ``cast_on_card`` (the grouped cast kernel, one launch per chunk; a pair
    it does not cover by ``x.to()``, as the reference leaves every pair to
    XLA's ``astype``), CPU leaves by the plain cast. Leaves already in
    ``transfer_dtype`` pass as they are."""
    out = dict(flat)
    on_card: dict[torch.device, list[tuple[str, torch.Tensor, Any]]] = {}
    for k, v in flat.items():
        local, rewrap = _local_leaf(v)
        if local is None or not local.is_floating_point() or local.dtype == transfer_dtype:
            continue
        card = staging.card_of(local)
        if card is None:
            out[k] = rewrap(cast_reference(local, transfer_dtype))
        else:
            on_card.setdefault(card, []).append((k, local.contiguous(), rewrap))
    for items in on_card.values():
        for indices, outs in staging.cast_on_card([t for _, t, _ in items], transfer_dtype):
            for i, y in zip(indices, outs):
                k, _, rewrap = items[i]
                out[k] = rewrap(y)
    return out


def _leaf_signature(value: Any) -> tuple:
    """Hashable signature of one leaf as a transfer target: shape, dtype
    and placement (a DTensor's mesh and placements, a ``Shard``'s slice),
    so a plan built for one layout is never replayed for another."""
    sig = sharding.plan_signature(value)
    if sig is not None:
        return sig
    if isinstance(value, Shard):
        data = None if value.data is None else _leaf_signature(value.data)
        return ("shard", value.tensor_slice, data)
    if isinstance(value, torch.Tensor):
        return ("torch", tuple(value.shape), str(value.dtype))
    return ("obj",)


def _flat_signature(flat: dict, *extra) -> tuple:
    return tuple((k, _leaf_signature(v)) for k, v in flat.items()) + extra


# --------------------------------------------------------------------------
# transfer quantization: fused int8/int4 blobs and the delta tier
# --------------------------------------------------------------------------

QUANT_MODES = ("int8", "int8_block", "int4_block")
_QUANT_MAGIC = 0x42515354  # "TSQB" little-endian
_QUANT_CODEC = 1
# Wire packing code: 1 = one int8 code an element, 2 = packed int4 pairs.
_FMT_CODES = {"int8": 1, "int8_block": 1, "int4_block": 2}
_QMAX = {"int8": 127, "int8_block": 127, "int4_block": 7}
_FLAG_DELTA = 1
_FLAG_KEYFRAME = 2
# Bytes of a blob's head read from a card at once: the header and a shape
# of up to 8 dimensions.
_HEAD_READ = landing.QUANT_HEADER_BYTES + 64

_QUANT_BYTES_IN = obs_metrics.counter(
    "ts_quant_bytes_in_total",
    "Full-precision bytes entering the transfer-quantization tier, by fmt",
)
_QUANT_BYTES_WIRE = obs_metrics.counter(
    "ts_quant_bytes_wire_total",
    "Fused quant-blob bytes actually shipped (payload + scales), by fmt",
)
_DELTA_SKIPPED = obs_metrics.counter(
    "ts_delta_skipped_blocks_total", "Near-zero residual blocks a delta publish skipped"
)
_DELTA_KEYFRAMES = obs_metrics.counter(
    "ts_delta_keyframes_total", "Full keyframes published by the delta tier"
)
_DELTA_UNCHANGED = obs_metrics.counter(
    "ts_delta_unchanged_keys_total",
    "Delta publishes of a fully unchanged key (alias, zero bytes shipped)",
)
_DELTA_UNCHANGED_SERVED = obs_metrics.counter(
    "ts_delta_unchanged_served_total",
    "Unchanged-key reads served from the reader's accumulated state, zero re-transfer",
)
_MARKER_FETCHES = obs_metrics.counter(
    "ts_state_dict_marker_fetches_total",
    "Commit markers get_state_dict fetched (a plan-cached get fetches none)",
)


def sync_counters() -> dict:
    """This process's counts of the state-dict layer: plan-cache hits,
    misses and invalidations, commit markers fetched, and the quantized
    tier's bytes in and on the wire, keyframes, unchanged keys and the
    unchanged reads served with zero re-transfer."""
    return {
        "plan_hits_put": _PLAN_HITS.value(op="put"),
        "plan_hits_get": _PLAN_HITS.value(op="get"),
        "plan_misses": _PLAN_MISSES.total(),
        "plan_invalidations": _PLAN_INVALIDATIONS.total(),
        "marker_fetches": _MARKER_FETCHES.total(),
        "quant_bytes_in": _QUANT_BYTES_IN.total(),
        "quant_bytes_wire": _QUANT_BYTES_WIRE.total(),
        "delta_keyframes": _DELTA_KEYFRAMES.total(),
        "delta_unchanged_keys": _DELTA_UNCHANGED.total(),
        "delta_unchanged_served": _DELTA_UNCHANGED_SERVED.total(),
    }


def _f32(value: float, device) -> torch.Tensor:
    """``value`` rounded to f32, as a 0-dim tensor on ``device``."""
    return torch.full((), float(value), dtype=torch.float32, device=device)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _checked_scale(
    key: str, amax: float, qmax: float = 127.0, block: Optional[int] = None
) -> float:
    """max|x| / qmax, with a non-finite max refused loudly: a NaN would fall
    back to scale 1 and an Inf would dequantize to NaN, both silently."""
    if not math.isfinite(amax):
        where = f"{key!r}" if block is None else f"{key!r} (block {block})"
        raise ValueError(
            f"cannot quantize {where}: contains non-finite values "
            f"(max|x| = {amax}); publish unquantized or clean the weights"
        )
    return amax / qmax if amax > 0 else 1.0


def _check_finite(key: str, amax: torch.Tensor, qmax: int) -> None:
    finite = torch.isfinite(amax)
    if not bool(finite.all()):
        idx = int((~finite).nonzero()[0, 0])
        _checked_scale(key, float(amax[idx]), qmax, block=idx)


def _block_scales(key: str, amax: torch.Tensor, qmax: int, pending: Optional[list] = None):
    """Per-block f32 scales, amax / qmax with 0 -> 1, after the check that
    every block is finite (the raise names the key and the block). With
    ``pending`` a card's check is queued there for ``_check_pending``, so a
    batch of leaves waits for the card once."""
    if pending is not None and amax.is_cuda:
        pending.append((key, amax, qmax))
    else:
        _check_finite(key, amax, qmax)
    scales = amax / _f32(qmax, amax.device)
    return scales.masked_fill_(scales == 0, 1.0)


def _check_pending(pending: list) -> None:
    if not pending:
        return
    bad = torch.stack([~torch.isfinite(amax).all() for _, amax, _ in pending]).tolist()
    for (key, amax, qmax), is_bad in zip(pending, bad):
        if is_bad:
            _check_finite(key, amax, qmax)
    pending.clear()


def _dequant_codes(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """THE dequantization, f32(codes) * f32(scales): the int8 codes are
    converted exactly and the product is one IEEE f32 multiply, on either
    device, so publisher baselines and reader states never drift."""
    return torch.mul(codes, scales.to(torch.float32))


def _as_blocks(flat_f32: torch.Tensor, block: int) -> torch.Tensor:
    """1-D f32 -> (nblocks, block), the tail block zero-padded; at least
    one block, so an empty tensor stays representable."""
    n = flat_f32.shape[0]
    nblocks = max(1, -(-n // block))
    if n == nblocks * block:
        return flat_f32.reshape(nblocks, block)
    padded = torch.zeros(nblocks * block, dtype=torch.float32, device=flat_f32.device)
    padded[:n] = flat_f32
    return padded.reshape(nblocks, block)


def _pack_codes(codes: torch.Tensor, fmt_code: int) -> torch.Tensor:
    if fmt_code == 1:
        return codes.contiguous().reshape(-1).view(torch.uint8)
    u = (codes & 0x0F).to(torch.uint8)
    if u.shape[1] % 2:
        u = torch.cat([u, u.new_zeros((u.shape[0], 1))], dim=1)
    return (u[:, 0::2] | (u[:, 1::2] << 4)).reshape(-1)  # low nibble first


def _unpack_codes(packed: torch.Tensor, fmt_code: int, changed: int, block: int) -> torch.Tensor:
    if fmt_code == 1:
        return packed.view(torch.int8).reshape(changed, block)
    pb = packed.reshape(changed, (block + 1) // 2)
    u = torch.stack([pb & 0x0F, pb >> 4], dim=2).reshape(changed, -1)[:, :block]
    codes = u.to(torch.int8)
    return torch.where(codes > 7, codes - 16, codes)  # sign-extend 4-bit two's complement


def _pack_mask(mask: torch.Tensor) -> torch.Tensor:
    """bool (n,) -> uint8 ((n + 7) // 8,), element i in bit i % 8 of byte
    i // 8 (numpy's ``packbits(bitorder="little")``)."""
    n = mask.shape[0]
    bits = torch.zeros(-(-n // 8) * 8, dtype=torch.int32, device=mask.device)
    bits[:n] = mask
    shifts = torch.arange(8, dtype=torch.int32, device=mask.device)
    return (bits.reshape(-1, 8) << shifts).sum(dim=1).to(torch.uint8)


def _unpack_mask(bitmap: torch.Tensor, nblocks: int) -> torch.Tensor:
    shifts = torch.arange(8, dtype=torch.uint8, device=bitmap.device)
    return ((bitmap[:, None] >> shifts) & 1).reshape(-1)[:nblocks].to(torch.bool)


def _host_bytes(t: torch.Tensor) -> bytes:
    return t.cpu().numpy().tobytes()


def _bytes_as(raw: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A byte range as ``dtype`` (copied when its offset is misaligned)."""
    try:
        return raw.view(dtype)
    except RuntimeError:
        return raw.clone().view(dtype)


def _blob_prefix(layout: dict, fmt_code: int, flags: int, block: int, nblocks: int,
                 changed: int, shape: tuple, dtype_name_: str, version: int,
                 base_version: int, full_bitmap: bool) -> np.ndarray:
    """The blob's bytes before its payload: header, shape, and (for a
    keyframe, every block changed) the bitmap, built on the host."""
    rank = len(shape)
    head = np.zeros(layout["payload"], np.uint8)
    struct.pack_into("<IHBBIII", head, 0, _QUANT_MAGIC, _QUANT_CODEC, fmt_code, flags,
                     int(block), int(nblocks), int(changed))
    head[20] = rank
    dt = dtype_name_.encode("utf-8")[:16]
    head[21:21 + len(dt)] = np.frombuffer(dt, np.uint8)
    struct.pack_into("<Q", head, 40, math.prod(shape) if rank else 1)
    struct.pack_into("<qq", head, 48, int(base_version), int(version))
    if rank:
        struct.pack_into(f"<{rank}Q", head, 64, *(int(d) for d in shape))
    if full_bitmap:
        bm = np.packbits(np.ones(nblocks, np.uint8), bitorder="little")
        head[layout["bitmap"]:layout["bitmap"] + bm.nbytes] = bm
    return head


def _build_quant_blob(
    fmt: str,
    block: int,
    shape: tuple,
    dtype_name_: str,
    nblocks: int,
    changed_mask: Optional[torch.Tensor],
    codes: torch.Tensor,
    scales: torch.Tensor,
    flags: int,
    version: int,
    base_version: int,
) -> torch.Tensor:
    """One fused wire blob on ``codes``' device. ``codes``: (changed, block)
    int8; ``scales``: (changed,) f32; ``changed_mask``: (nblocks,) bool, or
    None when every block is in (a keyframe)."""
    fmt_code = _FMT_CODES[fmt]
    changed = int(codes.shape[0])
    layout = landing.quant_blob_layout(len(shape), nblocks, changed, fmt, block)
    blob = torch.empty(layout["total"], dtype=torch.uint8, device=codes.device)
    prefix = torch.from_numpy(
        _blob_prefix(layout, fmt_code, flags, block, nblocks, changed, shape, dtype_name_,
                     version, base_version, changed_mask is None)
    )
    if blob.is_cuda:
        blob[:prefix.numel()].copy_(prefix.pin_memory(), non_blocking=True)
    else:
        blob[:prefix.numel()].copy_(prefix)
    if changed_mask is not None:
        bm = _pack_mask(changed_mask)
        blob[layout["bitmap"]:layout["bitmap"] + bm.numel()] = bm
    payload = _pack_codes(codes, fmt_code)
    end = layout["payload"] + payload.numel()
    blob[layout["payload"]:end] = payload
    blob[end:layout["scales"]].zero_()
    end = layout["scales"] + 4 * changed
    blob[layout["scales"]:end] = scales.to(torch.float32).contiguous().view(torch.uint8)
    blob[end:].zero_()
    return blob


def parse_quant_blob(value: Any, head: Optional[bytes] = None) -> Optional[dict]:
    """One fused quant blob's sections (tensors on the blob's device, views
    where possible); None when ``value`` is not a blob (not a 1-D uint8
    tensor, or no magic). ``head``: the blob's first bytes already on the
    host (a get reads every card blob's head in one copy)."""
    if not is_quant_blob(value, head):
        return None
    blob = value.contiguous()
    if head is None or len(head) < landing.QUANT_HEADER_BYTES:
        head = _host_bytes(blob[:_HEAD_READ])
    fmt_code, flags, block, nblocks, changed = struct.unpack_from("<BBIII", head, 6)
    rank = head[20]
    if len(head) < landing.QUANT_HEADER_BYTES + 8 * rank:
        head = _host_bytes(blob[:landing.QUANT_HEADER_BYTES + 8 * rank])
    dtype_name_ = head[21:37].split(b"\0", 1)[0].decode("utf-8")
    (nelems,) = struct.unpack_from("<Q", head, 40)
    base_version, version = struct.unpack_from("<qq", head, 48)
    shape = tuple(int(d) for d in struct.unpack_from(f"<{rank}Q", head, 64)) if rank else ()
    fmt = "int4_block" if fmt_code == 2 else "int8_block"
    layout = landing.quant_blob_layout(rank, nblocks, changed, fmt, block)
    mask = _unpack_mask(blob[layout["bitmap"]:layout["bitmap"] + (nblocks + 7) // 8], nblocks)
    payload = blob[layout["payload"]:layout["payload"]
                   + landing.quant_payload_nbytes(fmt, block, changed)]
    scales = _bytes_as(blob[layout["scales"]:layout["scales"] + 4 * changed], torch.float32)
    return {
        "fmt": fmt,
        "flags": flags,
        "block": int(block),
        "nblocks": int(nblocks),
        "mask": mask,
        "codes": _unpack_codes(payload, fmt_code, changed, block),
        "scales": scales,
        "shape": shape,
        "dtype": dtype_name_,
        "nelems": int(nelems),
        "base_version": int(base_version),
        "version": int(version),
    }


def is_quant_blob(value: Any, head: Optional[bytes] = None) -> bool:
    """Whether ``value`` is a fused quant blob, from its magic alone (no
    section is unpacked). ``head``: its first bytes already on the host."""
    if (
        not isinstance(value, torch.Tensor)
        or value.dtype != torch.uint8
        or value.dim() != 1
        or value.numel() < landing.QUANT_HEADER_BYTES
    ):
        return False
    if head is None or len(head) < 6:
        head = _host_bytes(value[:6])
    magic, codec = struct.unpack_from("<IH", head, 0)
    return magic == _QUANT_MAGIC and codec == _QUANT_CODEC


def _read_heads(blobs: dict[str, Any]) -> dict[str, bytes]:
    """The first ``_HEAD_READ`` bytes of every uint8 tensor on a card in
    ``blobs``, one copy to the host per card."""
    by_card: dict[torch.device, list[str]] = {}
    for k, b in blobs.items():
        if isinstance(b, torch.Tensor) and b.is_cuda and b.dtype == torch.uint8 and b.dim() == 1:
            by_card.setdefault(b.device, []).append(k)
    out: dict[str, bytes] = {}
    for keys in by_card.values():
        parts = [blobs[k][:_HEAD_READ] for k in keys]
        host = _host_bytes(torch.cat(parts))
        off = 0
        for k, part in zip(keys, parts):
            out[k] = host[off:off + part.numel()]
            off += part.numel()
    return out


def _is_floating(value: Any) -> bool:
    """A tensor or DTensor leaf of a floating dtype (a ``Shard`` has no
    dtype and passes through unquantized, as in the reference)."""
    return isinstance(value, torch.Tensor) and value.is_floating_point()


def _leaf_tensor(value: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a quantizable leaf (a DTensor on a one-rank mesh
    holds it locally; ``_guard_quantizable`` refuses the others)."""
    return sharding.local_tensor(value) if sharding.is_dtensor(value) else value.detach()


def _guard_quantizable(key: str, value: Any) -> None:
    if sharding.is_dtensor(value) and value.device_mesh.size() > 1:
        # The scale must be global and the same on every rank: an eager max
        # over one rank's shard cannot give it.
        raise NotImplementedError(
            f"transfer_quant on DTensor {key!r}, whose mesh spans "
            f"{value.device_mesh.size()} ranks: compute the quantized tensor and "
            "its scales inside your step (a global max through a collective) and "
            "put those, or use transfer_dtype instead"
        )


def _leaf_f32_blocks(value: torch.Tensor, block: int) -> torch.Tensor:
    flat = value.reshape(-1)
    if flat.dtype != torch.float32:
        flat = flat.to(torch.float32)
    return _as_blocks(flat, block)


def _encode_keyframe_from_blocks(
    key: str,
    xb: torch.Tensor,
    shape: tuple,
    dtype_name_: str,
    fmt: str,
    block: int,
    version: int = -1,
    pending: Optional[list] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize blocked f32 data on its device: (blob, codes, scales)."""
    qmax = _QMAX[fmt]
    lo, hi = torch.aminmax(xb, dim=1)
    amax = torch.maximum(hi, -lo)  # max|x| without an abs() temporary
    scales = _block_scales(key, amax, qmax, pending)
    recip = torch.ones_like(scales) / scales
    q = xb * recip[:, None]
    q.round_()  # half to even, as np.rint
    q.clamp_(-qmax, qmax)
    codes = q.to(torch.int8)
    del q
    blob = _build_quant_blob(fmt, block, shape, dtype_name_, xb.shape[0], None, codes,
                             scales, _FLAG_KEYFRAME, version, version)
    return blob, codes, scales


def _encode_keyframe_blob(
    key: str, value: torch.Tensor, fmt: str, block: int, version: int = -1,
    pending: Optional[list] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize one whole leaf: (blob, xb, codes, scales). The per-tensor
    ``int8`` mode is one block spanning the tensor."""
    xb = _leaf_f32_blocks(value, block)
    blob, codes, scales = _encode_keyframe_from_blocks(
        key, xb, tuple(value.shape), dtype_name(value.dtype), fmt, block, version, pending
    )
    return blob, xb, codes, scales


def _quant_leaf_block(fmt: str, block: int, value: Any) -> int:
    """Block size of one leaf: the whole tensor for ``int8``, else
    ``block``."""
    if fmt != "int8":
        return block
    return max(1, math.prod(tuple(value.shape)))


def _record_quant_bytes(fmt: str, bytes_in: int, bytes_wire: int) -> None:
    _QUANT_BYTES_IN.inc(int(bytes_in), fmt=fmt)
    _QUANT_BYTES_WIRE.inc(int(bytes_wire), fmt=fmt)


def _quant_jobs(flat: dict[str, Any]):
    """(passed through, [(key, whole tensor)] to quantize, dtypes) of a
    flat dict, every quantizable leaf checked first."""
    passed: dict[str, Any] = {}
    jobs: list[tuple[str, torch.Tensor]] = []
    dtypes: dict[str, str] = {}
    for key, value in flat.items():
        if not _is_floating(value):
            passed[key] = value
            continue
        _guard_quantizable(key, value)
        tensor = _leaf_tensor(value)
        jobs.append((key, tensor))
        dtypes[key] = dtype_name(tensor.dtype)
    return passed, jobs, dtypes


def _encode_leaf(key: str, tensor: torch.Tensor, fmt: str, block: int,
                 pending: Optional[list] = None) -> torch.Tensor:
    return _encode_keyframe_blob(key, tensor, fmt, _quant_leaf_block(fmt, block, tensor),
                                 pending=pending)[0]


def _quant_out(flat: dict, fmt: str, block: int, quant_jobs: tuple, blobs: dict,
               pending: list) -> tuple[dict[str, Any], dict]:
    """Check the queued finiteness, count the bytes, and return (out_flat,
    marker_meta) in ``flat``'s order."""
    passed, jobs, dtypes = quant_jobs
    _check_pending(pending)
    for key, tensor in jobs:
        _record_quant_bytes(fmt, _nbytes(tensor), blobs[key].numel())
    out = {k: blobs[k] if k in blobs else passed[k] for k in flat}
    return out, {"fmt": fmt, "block": block, "keys": [k for k, _ in jobs], "dtypes": dtypes}


def quantize_transfer(flat: dict[str, Any], fmt: str, block: int) -> tuple[dict[str, Any], dict]:
    """Quantize every floating leaf of ``flat`` into a self-contained
    keyframe blob on the leaf's device. Returns (out_flat, marker_meta):
    the marker names the quantized keys and their dtypes; the scales ride
    the blobs. Other leaves pass through."""
    quant_jobs = _quant_jobs(flat)
    pending: list = []
    blobs = {k: _encode_leaf(k, t, fmt, block, pending) for k, t in quant_jobs[1]}
    return _quant_out(flat, fmt, block, quant_jobs, blobs, pending)


def quantize_int8(flat: dict[str, Any]) -> tuple[dict[str, Any], dict]:
    """Per-tensor symmetric int8 over the fused-blob format."""
    return quantize_transfer(flat, "int8", 0)


async def quantize_transfer_async(
    flat: dict[str, Any], fmt: str, block: int, config=None
) -> tuple[dict[str, Any], dict]:
    """``quantize_transfer`` for the put path: CPU leaves are encoded on
    the landing pool's threads at once; CUDA leaves on their card, queued
    from the event loop (the card runs them in order), with one wait for
    the card's finiteness checks at the end."""
    quant_jobs = _quant_jobs(flat)
    pending: list = []
    blobs = {k: _encode_leaf(k, t, fmt, block, pending) for k, t in quant_jobs[1] if t.is_cuda}
    host = [k for k, t in quant_jobs[1] if not t.is_cuda]
    results = await asyncio.gather(*(
        landing.run_in_pool(_encode_leaf, k, t, fmt, block, config=config)
        for k, t in quant_jobs[1] if not t.is_cuda
    ))
    blobs.update(zip(host, results))
    return _quant_out(flat, fmt, block, quant_jobs, blobs, pending)


def _delta_version_key(channel: str, version: int) -> str:
    """The state-dict key of one channel version (the chain walks versions
    by name)."""
    return f"{channel}/v{int(version)}"


async def _delta_encode_flat(
    flat: dict[str, Any], fmt: str, block: int, delta_ctx: dict
) -> tuple[dict[str, Any], dict, dict[str, int]]:
    """Delta-encode one version's flat dict through the publisher's codec:
    (flat to put, marker meta, {flat_key: base_version} aliases). An
    unchanged key is absent from the put (zero bytes) and aliased in the
    marker."""
    codec: DeltaEncoder = delta_ctx["codec"]
    if codec.fmt != fmt:
        raise ValueError(f"delta codec fmt {codec.fmt!r} != transfer_quant {fmt!r}")
    version = int(delta_ctx["version"])
    passed, jobs, dtypes = _quant_jobs(flat)
    results = await asyncio.gather(*(codec.encode(k, t, version) for k, t in jobs))
    aliases = {k: int(base) for (k, _), (blob, base) in zip(jobs, results) if blob is None}
    blobs = {k: blob for (k, _), (blob, _) in zip(jobs, results) if blob is not None}
    out = {k: blobs[k] if k in blobs else passed[k] for k in flat if k not in aliases}
    meta = {
        "fmt": fmt,
        "block": codec.block,
        "keys": [k for k, _ in jobs],
        "dtypes": dtypes,
        "delta": {"channel": delta_ctx["channel"], "version": version, "aliases": aliases},
    }
    return out, meta, aliases


async def _run_where(t: torch.Tensor, fn, *args):
    """``fn(*args)`` on the event loop for a CUDA tensor (the card queues
    the work), on the landing pool for a CPU one."""
    if t.is_cuda:
        return fn(*args)
    return await landing.run_in_pool(fn, *args)


class DeltaEncoder:
    """Publisher-side state of the delta tier: per key the dequantized f32
    baseline readers reconstruct (the same arithmetic, so baseline and
    reader state are bit-identical), kept on the device of the leaf it
    encodes.

    Per key and version the encoder emits a KEYFRAME blob (first publish,
    restructure, or cadence), a DELTA blob of the changed blocks only, or
    None: the key is unchanged and the publish aliases the previous
    version. A block is unchanged while its residual max|w_t - baseline|
    is within half the scale step of its last keyframe plus ``skip_eps``;
    the residual is always taken against the live ``w_t``, so skipped error
    never compounds."""

    def __init__(self, fmt: str, block: int, keyframe_every: int, skip_eps: float = 0.0) -> None:
        if fmt not in ("int8_block", "int4_block"):
            raise ValueError(f"delta encoding requires a blockwise mode, not {fmt!r}")
        self.fmt = fmt
        self.block = max(1, int(block))
        self.keyframe_every = max(1, int(keyframe_every))
        self.skip_eps = float(skip_eps)
        # flat key -> {"sig", "baseline" (nblocks, block) f32, "kf_scales",
        #              "base_version" (last shipped), "keyframe_version"}
        self.entries: dict[str, dict] = {}

    def drop(self, key: Optional[str] = None) -> None:
        """Forget baselines: the next publish of a dropped key keyframes."""
        if key is None:
            self.entries.clear()
        else:
            self.entries.pop(key, None)

    def _delta_math(self, key: str, xb: torch.Tensor, entry: dict, shape: tuple,
                    dtype_name_: str, version: int):
        """One delta step, reading the baseline and changing nothing: None
        for an unchanged key, else (blob, changed mask, dequantized delta,
        blocks skipped)."""
        qmax = _QMAX[self.fmt]
        resid = xb - entry["baseline"]
        amax = resid.abs().amax(dim=1)
        scales_full = _block_scales(key, amax, qmax)
        threshold = _f32(0.5, xb.device) * entry["kf_scales"] + _f32(self.skip_eps, xb.device)
        changed = amax > threshold
        nchanged = int(changed.sum())
        skipped = int(xb.shape[0]) - nchanged
        if nchanged == 0:
            return None
        scales = scales_full[changed]
        codes = torch.clamp(torch.round(resid[changed] / scales[:, None]), -qmax, qmax)
        codes = codes.to(torch.int8)
        blob = _build_quant_blob(self.fmt, self.block, shape, dtype_name_, xb.shape[0],
                                 changed, codes, scales, _FLAG_DELTA, version,
                                 entry["base_version"])
        return blob, changed, _dequant_codes(codes, scales[:, None]), skipped

    async def encode(self, key: str, value: torch.Tensor, version: int):
        """(blob, None) to ship, or (None, base_version) when the key is
        unchanged and aliases that version's bytes. A CPU leaf's math runs
        on the landing pool; every change to the entries happens here."""
        version = int(version)
        tensor = _leaf_tensor(value)
        xb = _leaf_f32_blocks(tensor, self.block)
        shape, dtype = tuple(tensor.shape), dtype_name(tensor.dtype)
        sig = (tuple(xb.shape), shape, dtype)
        entry = self.entries.get(key)
        if entry is not None:
            # A fault here (a lost or corrupt baseline) surfaces loudly, never
            # as a delta over stale bytes.
            await faults.afire("channel.delta_baseline")
            if entry["sig"] != sig:
                entry = None  # restructure: the baseline means nothing
            elif entry["base_version"] >= version:
                raise RuntimeError(
                    f"delta baseline for {key!r} is at v{entry['base_version']} but "
                    f"v{version} is being encoded: version numbering moved backwards "
                    "- refusing to delta over a stale baseline (drop() the key to "
                    "re-keyframe)"
                )
        if entry is None or (version - entry["keyframe_version"]) >= self.keyframe_every:
            blob, codes, scales = await _run_where(
                xb, _encode_keyframe_from_blocks, key, xb, shape, dtype, self.fmt,
                self.block, version,
            )
            self.entries[key] = {
                "sig": sig,
                "baseline": _dequant_codes(codes, scales[:, None]),
                # The keyframe's scales are the noise floor the skip rule
                # measures against until the next keyframe.
                "kf_scales": scales,
                "base_version": version,
                "keyframe_version": version,
            }
            _DELTA_KEYFRAMES.inc()
            _record_quant_bytes(self.fmt, _nbytes(tensor), blob.numel())
            return blob, None
        res = await _run_where(xb, self._delta_math, key, xb, entry, shape, dtype, version)
        if res is None:
            _DELTA_SKIPPED.inc(int(xb.shape[0]))
            _DELTA_UNCHANGED.inc()
            _record_quant_bytes(self.fmt, _nbytes(tensor), 0)
            return None, entry["base_version"]
        blob, changed, dq, skipped = res
        _DELTA_SKIPPED.inc(skipped)
        # The baseline moves by the DEQUANTIZED delta, what readers apply.
        entry["baseline"][changed] += dq
        entry["base_version"] = version
        _record_quant_bytes(self.fmt, _nbytes(tensor), blob.numel())
        return blob, None


class DeltaDecoder:
    """Reader-side accumulated f32 state, one entry per flat key, on the
    device of the key's target (the CPU without one). A keyframe replaces
    the state; a delta needs the state at the blob's base version, else the
    decoder walks the chain back to a keyframe through ``fetch_base``; a
    broken chain raises, never serving a drifted state."""

    def __init__(self) -> None:
        # flat key -> {"version", "blocks", "shape", "dtype", "nelems"}
        self.state: dict[str, dict] = {}

    def drop(self, key: Optional[str] = None) -> None:
        if key is None:
            self.state.clear()
        else:
            self.state.pop(key, None)

    def serve_unchanged(self, flat_key: str, base_version: int):
        """The state entry when it holds the aliased base version already
        (zero re-transfer), else None (the caller fetches the base)."""
        st = self.state.get(flat_key)
        if st is None or st["version"] != int(base_version):
            return None
        _DELTA_UNCHANGED_SERVED.inc()
        return st

    async def decode(self, flat_key: str, blob: Any, fetch_base=None, _depth: int = 0,
                     device=None, head: Optional[bytes] = None) -> dict:
        """Apply one blob (a uint8 tensor or a parsed dict); returns the
        state entry. The blob's bytes move to the state's device (or
        ``device``) before anything is unpacked. ``fetch_base(version)``
        returns that version's blob of this key."""
        st = self.state.get(flat_key)
        if device is None:
            device = st["blocks"].device if st is not None else getattr(blob, "device", None)
        if isinstance(blob, torch.Tensor) and device is not None and blob.device != device:
            blob, head = blob.to(device), None
        info = blob if isinstance(blob, dict) else parse_quant_blob(blob, head)
        if info is None:
            raise ValueError(
                f"{flat_key!r}: fetched value is not a quant blob (marker and bytes "
                "disagree about quantization)"
            )
        if _depth > 1024:
            raise RuntimeError(
                f"delta chain for {flat_key!r} exceeds 1024 hops - keyframe cadence is broken"
            )
        dev = info["codes"].device
        if info["flags"] & _FLAG_DELTA:
            base = info["base_version"]
            if st is None or st["version"] != base or st["shape"] != info["shape"]:
                held = f"v{st['version']}" if st else "no baseline"
                if fetch_base is None:
                    raise RuntimeError(
                        f"delta blob for {flat_key!r} (v{info['version']}) applies on "
                        f"v{base} but this reader holds {held} and has no chain "
                        "context to re-fetch it"
                    )
                try:
                    base_blob = await fetch_base(base)
                except KeyError as exc:
                    raise RuntimeError(
                        f"delta chain broken for {flat_key!r}: baseline v{base} was "
                        f"evicted before this reader (holding {held}) accumulated it - "
                        "refusing to serve a drifted state; raise the channel's keep "
                        "or lower the keyframe cadence"
                    ) from exc
                await self.decode(flat_key, base_blob, fetch_base=fetch_base,
                                  _depth=_depth + 1, device=dev)
                st = self.state[flat_key]
                if st["version"] != base:
                    raise RuntimeError(
                        f"delta chain for {flat_key!r} resolved to v{st['version']}, "
                        f"expected v{base}"
                    )
            # A fault here proves a lost baseline fails loudly rather than
            # accumulating onto stale state.
            await faults.afire("channel.delta_baseline")
            if st["blocks"].device != dev:
                st["blocks"] = st["blocks"].to(dev)
            st["blocks"][info["mask"]] += _dequant_codes(info["codes"], info["scales"][:, None])
            st["version"] = info["version"]
            st["dtype"] = info["dtype"] or st["dtype"]
            return st
        if info["codes"].shape[0] == info["nblocks"]:
            # A full keyframe: dequantize straight into the state.
            blocks = _dequant_codes(info["codes"], info["scales"][:, None])
        else:
            blocks = torch.zeros((info["nblocks"], info["block"]), dtype=torch.float32,
                                 device=dev)
            if info["codes"].numel():
                blocks[info["mask"]] = _dequant_codes(info["codes"], info["scales"][:, None])
        st = {
            "version": info["version"],
            "blocks": blocks,
            "shape": info["shape"],
            "dtype": info["dtype"],
            "nelems": info["nelems"],
        }
        self.state[flat_key] = st
        return st


def _copy_checked(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)`` without broadcasting: a shape that differs raises."""
    if tuple(dst.shape) != tuple(src.shape):
        raise ValueError(f"destination shape {tuple(dst.shape)} != fetched {tuple(src.shape)}")
    dst.copy_(src)


def _quant_result(st: dict, user_leaf: Any, dtype_name_: Optional[str] = None):
    """One decoded state entry toward the user's leaf: filled in place for
    a tensor, ``Shard`` or DTensor target (its region), a fresh tensor of
    the stored dtype otherwise. Always copies out of the state."""
    want = torch_dtype(dtype_name_ or st["dtype"] or "float32")
    arr = st["blocks"].reshape(-1)[: st["nelems"]].reshape(st["shape"])
    if isinstance(user_leaf, Shard):
        ts = user_leaf.tensor_slice
        if tuple(ts.global_shape) != tuple(st["shape"]):
            raise ValueError(f"target global shape {ts.global_shape} != stored {st['shape']}")
        region = arr[ts.box.to_index()]
        if user_leaf.data is None:
            return region.to(want, copy=True)
        _copy_checked(user_leaf.data, region)
        return user_leaf.data
    if sharding.is_dtensor(user_leaf):
        ts = sharding.target_slice(user_leaf)
        if tuple(ts.global_shape) != tuple(st["shape"]):
            raise ValueError(f"target global shape {ts.global_shape} != stored {st['shape']}")
        _copy_checked(sharding.local_tensor(user_leaf), arr[ts.box.to_index()])
        return user_leaf
    if isinstance(user_leaf, torch.Tensor):
        _copy_checked(user_leaf, arr)
        return user_leaf
    return arr.to(want, copy=True)


def resolve_transfer_quant(transfer_quant: Optional[str], transfer_dtype, config) -> Optional[str]:
    """The quant mode of one publish: an explicit argument wins; else the
    config's default, but never over an explicit ``transfer_dtype``."""
    if transfer_quant is None:
        if transfer_dtype is not None or config is None:
            return None
        transfer_quant = getattr(config, "transfer_quant", "none")
    if transfer_quant in (None, "none", ""):
        return None
    if transfer_quant not in QUANT_MODES:
        raise ValueError(
            f"unsupported transfer_quant {transfer_quant!r} (choose from "
            f"none|{'|'.join(QUANT_MODES)})"
        )
    return transfer_quant


# --------------------------------------------------------------------------
# put / get
# --------------------------------------------------------------------------


def _store_key(key: str, flat_key: str) -> str:
    return f"{key}{_SEP}{flat_key}" if flat_key else key


class _DirectSyncCache:
    """Per-client direct-sync sources and dests, keyed by state-dict key."""

    def __init__(self) -> None:
        self.sources: dict[tuple[str, int], Any] = {}
        # key -> (dest, all_handles, device_infos or None)
        self.dests: dict[str, tuple[Any, dict, Optional[list]]] = {}

    async def close(self) -> None:
        for source in self.sources.values():
            await source.close()
        for entry in self.dests.values():
            await entry[0].close()
        self.sources.clear()
        self.dests.clear()


# Weakly keyed by client: a collected client cannot hand its cache on.
_direct_caches: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _direct_cache(client) -> _DirectSyncCache:
    cache = _direct_caches.get(client)
    if cache is None:
        cache = _direct_caches[client] = _DirectSyncCache()
    return cache


async def close_direct_caches(client) -> None:
    """Release the staging segments and peer servers of this client's
    direct-sync sources and dests."""
    cache = _direct_caches.pop(client, None)
    if cache is not None:
        await cache.close()


async def _put_state_dict_direct(
    client, key: str, state_dict: Any, transfer_dtype, rank: int, num_ranks: int
) -> None:
    from torchstore_tpu_torch.direct_weight_sync import DirectWeightSyncSource

    cache = _direct_cache(client)
    source = cache.sources.get((key, rank))
    if source is None:
        config = client.config
        source = DirectWeightSyncSource(use_shm=config.shm_enabled, config=config)
        try:
            handles = await source.register(
                state_dict, rank, transfer_dtype, num_ranks=num_ranks
            )
        except BaseException:
            await source.close()
            raise
        cache.sources[(key, rank)] = source
        published = {"handles": handles}
        if source.device_info is not None:
            # The device rung: dests copy card to card from the staging.
            published["device"] = source.device_info
        await client.put(f"{key}{_SEP}rank_{rank}", published)
        if rank == 0:
            # num_ranks is the direct-mode commit marker, written last.
            await client.put(f"{key}{_SEP}num_ranks", num_ranks)
    else:
        source.update_sources(state_dict)
        await source.refresh()


async def _resolve_direct_entry(client, key: str):
    """The cached (dest, all_handles, device_infos) of a direct-pushed key,
    fetching the published handles and making the dest on first use (the
    pull and ``preplan_direct`` share it)."""
    from torchstore_tpu_torch.direct_weight_sync import DirectWeightSyncDest

    cache = _direct_cache(client)
    entry = cache.dests.get(key)
    if entry is not None:
        return entry
    try:
        num_ranks = await client.get(f"{key}{_SEP}num_ranks")
    except KeyError as exc:
        raise NoMatchingPush(f"no matching direct push for state dict key {key!r}") from exc
    all_handles: dict[str, list] = {}
    device_infos: list = []
    for rank in range(num_ranks):
        try:
            published = await client.get(f"{key}{_SEP}rank_{rank}")
        except KeyError as exc:
            raise NoMatchingPush(
                f"direct push for {key!r} incomplete: rank {rank} has not published handles"
            ) from exc
        for flat_key, handle_list in published["handles"].items():
            all_handles.setdefault(flat_key, []).extend(handle_list)
        if published.get("device") is not None:
            device_infos.append(published["device"])
    if device_infos and len(device_infos) != num_ranks:
        raise RuntimeError(
            f"direct push {key!r}: {len(device_infos)} of {num_ranks} ranks published on the "
            "device rung; a mixed device / host publication cannot be merged (check that "
            "ici_enabled agrees across ranks)"
        )
    entry = (DirectWeightSyncDest(), all_handles, device_infos or None)
    cache.dests[key] = entry
    return entry


async def preplan_direct(client, key: str, user_state_dict: Any) -> dict:
    """``api.prewarm``'s hook for the direct acquire: resolve the published
    handles, build and cache the transfer plan, dial the sources and attach
    same-host staging, so the first ``get_state_dict(direct=True)`` starts
    at the data movement. A device-rung publication has no host plan."""
    dest, all_handles, device_infos = await _resolve_direct_entry(client, key)
    if device_infos is not None:
        return {"ok": True, "errors": {}, "plan_ops": 0, "device": True}
    return {"ok": True, "errors": {}, **await dest.preplan(all_handles, user_state_dict)}


async def _get_state_dict_direct(client, key: str, user_state_dict: Any, _retry: bool = True,
                                 key_order: Optional[list] = None, on_layer=None):
    from torchstore_tpu_torch.direct_weight_sync import PullRaceError

    if user_state_dict is None:
        raise ValueError("direct get_state_dict requires user_state_dict targets")
    cache = _direct_cache(client)
    dest, all_handles, device_infos = await _resolve_direct_entry(client, key)
    try:
        if device_infos is not None:
            # The device rung takes no ordering, as in the reference.
            return await dest.pull_device(device_infos, user_state_dict)
        return await dest.pull(all_handles, user_state_dict, key_order, on_layer)
    except (ConnectionError, OSError, KeyError, ValueError, PullRaceError):
        if not _retry:
            raise
        # The source may have re-published fresh handles under the same
        # key: drop the cached set and retry once.
        cache.dests.pop(key, None)
        await dest.close()
        return await _get_state_dict_direct(client, key, user_state_dict, _retry=False,
                                            key_order=key_order, on_layer=on_layer)


async def put_state_dict(
    client,
    key: str,
    state_dict: Any,
    transfer_dtype: Optional[torch.dtype] = None,
    transfer_quant: Optional[str] = None,
    direct: bool = False,
    rank: int = 0,
    num_ranks: int = 1,
    delta_ctx: Optional[dict] = None,
) -> None:
    """Publish ``state_dict`` under ``key``. ``transfer_dtype`` casts the
    floating leaves for the wire; ``transfer_quant`` (or the config's
    default) ships them as fused int8/int4 blobs instead, and with
    ``delta_ctx`` ({"codec": DeltaEncoder, "version", "channel"}, the key
    being ``channel/v<version>``) as deltas against the previous version."""
    config = getattr(client, "config", None)
    # The config's default never applies to a direct publish (it serves live
    # staging buffers); an explicit transfer_quant still raises below.
    transfer_quant = resolve_transfer_quant(transfer_quant, transfer_dtype,
                                            None if direct else config)
    if transfer_quant is not None:
        if transfer_dtype is not None:
            raise ValueError(
                "transfer_quant and transfer_dtype are mutually exclusive "
                "(quantization defines the wire format)"
            )
        if direct:
            raise ValueError(
                "transfer_quant is a buffered-path feature (the direct path serves "
                "live staging buffers, not encoded copies)"
            )
    if delta_ctx is not None and transfer_quant not in ("int8_block", "int4_block"):
        raise ValueError(
            "delta publishing requires transfer_quant int8_block/int4_block "
            f"(got {transfer_quant!r})"
        )
    quant_block = config.quant_block if config is not None else 256
    if direct:
        return await _put_state_dict_direct(
            client, key, state_dict, transfer_dtype, rank, num_ranks
        )
    tracker = LatencyTracker(f"put_state_dict[{key}]")
    flat, mapping = flatten_state_dict(state_dict)
    cache = getattr(client, "plan_cache", None)
    plan = signature = None
    if cache is not None:
        # The quant mode and block size are in the signature: the block
        # size lays out every blob, so changing it is a restructure.
        signature = _flat_signature(
            flat, ("cast", str(transfer_dtype), transfer_quant, quant_block)
        )
        if cache.last_put_sig.get(key) != signature:
            # A publish this client cannot prove unchanged bumps the epoch:
            # a republish that only drops keys deletes nothing, so the
            # index cannot see it (and a restarted publisher remembers
            # nothing).
            await client.bump_placement_epoch()
        cache.last_put_sig[key] = signature
        plan = cache.lookup("put", key, signature)
    else:
        # No signature memory: any publish may be a restructure the index
        # cannot see, so consumers' cached plans are invalidated each time.
        await client.bump_placement_epoch()
    if plan is None:
        if MAPPING_KEY in flat:
            raise ValueError(
                f"{MAPPING_KEY!r} is a reserved top-level state-dict key (it is the "
                "commit marker); rename that entry"
            )
        store_keys = {k: _store_key(key, k) for k in flat}
    else:
        store_keys = plan["store_keys"]
    marker: dict = {"mapping": mapping}
    if transfer_dtype is not None:
        flat = cast_floating_tensors(flat, transfer_dtype)
    if transfer_quant is not None:
        if delta_ctx is not None:
            flat, quant_meta, _ = await _delta_encode_flat(flat, transfer_quant, quant_block,
                                                           delta_ctx)
        else:
            flat, quant_meta = await quantize_transfer_async(flat, transfer_quant, quant_block,
                                                             config=config)
        marker["quant"] = quant_meta
    tracker.track_step("flatten")
    if plan is None:
        # The automatic provisioning hint: the first put of a large working
        # set provisions pools and dials for what it puts (cast or encoded
        # already) before its data-plane puts; once per size signature per
        # client, never failing the put. A cached plan skips even the check.
        from torchstore_tpu_torch.provision import maybe_auto_prewarm

        await maybe_auto_prewarm(client, flat)
        tracker.track_step("prewarm_hint")
    if flat:
        # An unchanged delta key is absent from ``flat``: an all-unchanged
        # publish puts the marker alone.
        await client.put_batch({store_keys[k]: v for k, v in flat.items()})
    locals_ = [_local_leaf(v)[0] for v in flat.values()]
    nbytes = sum(_nbytes(t) for t in locals_ if t is not None)
    tracker.track_step("put_batch", nbytes)
    await client.put(_store_key(key, MAPPING_KEY), marker)  # commit marker LAST
    tracker.track_step("commit_marker")
    if cache is not None and plan is None and delta_ctx is None:
        # A delta publish's key is a version never put again: no plan.
        cache.store("put", key, signature, {"store_keys": store_keys})
    tracker.log_summary(level=20)


def direct_sync_stats(client, key: str) -> dict:
    """This client's direct sync of ``key``: the rung it rides (``device``
    or ``host``, as its sources registered or its dest resolved), the
    seconds its sources (every rank it published) and its dest spent
    page-locking host memory, and the regions the dest's last host-rung
    pull copied (one per distinct intersection of a target with a source
    shard)."""
    cache = _direct_cache(client)
    sources = [s for (k, _), s in cache.sources.items() if k == key]
    entry = cache.dests.get(key)
    dest = None if entry is None else entry[0]
    device = (entry[2] is not None if entry is not None
              else any(s.device_info is not None for s in sources))
    return {
        "rung": "device" if device else "host",
        "source_pin_seconds": sum(s.pin_seconds for s in sources),
        "dest_pin_seconds": 0.0 if dest is None else dest.pin_seconds,
        "pulled_regions": 0 if dest is None else dest.planned_ops,
    }


def direct_staging_buffers(client, key: str, rank: int = 0) -> Any:
    """After a direct push of ``key``: the registered staging buffers in the
    original structure (write weights straight into them to make later
    direct puts copy-free), or None."""
    source = _direct_cache(client).sources.get((key, rank))
    return None if source is None else source.staging_state_dict()


def stream_state_dict(
    client, key: str, transfer_dtype=None, transfer_quant: Optional[str] = None
):
    """Open a layer-streamed publish of ``key``: push fragments with
    ``await stream.put(...)`` as tensors become ready, then ``await
    stream.seal()`` (see ``stream_sync``)."""
    from torchstore_tpu_torch import stream_sync

    return stream_sync.stream_state_dict(
        client, key, transfer_dtype=transfer_dtype, transfer_quant=transfer_quant
    )


async def get_state_dict(
    client,
    key: str,
    user_state_dict: Any = None,
    direct: bool = False,
    strict: bool = True,
    key_order: Optional[list] = None,
    on_layer=None,
    stream: bool = False,
    delta_state: Optional[DeltaDecoder] = None,
) -> Any:
    """Fetch a complete state dict. With ``user_state_dict``, its tensor
    leaves are filled in place (CPU or CUDA) and the stored structure must
    match it (``strict=False`` allows pulling a subset). A quantized leaf is
    decoded on its target's device; ``delta_state`` is the reader's
    ``DeltaDecoder`` across the versions of a delta channel.

    ``stream=True`` (or a ``key_order`` / ``on_layer``) reads a streamed
    publish layer by layer, each key once its watermark lands, in
    ``key_order`` when given, with ``on_layer(flat_key, value)`` per served
    leaf; a key never streamed is served by the barrier path. With
    ``direct=True`` they order the one-hop pull instead (on the host rung;
    the device rung pulls every key at once and ignores them, as the
    reference does)."""
    if not direct and (stream or key_order is not None or on_layer is not None):
        from torchstore_tpu_torch import stream_sync

        return await stream_sync.get_state_dict_streamed(
            client, key, user_state_dict=user_state_dict, key_order=key_order,
            on_layer=on_layer, strict=strict, delta_state=delta_state,
        )
    if direct:
        result = await _get_state_dict_direct(client, key, user_state_dict,
                                              key_order=key_order, on_layer=on_layer)
        entry = _direct_cache(client).dests.get(key)
        if strict and entry is not None:
            _, all_handles, device_infos = entry
            published = set(all_handles)
            for info in device_infos or ():
                published |= set(info["keys"])
            user_flat, _ = flatten_state_dict(user_state_dict)
            missing = published - set(user_flat)
            if missing:
                raise ValueError(
                    f"state dict structure mismatch for {key!r}: missing in user "
                    f"dict: {sorted(missing)[:5]} (pass strict=False to pull a subset)"
                )
        return result
    tracker = LatencyTracker(f"get_state_dict[{key}]")
    cache = getattr(client, "plan_cache", None)
    user_flat = user_mapping = None
    if user_state_dict is not None:
        user_flat, user_mapping = flatten_state_dict(user_state_dict)
    signature = epoch_at_build = None
    if cache is not None:
        signature = _flat_signature(user_flat) if user_flat is not None else ("none",)
        if cache.peek("get", key, signature) is not None:
            # One epoch read validates the whole plan in place of the
            # marker fetch, the structure checks and the locate; a moved
            # epoch drops it here and the full path runs.
            await client.placement_epoch()
            plan = cache.lookup("get", key, signature)
            if plan is not None:
                return await _get_with_plan(client, key, plan, user_flat, user_mapping,
                                            tracker, delta_state)
        if cache.epoch is None:
            await client.placement_epoch()
        # The epoch read BEFORE the marker: a structural change landing
        # while the plan is built must leave the plan stale.
        epoch_at_build = cache.epoch
    _MARKER_FETCHES.inc()
    try:
        marker = await client.get(_store_key(key, MAPPING_KEY))
    except KeyError as exc:
        raise NoMatchingPush(
            f"no matching push for state dict key {key!r} (commit marker absent: "
            "either never pushed or push still in flight)"
        ) from exc
    mapping = marker["mapping"]
    quant = marker.get("quant")
    tracker.track_step("mapping")
    if user_state_dict is not None:
        stored_keys = _leaf_keys(mapping)
        extra = set(user_flat) - stored_keys
        if extra:
            raise ValueError(f"user dict keys not present in push {key!r}: {sorted(extra)[:5]}")
        missing = stored_keys - set(user_flat)
        if strict and missing:
            raise ValueError(
                f"state dict structure mismatch for {key!r}: missing in user dict: "
                f"{sorted(missing)[:5]} (pass strict=False to pull a subset)"
            )
        pairs = [(k, _store_key(key, k), _is_fetch_target(v)) for k, v in user_flat.items()]
        mapping = user_mapping
    else:
        pairs = [(k, _store_key(key, k), False) for k in sorted(_leaf_keys(mapping))]
    flat = await _fetch_quant_aware(client, quant, pairs, user_flat, delta_state)
    tracker.track_step("get_batch", _flat_nbytes(flat))
    result = unflatten_state_dict(flat, mapping)
    if cache is not None:
        cache.store(
            "get",
            key,
            signature,
            # The stored mapping rebuilds the structure only without a
            # user dict; the quant meta lets a warm get decode with no
            # marker.
            {"targets": pairs, "mapping": mapping if user_flat is None else None,
             "quant": quant},
            epoch=epoch_at_build,
        )
    tracker.log_summary(level=20)
    return result


async def _get_with_plan(client, key, plan, user_flat, user_mapping, tracker, delta_state=None):
    """A plan-cache hit: the epoch read just now validated the plan, so the
    get goes straight to the data plane (cached locations hold for the same
    reason, so the fetch reads no epoch again)."""
    flat = await _fetch_quant_aware(client, plan["quant"], plan["targets"], user_flat,
                                    delta_state, epoch_checked=True)
    tracker.track_step("get_batch_planned", _flat_nbytes(flat))
    result = unflatten_state_dict(flat, user_mapping if user_flat is not None else plan["mapping"])
    tracker.log_summary(level=20)
    return result


def _flat_nbytes(flat: dict) -> int:
    return sum(_nbytes(v) for v in flat.values() if isinstance(v, torch.Tensor))


def _is_fetch_target(value: Any) -> bool:
    return isinstance(value, (torch.Tensor, Shard))


def _blob_landing(quant: dict, user_leaf: Any) -> Optional[torch.Tensor]:
    """A card buffer the size of the keyframe blob of a plain CUDA tensor
    target, so the get lands the blob's bytes straight on its card; None
    otherwise (the blob is fetched to the host). A blob of another size
    fails the fetch: the stored tensor is not what the target expects."""
    if (
        not isinstance(user_leaf, torch.Tensor)
        or not user_leaf.is_cuda
        or sharding.is_dtensor(user_leaf)
    ):
        return None
    fmt = quant["fmt"]
    nbytes = landing.quant_wire_nbytes(
        fmt, _quant_leaf_block(fmt, quant["block"], user_leaf), user_leaf.numel(), user_leaf.dim()
    )
    return torch.empty(nbytes, dtype=torch.uint8, device=user_leaf.device)


def _leaf_device(leaf: Any) -> torch.device:
    """Where a target's decoded state lives: its tensor's device (the CPU
    without a target)."""
    if isinstance(leaf, Shard):
        leaf = leaf.data
    elif sharding.is_dtensor(leaf):
        leaf = sharding.local_tensor(leaf)
    return leaf.device if isinstance(leaf, torch.Tensor) else torch.device("cpu")


async def _fetch_quant_aware(
    client,
    quant: Optional[dict],
    pairs: list[tuple],
    user_flat: Optional[dict],
    delta_state: Optional[DeltaDecoder],
    epoch_checked: bool = False,
) -> dict[str, Any]:
    """Fetch and decode one state dict's leaves; ``pairs`` is
    [(flat_key, store_key, in_place)] over every leaf. A quantized key
    fetches its blob (into a card buffer for a CUDA target: the host-to-
    device copy carries the wire bytes) and is decoded toward the user's
    leaf on that leaf's device; an unchanged alias resolves to its base
    version's key, or to ``delta_state`` with zero re-transfer when that
    holds the base already. Without ``delta_state`` each key's decoded
    state goes with its leaf."""
    def target_of(fk: str, fetch: bool):
        return user_flat[fk] if fetch and user_flat is not None else None

    if quant is None:
        targets = {sk: target_of(fk, fetch) for fk, sk, fetch in pairs}
        fetched = await client.get_batch(targets, _epoch_checked=epoch_checked)
        return {fk: fetched[sk] for fk, sk, _ in pairs}
    qkeys = set(quant["keys"])
    delta = quant.get("delta") or {}
    aliases = delta.get("aliases") or {}
    channel = delta.get("channel")
    local: dict[str, dict] = {}
    targets: dict[str, Any] = {}
    fetch_sk: dict[str, str] = {}
    for fk, sk, fetch in pairs:
        if fk in qkeys:
            if fk in aliases:
                st = None if delta_state is None else delta_state.serve_unchanged(fk, aliases[fk])
                if st is not None:
                    local[fk] = st
                    continue
                sk = _store_key(_delta_version_key(channel, aliases[fk]), fk)
            # A delta blob's size is not the keyframe's: fetched to the host.
            targets[sk] = None if delta else _blob_landing(quant, target_of(fk, fetch))
        else:
            targets[sk] = target_of(fk, fetch)
        fetch_sk[fk] = sk
    fetched = await client.get_batch(targets, _epoch_checked=epoch_checked) if targets else {}
    # One turn of the loop lets the finished fetch tasks drop their results,
    # so each blob is freed as soon as its key is decoded.
    await asyncio.sleep(0)
    heads = _read_heads({fk: fetched[fetch_sk[fk]] for fk in fetch_sk if fk in qkeys})
    flat: dict[str, Any] = {}
    for fk, _, fetch in pairs:
        if fk not in qkeys:
            flat[fk] = fetched[fetch_sk[fk]]
            continue
        target = target_of(fk, fetch)
        st = local.get(fk)
        if st is None:
            decoder = delta_state if delta_state is not None else DeltaDecoder()
            st = await decoder.decode(
                fk, fetched.pop(fetch_sk[fk]), fetch_base=_chain_fetcher(client, channel, fk),
                device=_leaf_device(target), head=heads.get(fk),
            )
        flat[fk] = _quant_result(st, target, quant["dtypes"].get(fk))
    return flat


def _chain_fetcher(client, channel: Optional[str], flat_key: str):
    """The base-blob fetcher of a delta chain walk, or None for a marker
    without a channel (keyframes never need a base)."""
    if channel is None:
        return None

    async def fetch_base(version: int):
        return await client.get(_store_key(_delta_version_key(channel, version), flat_key))

    return fetch_base
