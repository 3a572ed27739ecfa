"""State-dict sync: flatten, commit marker, transfer-dtype cast, unflatten.

Port of ``torchstore_tpu/state_dict_utils.py``. Every tensor entry is put
under ``key/<flat_path>`` first and ``key/MAPPING`` is written LAST as the
commit marker: its presence means the state dict is complete, and readers
fetch it first and fail with ``NoMatchingPush`` when it is absent.
``direct=True`` publishes the source's staging-buffer handles instead
(``direct_weight_sync.py``). A leaf may be a tensor, a ``Shard`` or a
DTensor: a sharded leaf is put (and cast) as its rank's local shard, and a
``Shard`` or DTensor target of a get is filled with its region of the
stored tensor. Quantized, delta and streamed publishes and the
transfer-plan cache are later work.
"""

from __future__ import annotations

import weakref
from typing import Any, Optional

import numpy as np
import torch

from torchstore_tpu_torch import sharding
from torchstore_tpu_torch.client import Shard
from torchstore_tpu_torch.logging import LatencyTracker, get_logger
from torchstore_tpu_torch.ops import staging
from torchstore_tpu_torch.ops.staging import cast_reference
from torchstore_tpu_torch.transport.types import TensorSlice

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


# --------------------------------------------------------------------------
# put / get
# --------------------------------------------------------------------------


def _store_key(key: str, flat_key: str) -> str:
    return f"{key}{_SEP}{flat_key}" if flat_key else key


class _DirectSyncCache:
    """Per-client direct-sync sources and dests, keyed by state-dict key."""

    def __init__(self) -> None:
        self.sources: dict[tuple[str, int], Any] = {}
        self.dests: dict[str, tuple[Any, dict]] = {}  # key -> (dest, all_handles)

    async def close(self) -> None:
        for source in self.sources.values():
            await source.close()
        for dest, _ in self.dests.values():
            await dest.close()
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
        source = DirectWeightSyncSource(use_shm=client.config.shm_enabled)
        try:
            handles = await source.register(
                state_dict, rank, transfer_dtype, num_ranks=num_ranks
            )
        except BaseException:
            await source.close()
            raise
        cache.sources[(key, rank)] = source
        await client.put(f"{key}{_SEP}rank_{rank}", {"handles": handles})
        if rank == 0:
            # num_ranks is the direct-mode commit marker, written last.
            await client.put(f"{key}{_SEP}num_ranks", num_ranks)
    else:
        source.update_sources(state_dict)
        await source.refresh()


async def _resolve_direct_entry(client, key: str):
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
    for rank in range(num_ranks):
        try:
            published = await client.get(f"{key}{_SEP}rank_{rank}")
        except KeyError as exc:
            raise NoMatchingPush(
                f"direct push for {key!r} incomplete: rank {rank} has not published handles"
            ) from exc
        for flat_key, handle_list in published["handles"].items():
            all_handles.setdefault(flat_key, []).extend(handle_list)
    entry = (DirectWeightSyncDest(), all_handles)
    cache.dests[key] = entry
    return entry


async def _get_state_dict_direct(client, key: str, user_state_dict: Any, _retry: bool = True):
    from torchstore_tpu_torch.direct_weight_sync import PullRaceError

    if user_state_dict is None:
        raise ValueError("direct get_state_dict requires user_state_dict targets")
    cache = _direct_cache(client)
    dest, all_handles = await _resolve_direct_entry(client, key)
    try:
        return await dest.pull(all_handles, user_state_dict)
    except (ConnectionError, OSError, KeyError, ValueError, PullRaceError):
        if not _retry:
            raise
        # The source may have re-published fresh handles under the same
        # key: drop the cached set and retry once.
        cache.dests.pop(key, None)
        await dest.close()
        return await _get_state_dict_direct(client, key, user_state_dict, _retry=False)


async def put_state_dict(
    client,
    key: str,
    state_dict: Any,
    transfer_dtype: Optional[torch.dtype] = None,
    direct: bool = False,
    rank: int = 0,
    num_ranks: int = 1,
) -> None:
    if direct:
        return await _put_state_dict_direct(
            client, key, state_dict, transfer_dtype, rank, num_ranks
        )
    tracker = LatencyTracker(f"put_state_dict[{key}]")
    flat, mapping = flatten_state_dict(state_dict)
    if MAPPING_KEY in flat:
        raise ValueError(
            f"{MAPPING_KEY!r} is a reserved top-level state-dict key (it is the "
            "commit marker); rename that entry"
        )
    # No publisher-side plan memory: any publish may be a restructure the
    # index cannot see, so consumers' cached plans are invalidated each time.
    await client.bump_placement_epoch()
    if transfer_dtype is not None:
        flat = cast_floating_tensors(flat, transfer_dtype)
    tracker.track_step("flatten")
    if flat:
        await client.put_batch({_store_key(key, k): v for k, v in flat.items()})
    locals_ = [_local_leaf(v)[0] for v in flat.values()]
    nbytes = sum(t.numel() * t.element_size() for t in locals_ if t is not None)
    tracker.track_step("put_batch", nbytes)
    await client.put(_store_key(key, MAPPING_KEY), {"mapping": mapping})  # commit marker LAST
    tracker.track_step("commit_marker")
    tracker.log_summary(level=20)


def direct_sync_stats(client, key: str) -> dict:
    """This client's direct sync of ``key``: the seconds its sources (every
    rank it published) and its dest spent page-locking host memory, and the
    regions the dest's last pull copied (one per distinct intersection of a
    target with a source shard)."""
    cache = _direct_cache(client)
    sources = [s for (k, _), s in cache.sources.items() if k == key]
    dest = cache.dests.get(key, (None, None))[0]
    return {
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


async def get_state_dict(
    client, key: str, user_state_dict: Any = None, direct: bool = False, strict: bool = True
) -> Any:
    """Fetch a complete state dict. With ``user_state_dict``, its tensor
    leaves are filled in place (CPU or CUDA) and the stored structure must
    match it (``strict=False`` allows pulling a subset)."""
    if direct:
        result = await _get_state_dict_direct(client, key, user_state_dict)
        if strict:
            _, all_handles = _direct_cache(client).dests[key]
            user_flat, _ = flatten_state_dict(user_state_dict)
            missing = set(all_handles) - set(user_flat)
            if missing:
                raise ValueError(
                    f"state dict structure mismatch for {key!r}: missing in user "
                    f"dict: {sorted(missing)[:5]} (pass strict=False to pull a subset)"
                )
        return result
    tracker = LatencyTracker(f"get_state_dict[{key}]")
    try:
        marker = await client.get(_store_key(key, MAPPING_KEY))
    except KeyError as exc:
        raise NoMatchingPush(
            f"no matching push for state dict key {key!r} (commit marker absent: "
            "either never pushed or push still in flight)"
        ) from exc
    mapping = marker["mapping"]
    tracker.track_step("mapping")
    if user_state_dict is not None:
        user_flat, user_mapping = flatten_state_dict(user_state_dict)
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
        targets = {
            _store_key(key, k): (v if isinstance(v, (torch.Tensor, Shard)) else None)
            for k, v in user_flat.items()
        }
        fetched = await client.get_batch(targets)
        flat = {k: fetched[_store_key(key, k)] for k in user_flat}
        mapping = user_mapping
    else:
        keys = sorted(_leaf_keys(mapping))
        fetched = await client.get_batch([_store_key(key, k) for k in keys])
        flat = {k: fetched[_store_key(key, k)] for k in keys}
    nbytes = sum(v.numel() * v.element_size() for v in flat.values() if isinstance(v, torch.Tensor))
    tracker.track_step("get_batch", nbytes)
    result = unflatten_state_dict(flat, mapping)
    tracker.log_summary(level=20)
    return result
