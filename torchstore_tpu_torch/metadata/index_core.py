"""The controller's key -> volume index.

Port of the core of ``torchstore_tpu/metadata/index_core.py``: which
volumes hold each key and what they hold (a whole tensor, an object, or
the shards of a sharded tensor by mesh coordinate), commit tracking for
sharded keys, structural-change tracking for the placement epoch, deletes,
and per-key update generations with a condition the blocking waits sleep
on. Replica reclaims, health-aware locates and the stamped publication of
the index are later work.
"""

from __future__ import annotations

import asyncio
import math
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Optional

from torchstore_tpu_torch.transport.types import Request, TensorMeta, TensorSlice


class ObjectType(Enum):
    OBJECT = "object"
    TENSOR = "tensor"
    TENSOR_SLICE = "tensor_slice"


def _object_type(meta: Request) -> ObjectType:
    if meta.is_object:
        return ObjectType.OBJECT
    if meta.tensor_slice is not None:
        return ObjectType.TENSOR_SLICE
    return ObjectType.TENSOR


class StoreKeyError(KeyError):
    pass


class PartiallyCommittedError(KeyError):
    pass


@dataclass
class StorageInfo:
    """What one volume holds for one key."""

    object_type: ObjectType
    tensor_meta: Optional[TensorMeta] = None
    # coordinates -> TensorSlice, for TENSOR_SLICE keys.
    tensor_slices: dict[tuple, TensorSlice] = field(default_factory=dict)
    # The volume's write generation of the last indexed put (0: unknown).
    write_gen: int = 0

    @classmethod
    def from_meta(cls, meta: Request) -> "StorageInfo":
        info = cls(object_type=_object_type(meta), tensor_meta=meta.tensor_meta)
        if meta.tensor_slice is not None:
            info.tensor_slices[meta.tensor_slice.coordinates] = meta.tensor_slice
        return info


def _layout(meta: Request) -> tuple:
    """What a re-put must keep for an entry to stay: its kind and, for a
    shard, the mesh and global shape."""
    ts = meta.tensor_slice
    if ts is None:
        return (_object_type(meta),)
    return (ObjectType.TENSOR_SLICE, ts.mesh_shape, ts.global_shape)


def _info_layout(info: StorageInfo) -> tuple:
    if info.object_type != ObjectType.TENSOR_SLICE:
        return (info.object_type,)
    ts = next(iter(info.tensor_slices.values()))
    return (ObjectType.TENSOR_SLICE, ts.mesh_shape, ts.global_shape)


class IndexCore:
    def __init__(self) -> None:
        self.index: dict[str, dict[str, StorageInfo]] = {}
        self.counters = {"puts": 0, "put_bytes": 0, "locates": 0, "deletes": 0}
        # Bumped on every indexed put or delete of a key; the condition is
        # notified with every bump.
        self._key_gens: dict[str, int] = {}
        self._update_cond: Optional[asyncio.Condition] = None

    def cond(self) -> asyncio.Condition:
        if self._update_cond is None:
            self._update_cond = asyncio.Condition()
        return self._update_cond

    async def bump(self, keys) -> None:
        async with self.cond():
            self.bump_locked(keys)

    def bump_locked(self, keys) -> None:
        """``bump`` for a caller that holds the condition already: the
        notify that commits a put and the watermark step of a streamed
        publish share one hold of it."""
        for key in keys:
            self._key_gens[key] = self._key_gens.get(key, 0) + 1
        self.cond().notify_all()

    def contains(self, key: str) -> str:
        """'missing', 'partial' or 'committed'."""
        infos = self.index.get(key)
        return "missing" if infos is None else self.committed_state(infos)

    async def wait_for_committed(self, keys: list[str], timeout: Optional[float] = None) -> None:
        """Return once every key exists and is committed; ``TimeoutError``
        naming the keys still missing or partial otherwise."""
        cond = self.cond()

        def pending() -> list[str]:
            return [k for k in keys if self.contains(k) != "committed"]

        async with cond:
            try:
                await asyncio.wait_for(cond.wait_for(lambda: not pending()), timeout)
            except asyncio.TimeoutError:
                raise TimeoutError(
                    f"wait_for_committed timed out after {timeout}s; still "
                    f"missing/partial: {pending()[:5]}"
                ) from None

    async def wait_for_change(
        self, key: str, last_gen: int = 0, timeout: Optional[float] = None
    ) -> dict[str, Any]:
        """Return ``{"gen", "state"}`` once ``key``'s update generation
        differs from ``last_gen``: with 0, at once for any key ever written.
        Inequality, not ">": a restarted index counts from scratch, and a
        subscriber holding a larger generation must wake."""
        cond = self.cond()
        async with cond:
            try:
                await asyncio.wait_for(
                    cond.wait_for(lambda: self._key_gens.get(key, 0) != last_gen), timeout
                )
            except asyncio.TimeoutError:
                raise TimeoutError(
                    f"wait_for_change({key!r}) timed out after {timeout}s at "
                    f"generation {self._key_gens.get(key, 0)}"
                ) from None
            return {"gen": self._key_gens.get(key, 0), "state": self.contains(key)}

    def summary(self) -> dict:
        """The index half of the controller's ``stats``."""
        indexed_bytes = 0
        sharded_keys = 0
        for infos in self.index.values():
            sharded = False
            for info in infos.values():
                meta = info.tensor_meta
                if info.object_type == ObjectType.TENSOR_SLICE:
                    sharded = True
                    indexed_bytes += sum(
                        ts.nelements * meta.itemsize for ts in info.tensor_slices.values()
                    )
                elif meta is not None:
                    indexed_bytes += meta.nbytes
            sharded_keys += sharded
        return {
            **self.counters,
            "num_keys": len(self.index),
            "sharded_keys": sharded_keys,
            "indexed_bytes_approx": indexed_bytes,
        }

    @staticmethod
    def committed_state(infos: dict[str, StorageInfo]) -> str:
        """'committed' or 'partial' for one key: a sharded key is committed
        once the coordinates stored across its volumes number
        prod(mesh_shape)."""
        any_info = next(iter(infos.values()))
        if any_info.object_type != ObjectType.TENSOR_SLICE:
            return "committed"
        coords: set[tuple] = set()
        for info in infos.values():
            coords.update(info.tensor_slices)
        mesh_shape = next(iter(any_info.tensor_slices.values())).mesh_shape
        return "committed" if len(coords) >= math.prod(mesh_shape) else "partial"

    def locate(
        self, keys: list[str], missing_ok: bool = False, require_committed: bool = True
    ) -> dict[str, dict[str, StorageInfo]]:
        self.counters["locates"] += 1
        out: dict[str, dict[str, StorageInfo]] = {}
        for key in keys:
            infos = self.index.get(key)
            if infos is None:
                if missing_ok:
                    continue
                raise StoreKeyError(f"Key {key!r} not found in store")
            if require_committed and self.committed_state(infos) == "partial":
                raise PartiallyCommittedError(
                    f"Key {key!r} is only partially committed; not all mesh "
                    "coordinates have been stored yet"
                )
            out[key] = infos
        return out

    def keys_list(self, prefix: Optional[str] = None) -> list[str]:
        """Every key, or those under ``prefix`` by whole path segments
        ("a/b" holds "a/b" and "a/b/c", not "a/bc"), as the reference's
        trie matches them."""
        if prefix is None:
            return sorted(self.index)
        pre = prefix.split("/")
        return sorted(k for k in self.index if k.split("/")[: len(pre)] == pre)

    def apply_put_batch(
        self,
        metas: list[Request],
        volume_ids: list[str],
        detach_volume_ids: Optional[list[str]] = None,
        write_gens: Optional[dict[str, dict[str, int]]] = None,
    ) -> bool:
        """Index ``metas`` as stored on every id in ``volume_ids`` (with
        each volume's write generation, when given), and drop them from
        ``detach_volume_ids`` (replicas whose landing failed: they hold the
        old bytes). Returns True when the placement changed structurally (a
        new key, replica or shard coordinate, a new shape or dtype under an
        old key, a new layout, a detached replica). A put under another kind
        or layout (mesh or global shape) replaces the key's entry on every
        volume: stale shards must neither satisfy the commit check nor be
        served beside new ones."""
        structural = False
        for meta in metas:
            if meta.tensor_val is not None or meta.objects is not None:
                raise ValueError(
                    "controller must never receive data payloads; send meta_only() requests"
                )
            self.counters["puts"] += 1
            if meta.tensor_meta is not None:
                self.counters["put_bytes"] += meta.tensor_meta.nbytes
            infos = self.index.get(meta.key)
            if infos is not None and any(
                _info_layout(info) != _layout(meta) for info in infos.values()
            ):
                infos = None
            if infos is None:
                infos = self.index[meta.key] = {}
                structural = True
            for vid in volume_ids:
                gen = (write_gens or {}).get(vid, {}).get(meta.key, 0)
                old = infos.get(vid)
                if meta.tensor_slice is None:
                    new = StorageInfo.from_meta(meta)
                    new.write_gen = gen
                    if old is None or old.tensor_meta != new.tensor_meta:
                        structural = True
                    infos[vid] = new
                    continue
                if old is None:
                    old = infos[vid] = StorageInfo(ObjectType.TENSOR_SLICE)
                coords = meta.tensor_slice.coordinates
                if old.tensor_slices.get(coords) != meta.tensor_slice:
                    structural = True
                old.tensor_slices[coords] = meta.tensor_slice
                old.tensor_meta = meta.tensor_meta
                old.write_gen = max(old.write_gen, gen)
            for vid in detach_volume_ids or ():
                if infos.pop(vid, None) is not None:
                    structural = True
            if not infos:
                del self.index[meta.key]
        return structural

    def delete_keys(self, keys: list[str]) -> dict[str, list[str]]:
        """Remove keys from the index; returns which volumes held each key
        so the caller can clear the data plane. Idempotent."""
        by_volume: dict[str, list[str]] = {}
        for key in keys:
            infos = self.index.pop(key, None)
            if infos is None:
                continue
            self.counters["deletes"] += 1
            for vid in infos:
                by_volume.setdefault(vid, []).append(key)
        return by_volume

    def teardown(self) -> None:
        self.index.clear()
