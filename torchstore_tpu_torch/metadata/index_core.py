"""The controller's key -> volume index.

Port of the core of ``torchstore_tpu/metadata/index_core.py`` for whole
tensors and objects: which volumes hold each key and what they hold,
structural-change tracking for the placement epoch, and deletes. Sharded
keys and their commit tracking, replica reclaims, health-aware locates and
the stamped publication of the index are later work.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Optional

from torchstore_tpu_torch.transport.types import Request, TensorMeta


class ObjectType(Enum):
    OBJECT = "object"
    TENSOR = "tensor"


class StoreKeyError(KeyError):
    pass


@dataclass
class StorageInfo:
    """What one volume holds for one key."""

    object_type: ObjectType
    tensor_meta: Optional[TensorMeta] = None

    @classmethod
    def from_meta(cls, meta: Request) -> "StorageInfo":
        kind = ObjectType.OBJECT if meta.is_object else ObjectType.TENSOR
        return cls(object_type=kind, tensor_meta=meta.tensor_meta)


class IndexCore:
    def __init__(self) -> None:
        self.index: dict[str, dict[str, StorageInfo]] = {}

    def locate(
        self, keys: list[str], missing_ok: bool = False
    ) -> dict[str, dict[str, StorageInfo]]:
        out: dict[str, dict[str, StorageInfo]] = {}
        for key in keys:
            infos = self.index.get(key)
            if infos is None:
                if missing_ok:
                    continue
                raise StoreKeyError(f"Key {key!r} not found in store")
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

    def apply_put_batch(self, metas: list[Request], volume_ids: list[str]) -> bool:
        """Index ``metas`` as stored on every id in ``volume_ids``; returns
        True when the placement changed structurally (a new key or replica,
        or a new shape or dtype under an old key)."""
        structural = False
        for meta in metas:
            if meta.tensor_val is not None or meta.objects is not None:
                raise ValueError(
                    "controller must never receive data payloads; send meta_only() requests"
                )
            infos = self.index.get(meta.key)
            if infos is None:
                infos = self.index[meta.key] = {}
                structural = True
            for vid in volume_ids:
                new = StorageInfo.from_meta(meta)
                old = infos.get(vid)
                if old is None or old.object_type != new.object_type or (
                    old.tensor_meta != new.tensor_meta
                ):
                    structural = True
                infos[vid] = new
        return structural

    def delete_keys(self, keys: list[str]) -> dict[str, list[str]]:
        """Remove keys from the index; returns which volumes held each key
        so the caller can clear the data plane. Idempotent."""
        by_volume: dict[str, list[str]] = {}
        for key in keys:
            infos = self.index.pop(key, None)
            if infos is None:
                continue
            for vid in infos:
                by_volume.setdefault(vid, []).append(key)
        return by_volume

    def teardown(self) -> None:
        self.index.clear()
