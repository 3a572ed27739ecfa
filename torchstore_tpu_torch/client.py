"""The per-process store client.

Port of ``torchstore_tpu/client.py``: a put lands the payloads on the
strategy's volume through the chosen transport, then indexes them at the
controller; a get locates the keys, fetches from the volumes, and lands
each tensor in the caller's target when one is given (CPU or CUDA, filled
in place) or returns a fresh tensor (a zero-copy view on the shared-memory
rung). A CUDA payload is staged to the host by the transport (straight into
the shared segment on the shared-memory rung).

Sharded values: a ``Shard`` (data plus its ``TensorSlice``) or a DTensor's
local shard is put under its mesh coordinates; a key commits once every
coordinate is stored. A get with a ``Shard``, ``TensorSlice`` or DTensor
target intersects the wanted region with every stored shard, fetches each
distinct intersection once (replicated shards hold identical ones) and
lands it straight into the target's view: for a CUDA target one
host-to-device copy per intersection, with no assembly on the host. A
DTensor target's local tensor is filled in place. Replication, the plan and
location caches and the one-sided planes are later work.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Any, Optional

import torch

from torchstore_tpu_torch import sharding
from torchstore_tpu_torch.config import StoreConfig, default_config
from torchstore_tpu_torch.logging import get_logger
from torchstore_tpu_torch.metadata.index_core import ObjectType, StorageInfo
from torchstore_tpu_torch.runtime import ActorDiedError, ActorRef
from torchstore_tpu_torch.strategy import StorageVolumeRef
from torchstore_tpu_torch.transport.buffers import TransportContext
from torchstore_tpu_torch.transport.factory import create_transport_buffer
from torchstore_tpu_torch.transport.types import OpaqueBlob, Request, TensorSlice
from torchstore_tpu_torch.utils import (
    Box,
    assemble_tensor,
    get_destination_view,
    intersect_boxes,
)

logger = get_logger("torchstore_tpu_torch.client")


@dataclass
class Shard:
    """An explicit shard for put and get: its data (a CPU or CUDA tensor of
    ``tensor_slice.local_shape``; None for a get that returns a fresh
    tensor) and its place in the global tensor and the mesh."""

    data: Optional[torch.Tensor]
    tensor_slice: TensorSlice


@dataclass
class _Want:
    """One key of a get: the wanted region (None: the whole stored value),
    the in-place destination covering ``dest_box`` of the global tensor,
    and what the get returns once the destination is filled."""

    key: str
    wanted: Optional[TensorSlice] = None
    dest: Optional[torch.Tensor] = None
    dest_box: Optional[Box] = None
    result: Any = None


class LocalClient:
    def __init__(self, controller: ActorRef, config: Optional[StoreConfig] = None) -> None:
        self._controller = controller
        self._config = config or default_config()
        self._strategy = None
        self._volume_refs: Optional[dict[str, StorageVolumeRef]] = None
        self._ctx = TransportContext()
        # Tensor parts fetched from volumes: one per whole tensor, one per
        # distinct intersection of a wanted region with a stored shard.
        self.parts_fetched = 0

    @property
    def config(self) -> StoreConfig:
        return self._config

    async def _ensure_setup(self) -> None:
        if self._volume_refs is not None:
            return
        self._controller.rpc_timeout = self._config.rpc_timeout
        strategy = await self._controller.get_strategy.call_one()
        vmap = await self._controller.get_volume_map.call_one()
        forced = strategy.default_transport_type if strategy else None
        refs = {}
        for vid, info in vmap.items():
            info["ref"].rpc_timeout = self._config.rpc_timeout
            refs[vid] = StorageVolumeRef(
                actor=info["ref"],
                volume_id=vid,
                transport_context=self._ctx,
                hostname=info["hostname"],
                transport_type=forced,
            )
        self._strategy = strategy
        self._volume_refs = refs

    async def bump_placement_epoch(self) -> int:
        """Invalidate every consumer's cached transfer plans."""
        return await self._controller.bump_placement_epoch.call_one()

    # ------------------------------------------------------------------
    # put
    # ------------------------------------------------------------------

    @staticmethod
    def _value_to_requests(key: str, value: Any) -> list[Request]:
        if isinstance(value, Shard):
            data = None if value.data is None else value.data.detach()
            return [Request.from_tensor_slice(key, value.tensor_slice, data)]
        if sharding.is_dtensor(value):
            return sharding.put_requests(key, value)
        if isinstance(value, torch.Tensor):
            return [Request.from_tensor(key, value.detach())]
        # Objects are pickled here, in the client: volumes carry bytes.
        return [Request.from_objects(key, OpaqueBlob.wrap(value))]

    def _put_volume(self) -> StorageVolumeRef:
        vid = self._strategy.select_volume_id(
            self._strategy.get_client_id(), list(self._volume_refs)
        )
        return self._volume_refs[vid]

    async def put(self, key: str, value: Any) -> None:
        await self.put_batch({key: value})

    async def put_batch(self, items: dict[str, Any]) -> None:
        """Land every item on the strategy's volume, then index them all in
        one notify: a key is visible to readers only once its bytes landed
        (a sharded key once every coordinate has)."""
        await self._ensure_setup()
        requests = [r for k, v in items.items() for r in self._value_to_requests(k, v)]
        volume = self._put_volume()
        buffer = create_transport_buffer(volume, self._config)
        await buffer.put_to_storage_volume(volume, requests)
        await self._controller.notify_put_batch.call_one(
            [r.meta_only() for r in requests], volume.volume_id
        )

    # ------------------------------------------------------------------
    # get
    # ------------------------------------------------------------------

    async def get(self, key: str, like: Any = None) -> Any:
        return (await self.get_batch({key: like}))[key]

    async def get_batch(self, items) -> dict[str, Any]:
        """All-or-nothing batched get: a missing or partially committed key
        fails the batch before data moves. ``items`` is a list of keys or
        {key: target or None}. A tensor target is filled in place and
        returned; a ``Shard`` target fills its data (returned) with its
        region, or returns a fresh tensor of it when the data is None; a
        ``TensorSlice`` returns a fresh tensor of its region; a DTensor's
        local tensor is filled with its shard and the DTensor returned."""
        if isinstance(items, str):
            raise TypeError("get_batch takes a list of keys or a {key: target} dict")
        if not isinstance(items, dict):
            items = {key: None for key in items}
        wants = [self._want(key, like) for key, like in items.items()]
        await self._ensure_setup()
        for attempt in (0, 1):
            located = await self._controller.locate_volumes.call_one(list(items))
            try:
                return await self._fetch(wants, located)
            except FileNotFoundError:
                # A concurrent put replaced a segment between serve and
                # attach; a fresh locate + fetch sees the new one.
                if attempt:
                    raise
        raise AssertionError("unreachable")

    @staticmethod
    def _want(key: str, like: Any) -> _Want:
        if like is None:
            return _Want(key)
        if sharding.is_dtensor(like):
            ts = sharding.target_slice(like)
            return _Want(key, ts, sharding.local_tensor(like), ts.box, like)
        if isinstance(like, torch.Tensor):
            return _Want(key, None, like, Box((0,) * like.ndim, tuple(like.shape)), like)
        if isinstance(like, Shard):
            ts = like.tensor_slice
            if like.data is not None and tuple(like.data.shape) != ts.local_shape:
                raise ValueError(
                    f"Shard target data shape {tuple(like.data.shape)} != slice local_shape "
                    f"{ts.local_shape} for key {key!r}"
                )
            return _Want(key, ts, like.data, ts.box, like.data)
        if isinstance(like, TensorSlice):
            return _Want(key, like)
        raise TypeError(f"unsupported get target {type(like)} for {key!r}")

    def _volume_requests(
        self, want: _Want, infos: dict[str, StorageInfo]
    ) -> list[tuple[str, Request]]:
        """The (volume id, request) pairs that fetch ``want``: one for an
        object or a whole stored tensor, one per distinct intersection of
        the wanted region with the stored shards for a sharded key."""
        ordered = sorted(infos)
        info = infos[ordered[0]]
        key = want.key
        if info.object_type == ObjectType.OBJECT:
            return [(ordered[0], Request(key=key, is_object=True))]
        if info.object_type == ObjectType.TENSOR:
            stored = [(ordered[0], None, info)]
            global_shape = info.tensor_meta.shape
        else:
            stored = [(vid, ts, infos[vid]) for vid in ordered
                      for ts in infos[vid].tensor_slices.values()]
            global_shape = stored[0][1].global_shape
        full = Box((0,) * len(global_shape), tuple(global_shape))
        if want.wanted is not None and want.wanted.global_shape != full.shape:
            raise ValueError(
                f"requested global shape {want.wanted.global_shape} != stored "
                f"{full.shape} for key {key!r}"
            )
        if want.wanted is None and want.dest is not None and want.dest_box != full:
            raise ValueError(
                f"target shape {want.dest_box.shape} != stored {full.shape} for key {key!r}"
            )
        region = full if want.wanted is None else want.wanted.box
        subs: list[tuple[str, Request]] = []
        seen: set[Box] = set()
        covered = 0
        for vid, ts, vinfo in stored:
            inter = intersect_boxes(ts.box if ts is not None else full, region)
            if inter is None or inter in seen:
                continue  # disjoint, or a replica's identical region
            seen.add(inter)
            covered += inter.size
            if ts is None:  # a whole stored tensor: the region of it, or all of it
                part = None if want.wanted is None else want.wanted.with_box(inter)
            else:
                part = ts.with_box(inter)  # the stored shard's coordinates find it
            sub = Request(key=key, tensor_slice=part, tensor_meta=vinfo.tensor_meta)
            if want.dest is not None:
                sub.destination_view = get_destination_view(
                    want.dest, want.dest_box, inter, require_contiguous=False
                )
            subs.append((vid, sub))
        if covered < region.size:
            raise ValueError(
                f"stored shards of {key!r} cover only {covered} of the {region.size} "
                f"elements of {region}"
            )
        return subs

    async def _fetch(
        self, wants: list[_Want], located: dict[str, dict[str, StorageInfo]]
    ) -> dict[str, Any]:
        plans = [self._volume_requests(want, located[want.key]) for want in wants]
        by_volume: dict[str, list[Request]] = {}
        for subs in plans:
            for vid, sub in subs:
                by_volume.setdefault(vid, []).append(sub)
        self.parts_fetched += sum(not r.is_object for reqs in by_volume.values() for r in reqs)

        async def fetch_volume(vid: str, requests: list[Request]) -> list[Any]:
            volume = self._volume_refs[vid]
            buffer = create_transport_buffer(volume, self._config)
            try:
                return await buffer.get_from_storage_volume(volume, requests)
            except (ConnectionError, OSError) as exc:
                if isinstance(exc, FileNotFoundError):
                    raise
                raise ActorDiedError(f"volume {vid} unreachable: {exc!r}") from exc

        ordered = sorted(by_volume.items())
        results = await asyncio.gather(*(fetch_volume(v, reqs) for v, reqs in ordered))
        fetched: dict[int, Any] = {}
        for (_, requests), values in zip(ordered, results):
            for req, value in zip(requests, values):
                fetched[id(req)] = value
        return {
            want.key: self._assemble(
                want, [(sub, fetched[id(sub)]) for _, sub in subs], located[want.key]
            )
            for want, subs in zip(wants, plans)
        }

    @staticmethod
    def _assemble(want: _Want, parts: list[tuple[Request, Any]], infos: dict) -> Any:
        """The value a get returns for ``want`` from its fetched parts."""
        if parts and parts[0][0].is_object:
            value = parts[0][1]
            return value.unwrap() if isinstance(value, OpaqueBlob) else value
        if want.dest is not None:
            return want.result  # every part landed in its view of the target
        if len(parts) == 1 and parts[0][0].tensor_slice is None:
            return parts[0][1]  # a whole stored tensor
        if not parts:  # an empty region
            meta = next(iter(infos.values())).tensor_meta
            return torch.empty(want.wanted.local_shape, dtype=meta.torch_dtype)
        out, _ = assemble_tensor([(value, sub.tensor_slice.offsets) for sub, value in parts])
        return out

    # ------------------------------------------------------------------
    # delete / keys / exists
    # ------------------------------------------------------------------

    async def delete(self, key: str) -> None:
        await self.delete_batch([key])

    async def delete_batch(self, keys: list[str]) -> None:
        """De-index first (readers stop finding the keys), then clear the
        volumes that held them."""
        await self._ensure_setup()
        by_volume = await self._controller.notify_delete_batch.call_one(keys)
        await asyncio.gather(
            *(
                self._volume_refs[vid].actor.delete_batch.call_one(vkeys)
                for vid, vkeys in sorted(by_volume.items())
            )
        )

    async def keys(self, prefix: Optional[str] = None) -> list[str]:
        return await self._controller.keys.call_one(prefix)

    async def exists(self, key: str) -> bool:
        located = await self._controller.locate_volumes.call_one(
            [key], missing_ok=True, require_committed=False
        )
        return key in located
