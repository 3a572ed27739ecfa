"""The per-process store client.

Port of ``torchstore_tpu/client.py`` for whole tensors and picklable
objects: a put lands the payloads on the strategy's volume through the
chosen transport, then indexes them at the controller; a get locates the
keys, fetches from the volume, and lands each tensor in the caller's
target when one is given (CPU or CUDA, filled in place) or returns a fresh
tensor (a zero-copy view on the shared-memory rung). A CUDA payload is
staged to the host by the transport (straight into the shared segment on
the shared-memory rung). DTensor resharding, replication, the plan and
location caches and the one-sided planes are later work.
"""

from __future__ import annotations

import asyncio
from typing import Any, Optional

import torch

from torchstore_tpu_torch.config import StoreConfig, default_config
from torchstore_tpu_torch.logging import get_logger
from torchstore_tpu_torch.metadata.index_core import ObjectType, StorageInfo
from torchstore_tpu_torch.runtime import ActorDiedError, ActorRef
from torchstore_tpu_torch.strategy import StorageVolumeRef
from torchstore_tpu_torch.transport.buffers import TransportContext
from torchstore_tpu_torch.transport.factory import create_transport_buffer
from torchstore_tpu_torch.transport.types import OpaqueBlob, Request

logger = get_logger("torchstore_tpu_torch.client")


class LocalClient:
    def __init__(self, controller: ActorRef, config: Optional[StoreConfig] = None) -> None:
        self._controller = controller
        self._config = config or default_config()
        self._strategy = None
        self._volume_refs: Optional[dict[str, StorageVolumeRef]] = None
        self._ctx = TransportContext()

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
    def _value_to_request(key: str, value: Any) -> Request:
        if isinstance(value, torch.Tensor):
            return Request.from_tensor(key, value.detach())
        # Objects are pickled here, in the client: volumes carry bytes.
        return Request.from_objects(key, OpaqueBlob.wrap(value))

    def _put_volume(self) -> StorageVolumeRef:
        vid = self._strategy.select_volume_id(
            self._strategy.get_client_id(), list(self._volume_refs)
        )
        return self._volume_refs[vid]

    async def put(self, key: str, value: Any) -> None:
        await self.put_batch({key: value})

    async def put_batch(self, items: dict[str, Any]) -> None:
        """Land every item on the strategy's volume, then index them all in
        one notify: a key is visible to readers only once its bytes landed."""
        await self._ensure_setup()
        requests = [self._value_to_request(k, v) for k, v in items.items()]
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
        """All-or-nothing batched get: a missing key fails the batch before
        data moves. ``items`` is a list of keys or {key: target or None};
        a tensor target is filled in place and returned."""
        if isinstance(items, str):
            raise TypeError("get_batch takes a list of keys or a {key: target} dict")
        if not isinstance(items, dict):
            items = {key: None for key in items}
        await self._ensure_setup()
        for attempt in (0, 1):
            located = await self._controller.locate_volumes.call_one(list(items))
            try:
                return await self._fetch(items, located)
            except FileNotFoundError:
                # A concurrent put replaced a segment between serve and
                # attach; a fresh locate + fetch sees the new one.
                if attempt:
                    raise
        raise AssertionError("unreachable")

    async def _fetch(
        self, items: dict[str, Any], located: dict[str, dict[str, StorageInfo]]
    ) -> dict[str, Any]:
        by_volume: dict[str, list[Request]] = {}
        for key, target in items.items():
            infos = located[key]
            vid = sorted(infos)[0]
            info = infos[vid]
            if info.object_type == ObjectType.OBJECT:
                req = Request(key=key, is_object=True)
            else:
                req = Request(key=key, tensor_meta=info.tensor_meta)
                if target is not None:
                    if not isinstance(target, torch.Tensor):
                        raise TypeError(f"get target for {key!r} must be a tensor")
                    if tuple(target.shape) != info.tensor_meta.shape:
                        raise ValueError(
                            f"target shape {tuple(target.shape)} != stored "
                            f"{info.tensor_meta.shape} for key {key!r}"
                        )
                    req.destination_view = target
            by_volume.setdefault(vid, []).append(req)

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
        out: dict[str, Any] = {}
        for (_, requests), values in zip(ordered, results):
            for req, value in zip(requests, values):
                out[req.key] = value.unwrap() if isinstance(value, OpaqueBlob) else value
        return {key: out[key] for key in items}

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
        located = await self._controller.locate_volumes.call_one([key], missing_ok=True)
        return key in located
