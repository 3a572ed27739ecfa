"""Controller actor: the store's metadata plane.

Port of the core endpoints of ``torchstore_tpu/controller.py`` (``init``,
``locate_volumes``, ``notify_put_batch``, ``notify_delete_batch``, ``keys``,
``placement_epoch``, ``bump_placement_epoch``, ``teardown``, plus the volume
map clients load), with commit tracking for sharded keys. The relay, tiering, control, autoscale and mirror
engines of the reference are not part of this port yet. The controller
never sees tensor bytes: only ``Request.meta_only()`` copies.
"""

from __future__ import annotations

import asyncio
from typing import Any, Optional

from torchstore_tpu_torch.logging import get_logger
from torchstore_tpu_torch.metadata.index_core import IndexCore, StorageInfo
from torchstore_tpu_torch.runtime import Actor, ActorRef, endpoint
from torchstore_tpu_torch.transport.types import Request

logger = get_logger("torchstore_tpu_torch.controller")


class Controller(Actor):
    def __init__(self) -> None:
        self.strategy = None
        self.volume_refs: dict[str, ActorRef] = {}
        self.volume_hostnames: dict[str, str] = {}
        self.core = IndexCore()
        # Bumped on every structural placement change: one cheap RPC lets a
        # consumer validate a whole cached transfer plan.
        self._placement_epoch = 0

    def _bump_epoch(self) -> int:
        self._placement_epoch += 1
        return self._placement_epoch

    @endpoint
    async def init(self, strategy, volume_refs: list[ActorRef]) -> dict[str, Any]:
        """Resolve volume ids with a ``get_id`` fan-out and adopt the
        strategy."""
        self.strategy = strategy
        infos = await asyncio.gather(*(ref.get_id.call_one() for ref in volume_refs))
        self.volume_refs = {}
        self.volume_hostnames = {}
        for ref, info in zip(volume_refs, infos):
            vid = str(info["volume_id"])
            if vid in self.volume_refs:
                raise ValueError(f"duplicate volume id {vid!r}; check strategy env wiring")
            self.volume_refs[vid] = ref
            self.volume_hostnames[vid] = info["hostname"]
        return {"volume_ids": sorted(self.volume_refs), "hostnames": self.volume_hostnames}

    @endpoint
    async def get_strategy(self):
        return self.strategy

    @endpoint
    async def get_volume_map(self) -> dict[str, dict]:
        return {
            vid: {"ref": ref, "hostname": self.volume_hostnames[vid]}
            for vid, ref in self.volume_refs.items()
        }

    @endpoint
    async def locate_volumes(
        self, keys: list[str], missing_ok: bool = False, require_committed: bool = True
    ) -> dict[str, dict[str, StorageInfo]]:
        """Where each key lives; a sharded key not yet stored at every mesh
        coordinate raises ``PartiallyCommittedError`` unless
        ``require_committed`` is off."""
        return self.core.locate(keys, missing_ok, require_committed)

    @endpoint
    async def notify_put_batch(self, metas: list[Request], volume_id: "str | list[str]") -> int:
        """Index ``metas`` as stored on ``volume_id`` (one id or a list);
        returns the placement epoch."""
        volume_ids = [volume_id] if isinstance(volume_id, str) else list(volume_id)
        if self.core.apply_put_batch(metas, volume_ids):
            self._bump_epoch()
        return self._placement_epoch

    @endpoint
    async def notify_delete_batch(self, keys: list[str]) -> dict[str, list[str]]:
        """Remove keys from the index first (notify-before-delete) and
        return which volumes held each key."""
        by_volume = self.core.delete_keys(keys)
        if by_volume:
            self._bump_epoch()
        return by_volume

    @endpoint
    async def placement_epoch(self) -> int:
        return self._placement_epoch

    @endpoint
    async def bump_placement_epoch(self) -> int:
        """Invalidate every cached transfer plan: publishers call it for a
        restructure the index cannot see."""
        return self._bump_epoch()

    @endpoint
    async def keys(self, prefix: Optional[str] = None) -> list[str]:
        return self.core.keys_list(prefix)

    @endpoint
    async def teardown(self) -> None:
        """Reset every volume and forget the index."""
        results = await asyncio.gather(
            *(ref.reset.call_one() for ref in self.volume_refs.values()),
            return_exceptions=True,
        )
        for vid, res in zip(self.volume_refs, results):
            if isinstance(res, BaseException):
                logger.warning("volume %s reset failed at teardown: %r", vid, res)
        self.core.teardown()
        self._bump_epoch()
