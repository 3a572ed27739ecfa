"""Controller actor: the store's metadata plane.

Port of the core endpoints of ``torchstore_tpu/controller.py`` (``init``,
``locate_volumes``, ``contains``, ``notify_put_batch``,
``notify_delete_batch``, ``keys``, ``wait_for_committed``,
``wait_for_change``, ``placement_epoch``, ``bump_placement_epoch``,
``stats``, ``teardown``, plus the volume map clients load), with commit
tracking for sharded keys. The relay, tiering, control, autoscale and
mirror engines of the reference are not part of this port yet. The
controller never sees tensor bytes: only ``Request.meta_only()`` copies.
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
    async def contains(self, key: str) -> str:
        """'missing', 'partial' or 'committed'."""
        return self.core.contains(key)

    @endpoint
    async def notify_put_batch(
        self,
        metas: list[Request],
        volume_id: "str | list[str]",
        detach_volume_ids: Optional[list[str]] = None,
        write_gens: Optional[dict[str, dict[str, int]]] = None,
    ) -> int:
        """Index ``metas`` as stored on ``volume_id`` (one id or a list),
        with each volume's write generations, and detach them from
        ``detach_volume_ids`` (replicas whose landing failed); returns the
        placement epoch."""
        volume_ids = [volume_id] if isinstance(volume_id, str) else list(volume_id)
        if self.core.apply_put_batch(metas, volume_ids, detach_volume_ids, write_gens):
            self._bump_epoch()
        await self.core.bump({m.key for m in metas})
        return self._placement_epoch

    @endpoint
    async def notify_delete_batch(self, keys: list[str]) -> dict[str, list[str]]:
        """Remove keys from the index first (notify-before-delete) and
        return which volumes held each key."""
        by_volume = self.core.delete_keys(keys)
        if by_volume:
            self._bump_epoch()
            await self.core.bump(keys)
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
    async def wait_for_committed(self, keys: list[str], timeout: Optional[float] = None) -> None:
        """Block until every key exists and is committed (a sharded key:
        every mesh coordinate landed); ``TimeoutError`` on expiry. Woken by
        the notify that commits the key, in place of a polling get."""
        await self.core.wait_for_committed(keys, timeout)

    @endpoint
    async def wait_for_change(
        self, key: str, last_gen: int = 0, timeout: Optional[float] = None
    ) -> dict[str, Any]:
        """Block until ``key``'s update generation (bumped by every indexed
        put or delete of it) differs from ``last_gen``; returns ``{"gen",
        "state"}`` with state missing, partial or committed."""
        return await self.core.wait_for_change(key, last_gen, timeout)

    @endpoint
    async def stats(self, include_volumes: bool = False) -> dict:
        """The index summary (op counters, keys, indexed bytes) and the
        volume count; with ``include_volumes`` each volume's ``stats`` too
        (an ``error`` string for one that does not answer)."""
        out = {**self.core.summary(), "num_volumes": len(self.volume_refs)}
        if include_volumes:

            async def one(vid: str, ref: ActorRef):
                try:
                    return vid, await asyncio.wait_for(ref.stats.call_one(), timeout=10.0)
                except Exception as exc:  # noqa: BLE001 - reported inline
                    return vid, {"error": f"{type(exc).__name__}: {exc}"}

            results = await asyncio.gather(*(one(v, r) for v, r in self.volume_refs.items()))
            out["volumes"] = dict(results)
        return out

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
        keys = list(self.core.index)
        self.core.teardown()
        self._bump_epoch()
        await self.core.bump(keys)
