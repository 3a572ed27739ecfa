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
DTensor target's local tensor is filled in place.

A put lands on every volume the strategy names (``replication``) and one
notify indexes them all, detaching a replica whose landing failed. Located
keys are cached (bounded) until the placement epoch moves: a get that
finds any of its keys cached reads the epoch first (one RPC; a caller that
has just read it, as a plan-cached ``get_state_dict`` has, skips it), and
a fetch that finds a location stale, or a replica's volume dead, relocates
once. ``SyncPlanCache`` holds the transfer plans of ``put_state_dict`` /
``get_state_dict``; an epoch move drops them with the cached locations.
The demotion ladder and the one-sided planes are later work.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Any, Optional

import torch

from torchstore_tpu_torch import sharding
from torchstore_tpu_torch.config import StoreConfig, default_config
from torchstore_tpu_torch.logging import Counter, get_logger
from torchstore_tpu_torch.metadata.index_core import ObjectType, StorageInfo
from torchstore_tpu_torch.runtime import ActorDiedError, ActorRef
from torchstore_tpu_torch.strategy import StorageVolumeRef
from torchstore_tpu_torch.transport.buffers import TransportContext
from torchstore_tpu_torch.transport.factory import create_transport_buffer
from torchstore_tpu_torch.transport.shared_memory import ShmClientCache
from torchstore_tpu_torch.transport.types import OpaqueBlob, Request, TensorSlice
from torchstore_tpu_torch.utils import (
    Box,
    assemble_tensor,
    get_destination_view,
    intersect_boxes,
)

logger = get_logger("torchstore_tpu_torch.client")

_PLAN_HITS = Counter(
    "ts_plan_cache_hits_total",
    "put/get_state_dict iterations served by a cached transfer plan, by op",
)
_PLAN_MISSES = Counter(
    "ts_plan_cache_misses_total",
    "put/get_state_dict iterations that (re)built their transfer plan, by op",
)
_PLAN_INVALIDATIONS = Counter(
    "ts_plan_cache_invalidations_total",
    "Cached transfer plans dropped, by reason (epoch/capacity)",
)


class SyncPlanCache:
    """Iteration-stable transfer plans for ``put_state_dict`` /
    ``get_state_dict``. An RL loop syncs the same signature every step;
    a plan keyed by (op, state-dict key, signature) and stamped with the
    controller's placement epoch lets a warm step skip the commit marker,
    the structure checks and the locate: one epoch read validates it. The
    epoch moves only on structural changes (new, changed or deleted keys,
    detached replicas), never on a same-layout overwrite; a move drops
    every plan (and the client drops its cached locations with them)."""

    MAX_ENTRIES = 64

    def __init__(self) -> None:
        self.entries: dict[tuple, dict] = {}
        self.epoch: Optional[int] = None  # last adopted placement epoch
        # key -> signature of this client's last put_state_dict of it: a
        # changed signature is a restructure the index cannot always see
        # (a republish that drops keys deletes nothing), so the publisher
        # bumps the epoch itself.
        self.last_put_sig: dict[str, tuple] = {}

    def observe_epoch(self, epoch: Optional[int]) -> bool:
        """Adopt a placement epoch; True when it moved (plans dropped)."""
        if epoch is None or epoch == self.epoch:
            return False
        moved = self.epoch is not None
        self.epoch = epoch
        if moved and self.entries:
            _PLAN_INVALIDATIONS.inc(len(self.entries), reason="epoch")
            self.entries.clear()
        return moved

    def lookup(self, op: str, key: str, signature: tuple) -> Optional[dict]:
        entry = self.entries.get((op, key, signature))
        if entry is not None and entry.get("epoch") == self.epoch:
            _PLAN_HITS.inc(op=op)
            return entry
        _PLAN_MISSES.inc(op=op)
        return None

    def peek(self, op: str, key: str, signature: tuple) -> Optional[dict]:
        """``lookup`` without counting: whether an epoch read is worth it."""
        return self.entries.get((op, key, signature))

    def store(
        self, op: str, key: str, signature: tuple, plan: dict, epoch: Optional[int] = None
    ) -> None:
        """``epoch``: the epoch the plan was built under, read before the
        data it describes was fetched (a later one would let a structural
        change in between validate the plan forever)."""
        if len(self.entries) >= self.MAX_ENTRIES:
            _PLAN_INVALIDATIONS.inc(len(self.entries), reason="capacity")
            self.entries.clear()
        plan["epoch"] = self.epoch if epoch is None else epoch
        self.entries[(op, key, signature)] = plan


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
    # Bound on the location cache; overflow clears it (a warm working set
    # refills in one locate).
    LOC_CACHE_MAX = 65536

    def __init__(self, controller: ActorRef, config: Optional[StoreConfig] = None) -> None:
        self._controller = controller
        self._config = config or default_config()
        self._strategy = None
        self._volume_refs: Optional[dict[str, StorageVolumeRef]] = None
        self._ctx = TransportContext()
        self._loc_cache: dict[str, dict[str, StorageInfo]] = {}
        self._seen_epoch: Optional[int] = None
        self.plan_cache: Optional[SyncPlanCache] = (
            SyncPlanCache() if self._config.plan_cache else None
        )
        # Tensor parts fetched from volumes: one per whole tensor, one per
        # distinct intersection of a wanted region with a stored shard.
        self.parts_fetched = 0
        self.epoch_reads = 0  # placement-epoch RPCs this client made

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

    @property
    def controller(self) -> ActorRef:
        return self._controller

    def close(self) -> None:
        """Unpin and drop this client's segment attachments."""
        self._ctx.clear()

    def shm_stats(self) -> dict:
        """The client half of the segment pool's economics: handshake
        offers taken, segments created cold, attachments page-locked (in
        the background) and the seconds that took, and the seconds puts and
        gets waited for a registration in progress."""
        cache = self._ctx.get_cache(ShmClientCache)
        return {**cache.counts, "pin_seconds": cache.pin_seconds,
                "pin_wait_seconds": cache.pin_wait_seconds,
                "pin_pending": cache.pin_pending()}

    async def wait_pinned(self) -> float:
        """Wait until the attachments queued for page-locking are locked
        (e.g. at a step boundary, so the next sync copies pinned pages);
        returns the seconds waited."""
        return await self._ctx.get_cache(ShmClientCache).wait_pinned()

    def _observe_epoch(self, epoch: int) -> None:
        """Adopt the controller's placement epoch; a move drops the cached
        plans and locations together: both describe the placement that
        changed."""
        if self.plan_cache is not None:
            moved = self.plan_cache.observe_epoch(epoch)
        else:
            moved = self._seen_epoch is not None and epoch != self._seen_epoch
        self._seen_epoch = epoch
        if moved:
            self._loc_cache.clear()

    async def placement_epoch(self) -> int:
        """Read and adopt the controller's placement epoch: the one RPC
        that validates a cached plan."""
        await self._ensure_setup()
        self.epoch_reads += 1
        epoch = await self._controller.placement_epoch.call_one()
        self._observe_epoch(epoch)
        return epoch

    async def bump_placement_epoch(self) -> int:
        """Invalidate every consumer's cached transfer plans."""
        epoch = await self._controller.bump_placement_epoch.call_one()
        self._observe_epoch(epoch)
        return epoch

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

    def _put_volumes(self) -> list[StorageVolumeRef]:
        """Every volume a put writes to: the primary and its replicas."""
        vids = self._strategy.select_put_volume_ids(
            self._strategy.get_client_id(), list(self._volume_refs)
        )
        return [self._volume_refs[vid] for vid in vids]

    async def put(self, key: str, value: Any) -> None:
        await self.put_batch({key: value})

    async def put_batch(
        self,
        items: dict[str, Any],
        watermark: Optional[tuple] = None,
        unchanged: Optional[dict] = None,
    ) -> None:
        """Land every item on each of the strategy's volumes at once, then
        index them all in one notify: a key is visible to readers only once
        its bytes landed (a sharded key once every coordinate has). A
        replica whose landing failed is detached from these keys in the same
        notify; the put fails only when no replica landed.

        ``watermark``: ``(stream_key, version)`` of a layer-streamed
        publish; the notify watermarks every key at ``version`` in the same
        indexing step, so a streaming reader trusts a key only once its
        bytes are committed. ``unchanged``: ``{store_key: (base_store_key,
        base_version)}`` aliases of the same publish, watermarked with it
        (see ``stream_sync``)."""
        await self._ensure_setup()
        requests = [r for k, v in items.items() for r in self._value_to_requests(k, v)]
        volumes = self._put_volumes()
        results = await asyncio.gather(
            *(self._land(volume, requests) for volume in volumes), return_exceptions=True
        )
        landed = [(v, r) for v, r in zip(volumes, results) if not isinstance(r, BaseException)]
        failed = [(v, r) for v, r in zip(volumes, results) if isinstance(r, BaseException)]
        if not landed:
            raise failed[0][1]
        for volume, exc in failed:
            logger.warning(
                "replicated put degraded: volume %s failed (%r); detaching its copies",
                volume.volume_id, exc,
            )
        epoch = await self._controller.notify_put_batch.call_one(
            [r.meta_only() for r in requests],
            [v.volume_id for v, _ in landed],
            detach_volume_ids=[v.volume_id for v, _ in failed] or None,
            write_gens={v.volume_id: gens for v, gens in landed},
            watermark=watermark,
            unchanged=unchanged,
        )
        self._observe_epoch(epoch)

    async def _land(self, volume: StorageVolumeRef, requests: list[Request]) -> dict[str, int]:
        """Put ``requests`` on one volume; returns its write generations."""
        buffer = create_transport_buffer(volume, self._config)
        await buffer.put_to_storage_volume(volume, requests)
        return buffer.write_gens or {}

    # ------------------------------------------------------------------
    # get
    # ------------------------------------------------------------------

    async def get(self, key: str, like: Any = None) -> Any:
        return (await self.get_batch({key: like}))[key]

    async def get_batch(self, items, _epoch_checked: bool = False) -> dict[str, Any]:
        """All-or-nothing batched get: a missing or partially committed key
        fails the batch before data moves. ``items`` is a list of keys or
        {key: target or None}. A tensor target is filled in place and
        returned; a ``Shard`` target fills its data (returned) with its
        region, or returns a fresh tensor of it when the data is None; a
        ``TensorSlice`` returns a fresh tensor of its region; a DTensor's
        local tensor is filled with its shard and the DTensor returned.
        ``_epoch_checked``: the caller read the placement epoch just now
        (``placement_epoch``), so cached locations are valid as they are."""
        if isinstance(items, str):
            raise TypeError("get_batch takes a list of keys or a {key: target} dict")
        if not isinstance(items, dict):
            items = {key: None for key in items}
        wants = [self._want(key, like) for key, like in items.items()]
        await self._ensure_setup()
        keys = list(items)
        if not _epoch_checked and (
            self._seen_epoch is None or any(key in self._loc_cache for key in keys)
        ):
            # Cached locations hold while the placement epoch does: another
            # client's put may have detached a replica or added one since.
            self.epoch_reads += 1
            self._observe_epoch(await self._controller.placement_epoch.call_one())
        cached = [key for key in keys if key in self._loc_cache]
        located = await self._locate(keys)
        dead: set[str] = set()
        try:
            return await self._fetch(wants, located, dead)
        except ActorDiedError:
            # A replica's volume died: relocate and read the others.
            for key in keys:
                self._loc_cache.pop(key, None)
            located = await self._locate(keys)
            live = {
                key: {vid: info for vid, info in infos.items() if vid not in dead}
                for key, infos in located.items()
            }
            if not all(live.values()):
                raise
            return await self._fetch(wants, live, dead)
        except (KeyError, ValueError):
            # Another client deleted or re-laid out a key between the epoch
            # check and the fetch: relocate once.
            if not cached:
                raise
            for key in cached:
                self._loc_cache.pop(key, None)
            return await self._fetch(wants, await self._locate(keys), dead)

    async def _locate(self, keys: list[str]) -> dict[str, dict[str, StorageInfo]]:
        """Where each key lives: from the cache, else one locate RPC for
        the rest (whose answers are cached)."""
        located = {key: self._loc_cache[key] for key in keys if key in self._loc_cache}
        missing = [key for key in keys if key not in located]
        if missing:
            fresh = await self._controller.locate_volumes.call_one(missing)
            if len(self._loc_cache) + len(fresh) > self.LOC_CACHE_MAX:
                self._loc_cache.clear()
            self._loc_cache.update(fresh)
            located.update(fresh)
        return located

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
        self, wants: list[_Want], located: dict[str, dict[str, StorageInfo]], dead: set[str]
    ) -> dict[str, Any]:
        """Fetch every want from the volumes ``located`` names; the id of a
        volume found dead is added to ``dead``."""
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
            except ActorDiedError:
                dead.add(vid)
                raise
            except ConnectionError as exc:
                dead.add(vid)
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
        for key in keys:
            self._ctx.delete_key(key)
            self._loc_cache.pop(key, None)

    async def delete_prefix(self, prefix: str) -> int:
        """Delete every key under ``prefix`` (by whole path segments, e.g. an
        old version's "policy/v41"); returns how many. Idempotent."""
        keys = await self._controller.keys.call_one(prefix)
        if keys:
            await self.delete_batch(keys)
        return len(keys)

    async def keys(self, prefix: Optional[str] = None) -> list[str]:
        return await self._controller.keys.call_one(prefix)

    async def exists(self, key: str) -> bool:
        """True once any part of ``key`` is indexed (also when partial)."""
        return await self._controller.contains.call_one(key) != "missing"

    # ------------------------------------------------------------------
    # blocking waits
    # ------------------------------------------------------------------

    @staticmethod
    def _wait_rpc_timeout(timeout: Optional[float]) -> float:
        # The RPC outlives the controller's wait, so its TimeoutError (which
        # names the keys) arrives first; 0 disables the RPC deadline.
        return 0 if timeout is None else timeout + 10.0

    async def wait_for(self, keys, timeout: Optional[float] = None) -> None:
        """Block until every key (a str or a list) exists and is committed;
        ``TimeoutError`` on expiry. In place of polling a get."""
        if isinstance(keys, str):
            keys = [keys]
        await self._ensure_setup()
        await self._controller.wait_for_committed.with_timeout(
            self._wait_rpc_timeout(timeout)
        ).call_one(list(keys), timeout)

    async def wait_for_change(
        self, key: str, last_gen: int = 0, timeout: Optional[float] = None
    ) -> dict:
        """Block until ``key``'s update generation differs from
        ``last_gen``; returns ``{"gen", "state"}`` (state: missing, partial
        or committed)."""
        await self._ensure_setup()
        return await self._controller.wait_for_change.with_timeout(
            self._wait_rpc_timeout(timeout)
        ).call_one(key, last_gen, timeout)

    # ------------------------------------------------------------------
    # layer-streamed sync (see stream_sync.py)
    # ------------------------------------------------------------------

    async def stream_begin(self, key: str, quant: Optional[dict] = None) -> int:
        """Open the next streamed publish of ``key``; returns its version.
        ``quant`` is the decode meta readers need before the seal."""
        await self._ensure_setup()
        return await self._controller.stream_begin.call_one(key, quant)

    async def stream_seal(self, key: str, version: int) -> None:
        await self._ensure_setup()
        await self._controller.stream_seal.call_one(key, version)

    async def stream_mark_unchanged(self, key: str, version: int, aliases: dict) -> None:
        """Watermark the keys of a streamed delta fragment that landed no
        bytes (each an alias of an earlier version's committed key)."""
        await self._ensure_setup()
        await self._controller.stream_mark_unchanged.call_one(key, version, aliases)

    async def stream_state(self, key: str) -> Optional[dict]:
        """``key``'s stream record, or None when it was never streamed.
        Read watermarks through ``stream_sync.watermark_of`` /
        ``inconsistent_keys``."""
        await self._ensure_setup()
        return await self._controller.stream_state.call_one(key)

    async def wait_for_stream(
        self,
        key: str,
        version: int,
        known: int = 0,
        timeout: Optional[float] = None,
        volume_id: Optional[str] = None,
    ) -> dict:
        """Long-poll a streamed publish's progress (``Controller.
        wait_for_stream``); the RPC outlives the controller's wait, as
        every blocking wait's does."""
        await self._ensure_setup()
        return await self._controller.wait_for_stream.with_timeout(
            self._wait_rpc_timeout(timeout)
        ).call_one(key, version, known, timeout, volume_id)

    async def stream_ack(self, key: str, version: int, subscriber: str) -> None:
        """This subscriber's acquire completion on the stream's timeline
        (telemetry)."""
        await self._ensure_setup()
        await self._controller.stream_ack.call_one(key, version, subscriber)
