"""Storage volume actor: an in-memory key -> tensor/object store.

Port of the ``handshake``/``put``/``get``/``get_meta``/``delete_batch``/
``write_gens``/``stats`` endpoints of ``torchstore_tpu/storage_volume.py``
over an in-memory dict. A key holds a whole tensor, an object, or the
shards of a sharded tensor (one per mesh coordinate, ``ShardedEntry``). A
get may ask for a sub-box of a whole tensor or of one stored shard; the
transport then returns only that box. Every put gives its keys a new write
generation. ``inject_fault`` / ``clear_faults`` arm and disarm fault
points inside the volume's process (``faults.py``), and ``stats()`` carries
the process's metrics registry. The volume serves the bulk TCP rung
through its ``BulkServerCache`` (a listener of its own, started at the
first bulk handshake) and builds the native host copies at start.

Durable volumes: with a storage directory (``initialize(storage_dir=)``,
``TORCHSTORE_TORCH_STORAGE_DIR``) every landed put is also persisted,
crash-safe, under ``<dir>/<volume_id>`` (``storage_utils/file_store.py``);
the memory entry stays the served one. A volume started over the
directory serves what it holds from the files, and ``manifest`` lets the
controller rebuild its index (``rebuild_index``).

The spill tier (``tiering/spill.py``, ``TORCHSTORE_TORCH_TIER_ENABLED``):
``tier_sweep`` demotes cold version groups to disk while resident bytes are
above the high watermark; a get of a spilled key faults it back in before
anything is served, into pooled segments as a put lands. A demotion drops
the memory copy as a same-layout re-put does: a segment leased to a reader
retires (readers attach after the serve), never unlinked under it.
Resident bytes count each entry's tensor bytes once, in a segment or a
plain tensor; pooled spares are not entries.

Replication and repair: ``delete_batch_if`` is the controller's
conditional reclaim of a detached copy (deleted only while its write
generation is not newer than the stale one), ``write_gens`` the first phase
of a reclaim whose generation the controller never learned, and
``pull_from`` a copy from another volume with no client involved (the data
plane of auto-repair): over the bulk rung when it is on, else RPC frames,
landed in pooled segments. ``TORCHSTORE_TORCH_VOLUME_ID`` forces the id (a
repair's replacement takes the dead volume's). ``flight_record`` hands the
controller this process's recorder ring for a quarantine's post-mortem.
``shm_capacity`` and ``provision_shm`` serve prewarm's
shared-memory leg: the capacity view the controller grants against, and
the pool pre-sized with prefaulted segments before the first put. The
one-sided planes (A10), relay hops (A11.1) and the traffic ledger's peer
cells (A12) are later work.
"""

from __future__ import annotations

import asyncio
import os
import time
from typing import Any, Optional

import torch

from torchstore_tpu_torch import faults, native
from torchstore_tpu_torch.config import ENV_STORAGE_DIR, ENV_VOLUME_ID, default_config
from torchstore_tpu_torch.logging import get_logger
from torchstore_tpu_torch.observability import metrics as obs_metrics
from torchstore_tpu_torch.observability import recorder as obs_recorder
from torchstore_tpu_torch.observability.tracing import span
from torchstore_tpu_torch.runtime import Actor, endpoint
from torchstore_tpu_torch.transport import bulk, landing, shared_memory
from torchstore_tpu_torch.transport.buffers import Served, TransportBuffer, TransportContext
from torchstore_tpu_torch.transport.types import Request, TensorMeta, TensorSlice
from torchstore_tpu_torch.utils import Box, get_hostname, maybe_await

logger = get_logger("torchstore_tpu_torch.storage_volume")

_RESIDENT_BYTES = obs_metrics.gauge(
    "ts_volume_resident_bytes", "Tensor bytes resident in this volume"
)
_ENTRIES = obs_metrics.gauge("ts_volume_entries", "Entries (keys) resident in this volume")
_PUT_OPS = obs_metrics.counter("ts_volume_put_ops_total", "Put RPCs served by this volume")
_GET_OPS = obs_metrics.counter("ts_volume_get_ops_total", "Get RPCs served by this volume")


class ShardedEntry(dict):
    """The shards of one sharded key on this volume:
    coordinates -> (TensorSlice, tensor)."""


class StorageVolume(Actor):
    def __init__(self, strategy, storage_dir: Optional[str] = None) -> None:
        # A repair's replacement adopts the dead volume's id.
        self.volume_id = os.environ.get(ENV_VOLUME_ID) or str(strategy.get_volume_id())
        self.store: dict[str, Any] = {}
        self.ctx = TransportContext()
        self._write_gens: dict[str, int] = {}
        if shared_memory.is_available():
            # Crashed processes leave segments behind; sweep before serving.
            shared_memory.reap_orphaned_segments()
        native.get_lib()  # built or loaded now, not under the first transfer
        # Durable copy of every landed entry (None: memory only). What the
        # directory holds already is served from its files.
        storage_dir = storage_dir or os.environ.get(ENV_STORAGE_DIR)
        self._durable = None
        if storage_dir:
            from torchstore_tpu_torch.storage_utils.file_store import FileBackedStore

            self._durable = FileBackedStore(os.path.join(storage_dir, self.volume_id))
            self.store.update(self._durable.kv)
        # Kept per affected key at every change, never by a walk of the store.
        self._resident_bytes = sum(entry_nbytes(e) for e in self.store.values())
        # The spill tier (None: off; the warm get then checks one attribute).
        from torchstore_tpu_torch.tiering import spill as tiering_spill

        self._tier = tiering_spill.SpillTier(self.volume_id) if tiering_spill.enabled() else None
        # Serializes spills, fault-ins and every disk write or delete (cold
        # paths; a warm get never takes it).
        self._tier_lock = asyncio.Lock()
        self._publish_residency()
        # An unclean exit (faults or errors recorded) leaves its last events.
        obs_recorder.recorder().arm_exit_dump()

    def _publish_residency(self) -> None:
        _RESIDENT_BYTES.set(self._resident_bytes, volume=self.volume_id)
        _ENTRIES.set(len(self.store), volume=self.volume_id)
        if self._tier is not None:
            self._tier.publish_gauges(self._resident_bytes)

    def _key_bytes(self, keys) -> int:
        return sum(entry_nbytes(self.store.get(k)) for k in keys)

    @endpoint
    async def get_id(self) -> dict:
        return {"volume_id": self.volume_id, "hostname": get_hostname(), "pid": os.getpid()}

    def _existing(self, metas: list[Request]) -> dict[int, Any]:
        return {idx: self.store[m.key] for idx, m in enumerate(metas) if m.key in self.store}

    @endpoint
    async def handshake(self, buffer: TransportBuffer, metas: list[Request], op: str) -> Any:
        await faults.afire("volume.handshake")
        existing = self._existing(metas) if op == "put" else {}
        return await maybe_await(buffer.recv_handshake(self.ctx, metas, existing, op))

    @endpoint
    async def put(self, buffer: TransportBuffer, metas: list[Request]) -> dict:
        """Land ``metas``; returns ``{"reply": the transport's put reply,
        "write_gens": {key: new write generation}}``."""
        await faults.afire("volume.put")
        _PUT_OPS.inc()
        if self._tier is not None:
            # A sharded overwrite lands shard by shard: a spilled entry comes
            # back first so its other shards survive (a whole value simply
            # discards the stale disk copy below).
            await self._tier_fault_in([m for m in metas if m.tensor_slice is not None], "put")
        for meta in metas:
            self._supersede(meta)
        values = await maybe_await(buffer.handle_put_request(self.ctx, metas, self._existing(metas)))
        self._store_values(metas, values)
        gens = self._bump_write_gens(metas)
        stale = self._tier_landed({meta.key for meta in metas})
        self._publish_residency()
        obs_recorder.record("volume_op", "put", keys=len(metas))
        reply = buffer.put_reply()
        await self._persist(metas, values, stale)
        return {"reply": reply, "write_gens": gens}

    def _store_values(self, metas: list[Request], values: dict[int, Any]) -> None:
        """Make landed values the entries of their keys (a shard under its
        coordinates), and count their bytes resident."""
        keys = {meta.key for meta in metas}
        before = self._key_bytes(keys)
        for idx, meta in enumerate(metas):
            ts = meta.tensor_slice
            if ts is None:
                self.store[meta.key] = values[idx]
            else:
                self.store.setdefault(meta.key, ShardedEntry())[ts.coordinates] = (ts, values[idx])
        self._resident_bytes += self._key_bytes(keys) - before

    def _tier_landed(self, keys: set) -> list[str]:
        """Fresh bytes of ``keys`` are resident: a disk copy is stale from
        now on. Returns the keys whose spilled files ``_persist`` deletes."""
        if self._tier is None:
            return []
        stale = [key for key in keys if self._tier.discard(key)]
        self._tier.touch(keys)
        return stale

    # ---- disk writes, off the event loop -----------------------------------
    #
    # Every write or delete of the durable directory and the spill tier's
    # files runs on the landing pool's threads, so the loop goes on
    # answering pings (an fsync of a large tensor takes seconds). Each runs
    # under the tier lock, entered with no await after the memory change it
    # mirrors: the lock wakes its waiters in arrival order, so the files
    # change in the order the entries did, and ``manifest`` (under the
    # lock too) never reads a store a thread is writing.

    def _lease_segments(self, keys) -> list[str]:
        """Read leases on the segments behind ``keys``' entries, held while
        a pool thread copies them to disk: a re-put meanwhile retires them
        instead of pooling them for its landing."""
        cache = self.ctx.peek(shared_memory.ShmServerCache)
        names: list[str] = []
        if cache is not None:
            for key in keys:
                for entry in cache.by_key.get(key, {}).values():
                    cache.grant(entry.seg.name)
                    names.append(entry.seg.name)
        return names

    def _release_segments(self, names: list[str]) -> None:
        cache = self.ctx.peek(shared_memory.ShmServerCache)
        if cache is not None:
            for name in names:
                cache.release(name)

    async def _persist(self, metas: list[Request], values: dict[int, Any],
                       stale_spilled: list[str] = ()) -> None:
        """The disk half of a landing: delete the spilled files it made
        stale, and write the durable copy of ``metas``."""
        durable = self._durable is not None and bool(metas)
        if not durable and not stale_spilled:
            return
        names = self._lease_segments({meta.key for meta in metas}) if durable else []
        try:
            async with self._tier_lock:
                await landing.run_in_pool(self._write_files, metas if durable else [], values,
                                          list(stale_spilled))
        finally:
            self._release_segments(names)

    def _write_files(self, metas: list[Request], values: dict[int, Any],
                     stale_spilled: list[str]) -> None:
        for key in stale_spilled:
            self._tier.disk.delete(key)
        if metas:
            self._durable.store(metas, values)

    async def _drop_files(self, keys: list[str], spilled: list[str]) -> None:
        """The disk half of a delete: the durable copies of ``keys`` and the
        spilled files of ``spilled``."""
        durable = keys if self._durable is not None else []
        if not durable and not spilled:
            return
        async with self._tier_lock:
            await landing.run_in_pool(self._delete_files, durable, spilled)

    def _delete_files(self, keys: list[str], spilled: list[str]) -> None:
        for key in keys:
            self._durable.delete(key)
        for key in spilled:
            self._tier.disk.delete(key)

    def _bump_write_gens(self, metas: list[Request]) -> dict[str, int]:
        """A new generation per key: above the last, and a timestamp in
        microseconds, so a restarted volume's generations keep rising."""
        now = int(time.time() * 1e6)
        gens: dict[str, int] = {}
        for meta in metas:
            gen = max(self._write_gens.get(meta.key, 0) + 1, now)
            self._write_gens[meta.key] = gens[meta.key] = gen
        return gens

    @endpoint
    async def write_gens(self, keys: list[str]) -> dict[str, int]:
        """The current write generation of each of ``keys`` this volume
        wrote (others omitted)."""
        return {key: self._write_gens[key] for key in keys if key in self._write_gens}

    def _supersede(self, meta: Request) -> None:
        """Drop what ``meta`` replaces as a whole before it lands: a sharded
        entry of another layout (mesh or global shape) or kind. Shards of the
        same layout replace each other coordinate by coordinate, a whole
        value the whole value."""
        entry = self.store.get(meta.key)
        if entry is None:
            return
        ts = meta.tensor_slice
        if isinstance(entry, ShardedEntry):
            if ts is not None and all(
                s.mesh_shape == ts.mesh_shape and s.global_shape == ts.global_shape
                for s, _ in entry.values()
            ):
                return
        elif ts is None:
            return
        self._resident_bytes -= entry_nbytes(self.store.pop(meta.key))
        self.ctx.delete_key(meta.key)

    @endpoint
    async def get(self, buffer: TransportBuffer, metas: list[Request]) -> TransportBuffer:
        await faults.afire("volume.get")
        _GET_OPS.inc()
        if self._tier is not None:
            # Spilled keys come back here, inside the ordinary get: a cached
            # plan that skipped the locate reaches them too. No await from
            # the fault-in's last check to the serve below, so no sweep
            # drops an entry in between.
            await self._tier_fault_in(metas, "get")
            self._tier.touch(meta.key for meta in metas)
        entries = [self._serve(meta) for meta in metas]
        await maybe_await(buffer.handle_get_request(self.ctx, metas, entries))
        return buffer

    def _serve(self, meta: Request, spilled_ok: bool = False) -> Any:
        """The object, or the ``Served`` part of a stored tensor, that
        ``meta`` asks for (``spilled_ok``: or of its disk copy)."""
        entry = self._entry(meta.key, spilled_ok)
        if meta.is_object:
            return entry
        ts = meta.tensor_slice
        if isinstance(entry, ShardedEntry):
            if ts is None:
                if len(entry) == 1:
                    ((coords, (stored, tensor)),) = entry.items()
                    if stored.is_full():
                        return Served(tensor, (meta.key, coords))
                raise ValueError(
                    f"key {meta.key!r} is sharded across coordinates {sorted(entry)}; "
                    "a slice request is required"
                )
            found = entry.get(ts.coordinates)
            if found is None:
                raise KeyError(f"no shard at coordinates {ts.coordinates} of key {meta.key!r}")
            stored, tensor = found
            if (stored.mesh_shape, stored.global_shape) != (ts.mesh_shape, ts.global_shape):
                raise ValueError(
                    f"key {meta.key!r} is stored under mesh {stored.mesh_shape} and global "
                    f"shape {stored.global_shape}, not {ts.mesh_shape} / {ts.global_shape}"
                )
            return Served(tensor, (meta.key, ts.coordinates), _sub_index(stored, ts, meta.key))
        if ts is None:
            return Served(entry, (meta.key, None))
        if ts.global_shape != tuple(entry.shape):
            raise ValueError(
                f"key {meta.key!r} holds shape {tuple(entry.shape)}, not {ts.global_shape}"
            )
        whole = TensorSlice((0,) * entry.ndim, tuple(entry.shape), tuple(entry.shape), (), ())
        return Served(entry, (meta.key, None), _sub_index(whole, ts, meta.key))

    @endpoint
    async def get_meta(self, metas: list[Request]) -> list[Optional[TensorMeta]]:
        """Shape and dtype of each stored tensor or requested part (None for
        objects); a spilled entry answers from its disk copy, in place."""
        return [None if meta.is_object else TensorMeta.of(self._serve(meta, True).part())
                for meta in metas]

    @endpoint
    async def delete_batch(self, keys: list[str]) -> int:
        """Idempotent: missing keys are ignored so cleanup retries are safe.
        A key's disk copies (spilled, durable) go with it."""
        deleted = 0
        spilled_keys: list[str] = []
        for key in keys:
            entry = self.store.pop(key, None)
            spilled = self._tier is not None and self._tier.discard(key)
            if spilled:
                spilled_keys.append(key)
            if entry is not None or spilled:
                deleted += 1
            self._resident_bytes -= entry_nbytes(entry)
            self._write_gens.pop(key, None)
            self.ctx.delete_key(key)
        self._publish_residency()
        await self._drop_files(list(keys), spilled_keys)
        return deleted

    @endpoint
    async def delete_batch_if(self, items: list[tuple[str, int]]) -> dict[str, Any]:
        """The controller's reclaim of detached copies: each ``(key,
        stale_gen)`` is deleted only while the key's write generation is not
        newer than ``stale_gen`` (a put that landed after the detach keeps
        its bytes: ``kept_fresh``, with its generation in ``kept_gens`` so
        the controller can check again). No await between the check and the
        delete, so no put slips in between. A key with no recorded
        generation is deleted: its bytes predate this process's puts. A
        segment a reader holds a lease on retires under it. Returns
        ``{"removed", "kept_fresh", "kept_gens"}``."""
        removed: list[str] = []
        kept_fresh: list[str] = []
        kept_gens: dict[str, int] = {}
        dropped: list[str] = []
        spilled_keys: list[str] = []
        cache = self.ctx.peek(shared_memory.ShmServerCache)
        for key, stale_gen in items:
            current = self._write_gens.get(key)
            if current is not None and current > stale_gen:
                kept_fresh.append(key)
                kept_gens[key] = current
                continue
            entry = self.store.pop(key, None)
            spilled = self._tier is not None and self._tier.discard(key)
            if spilled:
                spilled_keys.append(key)
            if entry is not None or spilled:
                removed.append(key)
            self._resident_bytes -= entry_nbytes(entry)
            dropped.append(key)
            self._write_gens.pop(key, None)
            if cache is not None:
                cache.retire_key(key)
            self.ctx.delete_key(key)
        self._publish_residency()
        await self._drop_files(dropped, spilled_keys)
        return {"removed": removed, "kept_fresh": kept_fresh, "kept_gens": kept_gens}

    @endpoint
    async def pull_from(self, src, metas: list[Request], src_hostname: str = "",
                        src_volume: str = "", relay: bool = False) -> dict[str, Any]:
        """Copy ``metas`` from the volume at ActorRef ``src`` into this one,
        with no client involved (auto-repair's data plane). Over the bulk
        rung when it is on (striped above its threshold), else RPC frames;
        never shared memory (this process serves that rung). Tensors land in
        segments of this volume's pool (new ones, made on the landing pool's
        threads, when none fits), received into them in place, and become
        entries as a put's would: a segment a reader leases retires under
        the lease. A key a put wrote here while the read was in flight
        (its write generation moved) keeps the put's bytes: the pulled copy
        is dropped and the key listed in ``moved``. Returns
        ``{"write_gens": fresh generations of the keys stored, "moved",
        "rung", "bytes", "seconds", "alloc_s"}`` (``alloc_s``: the part
        spent taking and making segments, before any byte moved).
        ``relay=True`` (a broadcast relay hop) is ROADMAP A11.1 and
        raises."""
        if relay:
            raise NotImplementedError(
                "pull_from(relay=True) is a broadcast relay hop: the relay is not ported "
                "yet (ROADMAP A11.1)"
            )
        from torchstore_tpu_torch.strategy import StorageVolumeRef
        from torchstore_tpu_torch.transport.factory import (
            TransportType,
            bulk_available,
            create_transport_buffer,
        )

        t0 = time.perf_counter()
        if self._tier is not None:
            # As in put: a sharded pull lands shard by shard, so a spilled
            # entry comes back first and keeps its other shards.
            await self._tier_fault_in([m for m in metas if m.tensor_slice is not None], "pull")
        config = default_config()
        src_ref = StorageVolumeRef(actor=src, volume_id=src_volume, transport_context=self.ctx,
                                   hostname=src_hostname)
        rung = TransportType.BULK if bulk_available(src_ref, config) else TransportType.RPC
        requests = [meta.meta_only() for meta in metas]
        cache = (self.ctx.get_cache(shared_memory.ShmServerCache)
                 if shared_memory.is_available() else None)
        segs: dict[int, tuple] = {}
        cold: list[tuple[int, TensorMeta]] = []
        for idx, req in enumerate(requests):
            if req.is_object or req.tensor_meta is None:
                continue
            shape = (req.tensor_slice.local_shape if req.tensor_slice is not None
                     else req.tensor_meta.shape)
            tmeta = TensorMeta(shape=tuple(shape), dtype=req.tensor_meta.dtype)
            dest = Request(key=req.key, tensor_slice=req.tensor_slice, tensor_meta=tmeta)
            requests[idx] = dest
            if cache is None or not tmeta.nbytes:
                dest.destination_view = torch.empty(tmeta.shape, dtype=tmeta.torch_dtype)
                continue
            seg = cache.take_free(tmeta.nbytes)
            if seg is None:
                cold.append((idx, tmeta))
                continue
            cache.note_reuse(seg)
            segs[idx] = (seg, tmeta)
        made = await asyncio.gather(*(landing.run_in_pool(shared_memory.ShmSegment.create,
                                                          tmeta.nbytes, config=config)
                                      for _, tmeta in cold))
        for (idx, tmeta), seg in zip(cold, made):
            cache.counts["created"] += 1
            segs[idx] = (seg, tmeta)
        for idx, (seg, tmeta) in segs.items():
            requests[idx].destination_view = seg.view(tmeta)
        alloc_s = time.perf_counter() - t0
        # A put that lands here while the read is in flight moves its key's
        # write generation: its bytes are newer than the source's, and stay.
        gens_before = {meta.key: self._write_gens.get(meta.key) for meta in metas}
        buffer = create_transport_buffer(src_ref, config, force=rung)
        try:
            results = await buffer.get_from_storage_volume(src_ref, requests)
        except BaseException:
            for seg, _ in segs.values():
                seg.unlink()
            raise
        # No await from this check to the store below.
        moved = sorted({key for key, gen in gens_before.items()
                        if self._write_gens.get(key) != gen})
        keep = [idx for idx, meta in enumerate(metas) if meta.key not in moved]
        for idx in set(segs) - set(keep):
            segs.pop(idx)[0].unlink()
        metas = [metas[idx] for idx in keep]
        values = {new: results[idx] for new, idx in enumerate(keep)}
        for meta in metas:
            self._supersede(meta)
        for new, idx in enumerate(keep):
            if idx in segs:
                seg, tmeta = segs[idx]
                meta = metas[new]
                coords = meta.tensor_slice.coordinates if meta.tensor_slice is not None else None
                cache.put(meta.key, coords, seg, tmeta, 0, values[new])
        self._store_values(metas, values)
        gens = self._bump_write_gens(metas)
        keys = {meta.key for meta in metas}
        stale = self._tier_landed(keys)
        self._publish_residency()
        nbytes = sum(t.numel() * t.element_size() for t in values.values()
                     if isinstance(t, torch.Tensor))
        obs_recorder.record("volume_op", "pull_from", keys=len(keys), nbytes=nbytes,
                            src=src_volume, rung=rung.value, moved=len(moved))
        await self._persist(metas, values, stale)
        return {"write_gens": gens, "moved": moved, "rung": rung.value,
                "bytes": nbytes, "seconds": time.perf_counter() - t0, "alloc_s": alloc_s}

    @endpoint
    async def flight_record(self) -> list:
        """This process's flight-recorder ring, oldest first (the controller
        merges it into a quarantine's post-mortem)."""
        return obs_recorder.snapshot()

    # ---- the spill tier ------------------------------------------------------

    async def _tier_fault_in(self, metas: list[Request], reason: str) -> None:
        """Land every spilled key of ``metas`` back in memory before it is
        served. Returns only once none is spilled, with no await after that
        check. The warm path: one dict read."""
        tier = self._tier
        while True:
            keys = list(dict.fromkeys(m.key for m in metas if m.key in tier.spilled))
            if not keys:
                return
            async with self._tier_lock:
                for key in keys:
                    if key not in tier.spilled:
                        continue  # a concurrent fault-in promoted it
                    await faults.afire("volume.fault_in")
                    try:
                        dmetas, dvalues = tier.load(key)
                    except KeyError:
                        continue
                    t0 = time.perf_counter()
                    if await self._promote_entry(key, dmetas, dvalues):
                        tier.faulted_in(key, reason, time.perf_counter() - t0)
            self._publish_residency()

    async def _promote_entry(self, key: str, dmetas: list[Request],
                             dvalues: dict[int, Any]) -> bool:
        """Land a spilled entry in memory: each tensor into a segment of the
        pool (a new one when none fits), copied from its file on the landing
        pool's threads, then registered and stored as a put's would be.
        False when a put of the key landed during the copy (its disk copy
        discarded): the fresh bytes stay and the copy is dropped."""
        cache = (self.ctx.get_cache(shared_memory.ShmServerCache)
                 if shared_memory.is_available() else None)
        values: dict[int, Any] = {}
        pairs: list[tuple] = []
        segs: list[tuple] = []
        for idx, dmeta in enumerate(dmetas):
            src = dvalues[idx]
            if dmeta.is_object:
                values[idx] = src
                continue
            tmeta = TensorMeta.of(src)
            if cache is not None and src.numel():
                size = tmeta.nbytes
                seg = cache.take_free(size)
                if seg is not None:
                    cache.note_reuse(seg)
                else:
                    seg = shared_memory.ShmSegment.create(size)
                    cache.counts["created"] += 1
                dst = seg.view(tmeta)
                segs.append((dmeta, seg, tmeta, dst))
            else:
                dst = torch.empty(tmeta.shape, dtype=src.dtype)
            pairs.append((dst, src))
            values[idx] = dst
        await landing.land_async(pairs)
        if key not in self._tier.spilled:
            for _, seg, _, _ in segs:
                seg.unlink()
            return False
        for dmeta, seg, tmeta, dst in segs:
            coords = dmeta.tensor_slice.coordinates if dmeta.tensor_slice is not None else None
            cache.put(key, coords, seg, tmeta, 0, dst)
        self._store_values(dmetas, values)
        return True

    async def _tier_demote_key(self, key: str) -> bool:
        """Demote one resident key to disk (the caller holds the tier lock),
        its files written on a landing-pool thread; True when its memory
        copy went. A failed spill leaves the entry resident and served."""
        try:
            # Inside the failure domain: a raise aborts this key's demotion.
            await faults.afire("volume.spill")
            entry = self.store.get(key)
            if entry is None:
                return False
            names = self._lease_segments([key])
            t0 = time.perf_counter()
            try:
                nbytes = await landing.run_in_pool(self._tier.write, key, entry)
            finally:
                self._release_segments(names)
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 - a failed spill keeps the entry served
            logger.exception("spill of %r failed; the entry stays resident", key)
            return False
        if self.store.get(key) is not entry:
            # A put or a delete replaced the entry during the write: the
            # disk copy is stale, and the resident bytes stay served.
            await landing.run_in_pool(self._tier.disk.delete, key)
            return False
        self._tier.spilled_in(key, nbytes, time.perf_counter() - t0)
        self._resident_bytes -= entry_nbytes(self.store.pop(key))
        cache = self.ctx.peek(shared_memory.ShmServerCache)
        if cache is not None:
            cache.retire_key(key)
        return True

    @endpoint
    async def tier_sweep(self, pins: Optional[list[str]] = None) -> dict:
        """One spill pass: while resident bytes exceed the high watermark,
        demote cold version groups (least recently used first; ``pins``,
        the leased "channel/vN" groups, are exempt) until they are at or
        under the low one. Also hands over the fault-ins since the last
        pass, so the controller flips their index tier back. The
        controller's sweeper and ``tier_sweep()`` call it."""
        tier = self._tier
        if tier is None:
            return {"enabled": False, "spilled": [], "fault_ins": []}
        spilled: list[str] = []
        async with self._tier_lock:
            fault_ins = tier.drain_faulted()
            if self._resident_bytes > tier.high_bytes:
                for _group, keys in tier.cold_groups(self.store, pins or ()):
                    if self._resident_bytes <= tier.low_bytes:
                        break
                    for key in keys:
                        if await self._tier_demote_key(key):
                            spilled.append(key)
        if spilled:
            obs_recorder.record("tier", "sweep", volume=self.volume_id, spilled=len(spilled),
                                resident_bytes=self._resident_bytes,
                                spilled_bytes=tier.spilled_bytes)
        self._publish_residency()
        return {"enabled": True, "spilled": spilled, "fault_ins": fault_ins,
                "resident_bytes": self._resident_bytes, "spilled_bytes": tier.spilled_bytes,
                "spilled_keys": len(tier.spilled), "budget_bytes": tier.budget_bytes}

    @endpoint
    async def manifest(self) -> list:
        """``{"meta": Request, "mtime": float}`` of every entry a restart
        would find (the durable directory's, and the spill tier's, whose
        bytes live only there), each with the live ``write_gen`` when this
        process wrote the key: the controller's ``rebuild_index`` reads it."""
        async with self._tier_lock:  # no thread is writing the stores
            items = self._durable.manifest() if self._durable is not None else []
            if self._tier is not None:
                items += self._tier.manifest(exclude={item["meta"].key for item in items})
        for item in items:
            gen = self._write_gens.get(item["meta"].key)
            if gen is not None:
                item["write_gen"] = gen
        return items

    @endpoint
    async def stats(self) -> dict:
        """Stored entries and bytes, and the shared-memory segment economics
        once that transport served traffic: live, retired and pooled
        segments and bytes, read leases, warm-ups in flight, handshake
        offers by outcome (spare / pooled / miss), segments created,
        recycled and reaped; and the bulk server's counts once that
        transport served traffic (connections accepted, frames and bytes in
        and out, striped payloads each way, aborts, payloads pending)."""
        stored_bytes = 0
        for entry in self.store.values():
            tensors = [t for _, t in entry.values()] if isinstance(entry, ShardedEntry) else [entry]
            stored_bytes += sum(
                t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor)
            )
        out = {
            "volume_id": self.volume_id,
            "entries": len(self.store),
            "stored_bytes": stored_bytes,
            "resident_bytes": self._resident_bytes,
            "tracked_generations": len(self._write_gens),
        }
        if self._tier is not None:
            out["tier"] = self._tier.stats()
        if self._durable is not None:
            out["durable"] = {"dir": self._durable.root, "entries": len(self._durable.kv)}
        cache = self.ctx.peek(shared_memory.ShmServerCache)
        if cache is not None:
            out["shm"] = cache.stats()
        bulk_cache = self.ctx.peek(bulk.BulkServerCache)
        if bulk_cache is not None:
            out["bulk"] = bulk_cache.stats()
        out["metrics"] = obs_metrics.metrics_snapshot()
        return out

    # ---- cold-start provisioning --------------------------------------------

    @endpoint
    async def shm_capacity(self, config=None) -> dict:
        """Capacity view for the controller's prewarm reservations: the
        bytes /dev/shm has free, and the pool's cap and fill. ``config``
        (the prewarming client's, forwarded by the controller) is adopted
        first, so the grant sees the pool cap the later ``provision_shm``
        runs under."""
        out = {"shm": shared_memory.is_available(), "available_bytes": 0, "pool_cap": 0,
               "pool_bytes": 0}
        if not out["shm"]:
            return out
        cache = self.ctx.get_cache(shared_memory.ShmServerCache)
        cache.adopt_config(config)
        # Twins not populated yet hold no tmpfs pages, but will.
        out["available_bytes"] = max(
            0, shared_memory.shm_available_bytes() - cache.unpopulated_bytes())
        out["pool_cap"] = cache.pool_cap
        out["pool_bytes"] = cache.spare_bytes()
        return out

    @endpoint
    async def provision_shm(self, sizes: dict, config=None) -> dict:
        """Prewarm's shared-memory leg on the volume: create and prefault
        ``{size: count}`` segments into the free pool, so the first put of
        the provisioned working set is offered every segment instead of
        creating them cold, and name the twin set the rotation after it
        draws (``ShmServerCache.provision``). The client's config carries
        the pool cap, as on the put path."""
        if not shared_memory.is_available():
            return {"created": 0, "bytes": 0, "error": "shm unavailable"}
        cache = self.ctx.get_cache(shared_memory.ShmServerCache)
        cache.adopt_config(config)
        with span("provision.shm_pool", volume=self.volume_id, sizes=len(sizes),
                  nbytes=sum(int(s) * int(c) for s, c in sizes.items())):
            result = await cache.provision({int(s): int(c) for s, c in sizes.items()})
        if result["created"]:
            logger.info("provisioned %d segment(s) / %d bytes into volume %s's pool (%d "
                        "already pooled, %d bytes clamped)", result["created"], result["bytes"],
                        self.volume_id, result["already_pooled"], result["clamped_bytes"])
        return result

    # ---- fault injection ---------------------------------------------------

    @endpoint
    async def inject_fault(
        self,
        name: str,
        action: str,
        count: Optional[int] = None,
        prob: Optional[float] = None,
        delay_ms: Optional[float] = None,
    ) -> dict:
        """Arm a fault point inside this volume's process (``faults.py``)."""
        return faults.arm(name, action, count=count, prob=prob, delay_ms=delay_ms)

    @endpoint
    async def clear_faults(self, name: Optional[str] = None) -> int:
        return faults.disarm(name)

    @endpoint
    async def list_faults(self) -> list:
        return faults.armed()

    @endpoint
    async def reset(self) -> None:
        """Forget everything, the durable and spilled copies included."""
        await self._clear()
        async with self._tier_lock:
            if self._durable is not None:
                self._durable.reset()
            if self._tier is not None:
                self._tier.reset()

    async def on_stop(self) -> None:
        """Release the memory tier; the files stay for a volume started
        over them again."""
        await self._clear()

    async def _clear(self) -> None:
        """Drop every entry and unlink every segment this volume owns: live,
        pooled, retired, reserved, staged, and those warm-ups in flight
        make."""
        cache = self.ctx.peek(shared_memory.ShmServerCache)
        self.store.clear()
        self._resident_bytes = 0
        self._write_gens.clear()
        self.ctx.clear()
        if cache is not None:
            await cache.wait_warmups()
        self._publish_residency()

    def _entry(self, key: str, spilled_ok: bool = False) -> Any:
        entry = self.store.get(key)
        if entry is None and spilled_ok and self._tier is not None and key in self._tier.spilled:
            entry = self._tier.disk.kv.get(key)
        if entry is None:
            raise KeyError(f"key {key!r} not found on volume {self.volume_id}")
        return entry


def entry_nbytes(entry: Any) -> int:
    """Tensor bytes of one entry, in a segment or a plain tensor alike
    (objects and missing entries count 0)."""
    if isinstance(entry, ShardedEntry):
        return sum(t.numel() * t.element_size() for _, t in entry.values())
    if isinstance(entry, torch.Tensor):
        return entry.numel() * entry.element_size()
    return 0


def _sub_index(stored: TensorSlice, want: TensorSlice, key: str) -> Optional[tuple]:
    """The index of ``want``'s box inside the tensor of ``stored`` (None: all
    of it); raises when the stored part does not contain it."""
    if not stored.box.contains(want.box):
        raise ValueError(
            f"requested region {want.box} not contained in stored {stored.box} of key {key!r}"
        )
    if want.box == stored.box:
        return None
    rel = Box(tuple(o - so for o, so in zip(want.offsets, stored.offsets)), want.local_shape)
    return rel.to_index()
