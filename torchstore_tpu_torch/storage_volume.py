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
plain tensor; pooled spares are not entries. The one-sided planes and the
health and repair endpoints are later work.
"""

from __future__ import annotations

import asyncio
import os
import time
from typing import Any, Optional

import torch

from torchstore_tpu_torch import faults, native
from torchstore_tpu_torch.config import ENV_STORAGE_DIR
from torchstore_tpu_torch.logging import get_logger
from torchstore_tpu_torch.observability import metrics as obs_metrics
from torchstore_tpu_torch.observability import recorder as obs_recorder
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
        self.volume_id = str(strategy.get_volume_id())
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
        # Serializes spills and fault-ins (cold paths; a warm get never takes it).
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
        keys = {meta.key for meta in metas}
        self._store_values(metas, values)
        if self._durable is not None:
            self._durable.store(metas, values)
        if self._tier is not None:
            # Fresh bytes are resident: a disk copy is stale from now on.
            for key in keys:
                self._tier.discard(key)
            self._tier.touch(keys)
        self._publish_residency()
        obs_recorder.record("volume_op", "put", keys=len(metas))
        return {"reply": buffer.put_reply(), "write_gens": self._bump_write_gens(metas)}

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
        for key in keys:
            entry = self.store.pop(key, None)
            spilled = self._tier is not None and self._tier.discard(key)
            if entry is not None or spilled:
                deleted += 1
            self._resident_bytes -= entry_nbytes(entry)
            if self._durable is not None:
                self._durable.delete(key)
            self._write_gens.pop(key, None)
            self.ctx.delete_key(key)
        self._publish_residency()
        return deleted

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
        """Demote one resident key to disk (the caller holds the tier lock);
        True when its memory copy went. A failed spill leaves the entry
        resident and served."""
        try:
            # Inside the failure domain: a raise aborts this key's demotion.
            await faults.afire("volume.spill")
            entry = self.store.get(key)
            if entry is None:
                return False
            self._tier.spill(key, entry)
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 - a failed spill keeps the entry served
            logger.exception("spill of %r failed; the entry stays resident", key)
            return False
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
        if entry is None and spilled_ok and self._tier is not None:
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
