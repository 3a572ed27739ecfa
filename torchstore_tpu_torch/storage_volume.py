"""Storage volume actor: an in-memory key -> tensor/object store.

Port of the ``handshake``/``put``/``get``/``get_meta``/``delete_batch``/
``write_gens``/``stats`` endpoints of ``torchstore_tpu/storage_volume.py``
over an in-memory dict. A key holds a whole tensor, an object, or the
shards of a sharded tensor (one per mesh coordinate, ``ShardedEntry``). A
get may ask for a sub-box of a whole tensor or of one stored shard; the
transport then returns only that box. Every put gives its keys a new write
generation. Tiering, the one-sided planes and the health and repair
endpoints are later work.
"""

from __future__ import annotations

import os
import time
from typing import Any, Optional

import torch

from torchstore_tpu_torch.runtime import Actor, endpoint
from torchstore_tpu_torch.transport import shared_memory
from torchstore_tpu_torch.transport.buffers import Served, TransportBuffer, TransportContext
from torchstore_tpu_torch.transport.types import Request, TensorMeta, TensorSlice
from torchstore_tpu_torch.utils import Box, get_hostname, maybe_await


class ShardedEntry(dict):
    """The shards of one sharded key on this volume:
    coordinates -> (TensorSlice, tensor)."""


class StorageVolume(Actor):
    def __init__(self, strategy) -> None:
        self.volume_id = str(strategy.get_volume_id())
        self.store: dict[str, Any] = {}
        self.ctx = TransportContext()
        self._write_gens: dict[str, int] = {}
        if shared_memory.is_available():
            # Crashed processes leave segments behind; sweep before serving.
            shared_memory.reap_orphaned_segments()

    @endpoint
    async def get_id(self) -> dict:
        return {"volume_id": self.volume_id, "hostname": get_hostname(), "pid": os.getpid()}

    def _existing(self, metas: list[Request]) -> dict[int, Any]:
        return {idx: self.store[m.key] for idx, m in enumerate(metas) if m.key in self.store}

    @endpoint
    async def handshake(self, buffer: TransportBuffer, metas: list[Request], op: str) -> Any:
        existing = self._existing(metas) if op == "put" else {}
        return await maybe_await(buffer.recv_handshake(self.ctx, metas, existing, op))

    @endpoint
    async def put(self, buffer: TransportBuffer, metas: list[Request]) -> dict:
        """Land ``metas``; returns ``{"reply": the transport's put reply,
        "write_gens": {key: new write generation}}``."""
        for meta in metas:
            self._supersede(meta)
        values = await maybe_await(buffer.handle_put_request(self.ctx, metas, self._existing(metas)))
        for idx, meta in enumerate(metas):
            ts = meta.tensor_slice
            if ts is None:
                self.store[meta.key] = values[idx]
            else:
                self.store.setdefault(meta.key, ShardedEntry())[ts.coordinates] = (ts, values[idx])
        return {"reply": buffer.put_reply(), "write_gens": self._bump_write_gens(metas)}

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
        del self.store[meta.key]
        self.ctx.delete_key(meta.key)

    @endpoint
    async def get(self, buffer: TransportBuffer, metas: list[Request]) -> TransportBuffer:
        entries = [self._serve(meta) for meta in metas]
        await maybe_await(buffer.handle_get_request(self.ctx, metas, entries))
        return buffer

    def _serve(self, meta: Request) -> Any:
        """The object, or the ``Served`` part of a stored tensor, that
        ``meta`` asks for."""
        entry = self._entry(meta.key)
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
        objects)."""
        return [None if meta.is_object else TensorMeta.of(self._serve(meta).part())
                for meta in metas]

    @endpoint
    async def delete_batch(self, keys: list[str]) -> int:
        """Idempotent: missing keys are ignored so cleanup retries are safe."""
        deleted = 0
        for key in keys:
            if self.store.pop(key, None) is not None:
                deleted += 1
            self._write_gens.pop(key, None)
            self.ctx.delete_key(key)
        return deleted

    @endpoint
    async def stats(self) -> dict:
        """Stored entries and bytes, and the shared-memory segment economics
        once that transport served traffic: live, retired and pooled
        segments and bytes, read leases, warm-ups in flight, handshake
        offers by outcome (spare / pooled / miss), segments created,
        recycled and reaped."""
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
            "tracked_generations": len(self._write_gens),
        }
        cache = self.ctx.peek(shared_memory.ShmServerCache)
        if cache is not None:
            out["shm"] = cache.stats()
        return out

    @endpoint
    async def reset(self) -> None:
        await self._clear()

    async def on_stop(self) -> None:
        await self._clear()

    async def _clear(self) -> None:
        """Drop every entry and unlink every segment this volume owns: live,
        pooled, retired, reserved, staged, and those warm-ups in flight
        make."""
        cache = self.ctx.peek(shared_memory.ShmServerCache)
        self.store.clear()
        self._write_gens.clear()
        self.ctx.clear()
        if cache is not None:
            await cache.wait_warmups()

    def _entry(self, key: str) -> Any:
        try:
            return self.store[key]
        except KeyError:
            raise KeyError(f"key {key!r} not found on volume {self.volume_id}") from None


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
