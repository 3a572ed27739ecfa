"""Shared-memory transport: the same-host fast path.

Port of the put and zero-copy get of ``torchstore_tpu/transport/
shared_memory.py``. Segments are files in ``/dev/shm`` mapped with mmap;
tensor views over them are ``torch.frombuffer`` on the mapping.

PUT: the client creates a segment per tensor and copies the payload into it
     (a CUDA tensor copies device-to-host straight into the segment); the
     put RPC carries only descriptors. The volume attaches each segment,
     renames it to its own pid (the name's pid is always the owner's) and
     keeps the view as the stored tensor. Small payloads ride the RPC frame.
GET: the volume answers with the descriptor of the segment a key (or one
     shard of a sharded key) lives in, and the index of the wanted box in
     it; a client with a destination maps it with its page tables wired
     and copies the box into the destination
     (host-to-device for a CUDA target); a client without one maps it
     copy-on-write and keeps a view of the box (zero copy). A put never
     writes into a live segment: it lands in a new one and the old name is
     unlinked, so a view a reader holds stays a stable snapshot.

Segment names start with ``tst_shm_``, never ``ts_shm_``: the reference's
orphan reaper and leak checks match its own prefix only. The pooled segment
rotation, read leases and one-sided stamped reads of the reference are not
ported yet.
"""

from __future__ import annotations

import mmap
import os
import uuid
from dataclasses import dataclass
from typing import Any, Optional

import torch

from torchstore_tpu_torch.logging import get_logger
from torchstore_tpu_torch.transport.buffers import (
    Served,
    TransportBuffer,
    TransportCache,
    TransportContext,
    land,
)
from torchstore_tpu_torch.transport.types import Request, TensorMeta

logger = get_logger("torchstore_tpu_torch.transport.shm")

SHM_DIR = "/dev/shm"
PREFIX = "tst_shm_"

# Puts at or under this ride inline in the put RPC instead of a segment.
SMALL_INLINE_BYTES = 64 * 1024


def is_available() -> bool:
    return os.path.isdir(SHM_DIR) and os.access(SHM_DIR, os.W_OK)


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True


def reap_orphaned_segments() -> int:
    """Unlink ``tst_shm_*`` segments whose creating process is gone."""
    reaped = 0
    try:
        names = os.listdir(SHM_DIR)
    except OSError:
        return 0
    for name in names:
        if not name.startswith(PREFIX):
            continue
        try:
            pid = int(name[len(PREFIX) :].split("_")[0])
        except ValueError:
            continue
        if not _pid_alive(pid):
            try:
                os.unlink(os.path.join(SHM_DIR, name))
                reaped += 1
            except OSError:
                pass
    return reaped


def _new_name() -> str:
    return f"{PREFIX}{os.getpid()}_{uuid.uuid4().hex[:12]}"


class ShmSegment:
    """A named shared-memory segment (a file in /dev/shm plus its mapping)."""

    _POPULATE = getattr(mmap, "MAP_POPULATE", 0)

    def __init__(self, name: str, size: int, mm: mmap.mmap) -> None:
        self.name = name
        self.size = size
        self.mmap = mm

    @staticmethod
    def path(name: str) -> str:
        return os.path.join(SHM_DIR, name)

    @classmethod
    def create(cls, size: int) -> "ShmSegment":
        """A new segment of ``size`` bytes named after this process, its
        pages allocated up front (MAP_POPULATE) for the copy that follows."""
        name = _new_name()
        fd = os.open(cls.path(name), os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
        try:
            os.ftruncate(fd, size)
            mm = mmap.mmap(fd, size, flags=mmap.MAP_SHARED | cls._POPULATE)
        finally:
            os.close(fd)
        return cls(name, size, mm)

    @classmethod
    def attach(
        cls, name: str, size: int, private: bool = False, populate: bool = False
    ) -> "ShmSegment":
        """Map an existing segment. ``private`` maps it copy-on-write: the
        reader sees the segment's bytes, and its own writes stay its own.
        ``populate`` wires the page tables up front (MAP_POPULATE) for a
        reader about to copy every byte out; a private mapping never
        populates, as that would copy every page."""
        fd = os.open(cls.path(name), os.O_RDWR)
        try:
            if private:
                flags = mmap.MAP_PRIVATE
            else:
                flags = mmap.MAP_SHARED | (cls._POPULATE if populate else 0)
            mm = mmap.mmap(fd, size, flags=flags)
        finally:
            os.close(fd)
        return cls(name, size, mm)

    def view(self, meta: TensorMeta, offset: int = 0) -> torch.Tensor:
        """A CPU tensor of ``meta`` over the mapping's bytes at ``offset``;
        it keeps the mapping alive for as long as it lives."""
        nbytes = meta.nbytes
        if nbytes == 0:
            return torch.empty(meta.shape, dtype=meta.torch_dtype)
        flat = torch.frombuffer(self.mmap, dtype=torch.uint8, count=nbytes, offset=offset)
        return flat.view(meta.torch_dtype).reshape(meta.shape)

    def rename_to_owner(self) -> None:
        """Rename so the name carries this process's pid: a volume adopting
        a client's segment becomes its owner for the orphan reaper."""
        new_name = _new_name()
        os.rename(self.path(self.name), self.path(new_name))
        self.name = new_name

    def unlink(self) -> None:
        """Remove the name. Mappings (and tensor views) stay valid until
        their last reference goes."""
        try:
            os.unlink(self.path(self.name))
        except FileNotFoundError:
            pass


@dataclass(frozen=True)
class ShmDescriptor:
    segment_name: str
    segment_size: int
    meta: TensorMeta
    index: Optional[tuple] = None  # the wanted box in the segment's tensor


def _cache_key(meta: Request) -> tuple:
    ts = meta.tensor_slice
    return (meta.key, None if ts is None else ts.coordinates)


class ShmServerCache(TransportCache):
    """Volume side: the segment each stored tensor lives in, by (key,
    coordinates); coordinates are None for a whole tensor."""

    def __init__(self) -> None:
        self.by_key: dict[tuple, tuple[ShmSegment, int]] = {}  # -> (seg, data_ptr)

    def put(self, cache_key: tuple, seg: ShmSegment, view: torch.Tensor) -> None:
        self.delete(cache_key)
        self.by_key[cache_key] = (seg, view.data_ptr())

    def lookup(self, cache_key: tuple, entry: torch.Tensor) -> Optional[ShmSegment]:
        """The segment ``entry`` lives in, if it is the stored view."""
        found = self.by_key.get(cache_key)
        if found is None or entry.numel() == 0 or found[1] != entry.data_ptr():
            return None
        return found[0]

    def delete(self, cache_key: tuple) -> None:
        found = self.by_key.pop(cache_key, None)
        if found is not None:
            found[0].unlink()

    def delete_key(self, key: str) -> None:
        for cache_key in [ck for ck in self.by_key if ck[0] == key]:
            self.delete(cache_key)

    def clear(self) -> None:
        for seg, _ in self.by_key.values():
            seg.unlink()
        self.by_key.clear()


class SharedMemoryTransportBuffer(TransportBuffer):
    transport_name = "shm"

    def __init__(self) -> None:
        self.descriptors: dict[int, ShmDescriptor] = {}
        self.inline: dict[int, torch.Tensor] = {}
        self.objects: dict[int, Any] = {}
        # volume -> client (put reply): segment renames on adoption.
        self.renames: dict[str, str] = {}
        # Client-only: segments this buffer created (never pickled).
        self._client_segments: list[ShmSegment] = []

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_client_segments"] = []
        return state

    # ---- client: put -----------------------------------------------------

    async def _pre_put_hook(self, volume, requests: list[Request]) -> None:
        for idx, req in enumerate(requests):
            if req.is_object:
                self.objects[idx] = req.objects
                continue
            if req.nbytes <= SMALL_INLINE_BYTES:
                self.inline[idx] = req.tensor_val.detach().to("cpu").contiguous()
                continue
            meta = TensorMeta.of(req.tensor_val)
            seg = ShmSegment.create(req.nbytes)
            self._client_segments.append(seg)
            # THE hot copy: client tensor (host or device) -> shared segment.
            seg.view(meta).copy_(req.tensor_val)
            self.descriptors[idx] = ShmDescriptor(seg.name, seg.size, meta)

    def _handle_put_reply(self, volume, reply, requests) -> None:
        adopted = set((reply or {}).get("renames", {}))
        # Adopted segments now belong to the volume; the rest never landed.
        self._client_segments = [
            s for s in self._client_segments if s.name not in adopted
        ]

    def drop(self) -> None:
        for seg in self._client_segments:
            seg.unlink()
        self._client_segments = []
        self.descriptors = {}
        self.inline = {}
        self.objects = {}
        self.renames = {}

    # ---- server: put -----------------------------------------------------

    def handle_put_request(
        self, ctx: TransportContext, metas: list[Request], existing: dict[int, Any]
    ) -> dict[int, Any]:
        cache: ShmServerCache = ctx.get_cache(ShmServerCache)
        out: dict[int, Any] = dict(self.objects)
        for idx, tensor in self.inline.items():
            cache.delete(_cache_key(metas[idx]))
            out[idx] = tensor
        for idx, desc in self.descriptors.items():
            seg = ShmSegment.attach(desc.segment_name, desc.segment_size)
            old_name = seg.name
            seg.rename_to_owner()
            self.renames[old_name] = seg.name
            view = seg.view(desc.meta)
            cache.put(_cache_key(metas[idx]), seg, view)
            out[idx] = view
        return out

    def put_reply(self) -> Any:
        return {"renames": self.renames} if self.renames else None

    # ---- server: get -----------------------------------------------------

    def handle_get_request(
        self, ctx: TransportContext, metas: list[Request], entries: list[Any]
    ) -> None:
        cache: ShmServerCache = ctx.get_cache(ShmServerCache)
        for idx, (meta, entry) in enumerate(zip(metas, entries)):
            if meta.is_object:
                self.objects[idx] = entry
                continue
            served: Served = entry
            seg = cache.lookup(served.cache_key, served.tensor)
            if seg is None:
                self.inline[idx] = served.part()  # the frame carries only the part's bytes
            else:
                self.descriptors[idx] = ShmDescriptor(
                    seg.name, seg.size, TensorMeta.of(served.tensor), served.index
                )

    # ---- client: get -----------------------------------------------------

    def _handle_storage_volume_response(
        self, volume, remote: "SharedMemoryTransportBuffer", requests: list[Request]
    ) -> list[Any]:
        results: list[Any] = []
        for idx, req in enumerate(requests):
            if idx in remote.objects:
                results.append(remote.objects[idx])
            elif idx in remote.inline:
                results.append(land(req.destination_view, remote.inline[idx]))
            else:
                desc = remote.descriptors[idx]
                if req.destination_view is None:
                    # Zero-copy: the (copy-on-write) view is the result.
                    seg = ShmSegment.attach(desc.segment_name, desc.segment_size, private=True)
                    results.append(_part(seg.view(desc.meta), desc.index))
                else:
                    seg = ShmSegment.attach(desc.segment_name, desc.segment_size, populate=True)
                    results.append(land(req.destination_view, _part(seg.view(desc.meta), desc.index)))
        return results


def _part(view: torch.Tensor, index: Optional[tuple]) -> torch.Tensor:
    return view if index is None else view[index]
