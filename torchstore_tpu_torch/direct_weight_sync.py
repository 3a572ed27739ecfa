"""Direct (one-hop) weight sync: the dest pulls straight from the source's
staging buffers; the store carries only handles.

Port of the host path of ``torchstore_tpu/direct_weight_sync.py``:

- ``DirectWeightSyncSource.register`` stages every tensor leaf (a
  ``Shard``'s or a DTensor's local shard, with its placement in the
  handle) once into a buffer of its own (a ``/dev/shm`` segment, or process
  memory without shared memory), page-locked with ``cudaHostRegister``
  when the leaves live on a card. The CUDA floating leaves are first cast
  to the transfer dtype on the card by the hand-written grouped cast
  kernel, one launch per chunk of ``ops.plan_chunks``, so the
  device-to-host copies move the transfer dtype's bytes; casts and copies
  run on one side stream per card, and each chunk's outputs are reused by
  the next chunk in stream order. ``refresh`` re-stages current values into
  the same buffers, so published handles stay valid across training steps,
  under a generation seqlock (odd while the buffers are being overwritten,
  +2 per publish once every copy has landed).
- ``_PeerReadServer`` serves ranged reads of the buffers over TCP and the
  generation (``_GET_GEN``).
- ``DirectWeightSyncDest.pull`` builds a transfer plan once (one region
  per distinct intersection of a target's slice with a source shard),
  reads each source buffer (shared-memory attach on the same host,
  page-locked once for CUDA targets; TCP otherwise) and copies the planned
  regions into the caller's tensors in place (CPU or CUDA, asynchronously
  to a card and awaited), re-reading the source generations to detect a
  refresh that tore the pull.

The device-to-device rung (CUDA IPC) is later work: the source takes the
host path, as the reference does with its device rung switched off.
"""

from __future__ import annotations

import asyncio
import struct
import threading
import time
from dataclasses import dataclass
from typing import Any, Optional

import torch

from torchstore_tpu_torch import sharding
from torchstore_tpu_torch.client import Shard
from torchstore_tpu_torch.logging import LatencyTracker, get_logger
from torchstore_tpu_torch.ops import staging
from torchstore_tpu_torch.ops.staging import cast_reference
from torchstore_tpu_torch.runtime.actors import BIND_HOST
from torchstore_tpu_torch.runtime.serialization import tensor_bytes
from torchstore_tpu_torch.state_dict_utils import (
    _leaf_signature,
    flatten_state_dict,
    unflatten_state_dict,
)
from torchstore_tpu_torch.transport import shared_memory as shm
from torchstore_tpu_torch.transport.pinning import host_register, host_unregister, side_stream
from torchstore_tpu_torch.transport.types import TensorMeta, TensorSlice, dtype_name, full_slice
from torchstore_tpu_torch.utils import Box, get_destination_view, get_hostname, intersect_boxes

logger = get_logger("torchstore_tpu_torch.direct")


class PullRaceError(RuntimeError):
    """A direct pull lost its race with source refreshes (the generation
    never settled, or moved during two attempts)."""


_READ_REQ = struct.Struct("<QQQ")  # buffer_id, offset, length
_READ_RESP = struct.Struct("<Q")  # length (_ERR = error)
_ERR = (1 << 64) - 1
# buffer_id sentinel: "reply with the source's current weight generation".
_GET_GEN = (1 << 64) - 4
_U64 = struct.Struct("<Q")
# How long a pull waits for a source whose buffers are being overwritten: a
# model-scale refresh legitimately holds the generation odd for seconds.
SETTLE_TIMEOUT_S = 30.0
# Connections per source: concurrent reads overlap instead of queueing.
_POOL_SIZE = 4


@dataclass
class WeightHandle:
    """Picklable pointer to one registered source buffer."""

    buffer_id: int
    hostname: str
    port: int
    shm_name: Optional[str]
    meta: TensorMeta
    tensor_slice: TensorSlice
    source_rank: int


# --------------------------------------------------------------------------
# source side
# --------------------------------------------------------------------------


class _PeerReadServer:
    """Serves ranged reads of registered buffers and the generation."""

    def __init__(self) -> None:
        self.buffers: dict[int, torch.Tensor] = {}
        self.gen_fn = lambda: 0
        self._server: Optional[asyncio.AbstractServer] = None
        self.port: Optional[int] = None
        self._writers: set = set()

    async def ensure_started(self) -> int:
        if self._server is None:
            self._server = await asyncio.start_server(self._handle, BIND_HOST, 0)
            self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def _handle(self, reader, writer) -> None:
        self._writers.add(writer)
        try:
            while True:
                req = await reader.readexactly(_READ_REQ.size)
                buffer_id, offset, length = _READ_REQ.unpack(req)
                if buffer_id == _GET_GEN:
                    writer.write(_READ_RESP.pack(_U64.size) + _U64.pack(self.gen_fn()))
                    await writer.drain()
                    continue
                buf = self.buffers.get(buffer_id)
                if buf is None:
                    writer.write(_READ_RESP.pack(_ERR))
                    await writer.drain()
                    continue
                chunk = tensor_bytes(buf)[offset : offset + length]
                writer.write(_READ_RESP.pack(chunk.nbytes))
                writer.write(memoryview(chunk))
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            self._writers.discard(writer)
            writer.close()

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            for writer in list(self._writers):
                writer.close()
            try:
                await asyncio.wait_for(self._server.wait_closed(), timeout=2.0)
            except asyncio.TimeoutError:
                pass
            self._server = None


class _D2HStream:
    """The side stream of one card that publishes cast and copy on: it
    waits for the work already queued on the card's current stream, and
    ``synchronize`` waits for every copy issued on it. One stream per card
    serves every source of the process, so the cast outputs freed on it
    are reused by the next publish instead of being cached per stream."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.stream = side_stream(device)
        self._ctx = None

    def __enter__(self) -> "_D2HStream":
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        self._ctx = torch.cuda.stream(self.stream)
        self._ctx.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._ctx.__exit__(*exc)

    def synchronize(self) -> None:
        self.stream.synchronize()


def _synchronize(device: torch.device) -> None:
    """Wait for the copies a pull issued on ``device``'s current stream."""
    torch.cuda.current_stream(device).synchronize()


def _local_shard(value: Any) -> Optional[tuple[TensorSlice, torch.Tensor]]:
    """(placement, local tensor) of a source leaf or a pull target: a whole
    tensor, a ``Shard``'s data or a DTensor's local shard; None for a leaf
    the direct path leaves alone. A torch process holds one shard of each
    leaf, so this is the counterpart of the reference's ``_shards_of`` and
    ``_target_slices``."""
    if isinstance(value, Shard):
        if value.data is None:
            raise ValueError("direct sync moves Shard data; pass Shard(tensor, slice)")
        return value.tensor_slice, value.data
    if sharding.is_dtensor(value):
        return sharding.target_slice(value), sharding.local_tensor(value)
    if isinstance(value, torch.Tensor):
        return full_slice(tuple(value.shape)), value
    return None


class DirectWeightSyncSource:
    """Registers a state dict's tensors into pull-able staging buffers."""

    def __init__(self, use_shm: bool = True) -> None:
        self.use_shm = use_shm and shm.is_available()
        self.server = _PeerReadServer()
        self.segments: dict[int, shm.ShmSegment] = {}
        self.handles: dict[str, list[WeightHandle]] = {}
        self._sources: dict[str, Any] = {}  # flat_key -> live leaf
        self._transfer_dtype: Optional[torch.dtype] = None
        self._next_id = 0
        self._registered = False
        self._mapping: Optional[dict] = None
        self._flat_template: dict[str, Any] = {}
        # Host pointers of the page-locked staging buffers, and the seconds
        # their registration took (it faults in every page).
        self._pinned: list[int] = []
        self.pin_seconds = 0.0
        # Weight generation (seqlock): _gen is even and moves +2 per
        # publish; the server reports _gen + 1 (odd) while an overwrite of
        # the buffers runs, and from a refresh that failed after it began
        # overwriting until one completes.
        self._gen = 0
        self._busy = 0
        self._torn = False
        self._gen_lock = threading.Lock()
        self.server.gen_fn = self._read_gen

    def _read_gen(self) -> int:
        with self._gen_lock:
            return self._gen + 1 if self._busy or self._torn else self._gen

    def _bump_gen(self, n: int = 2) -> None:
        with self._gen_lock:
            self._gen += n

    def _set_busy(self, on: bool) -> None:
        with self._gen_lock:
            self._busy += 1 if on else -1

    def _staged_dtype(self, value: torch.Tensor) -> torch.dtype:
        """The dtype ``value`` is staged in: the transfer dtype for a
        floating leaf, its own otherwise."""
        dtype = self._transfer_dtype
        if dtype is not None and value.is_floating_point():
            return dtype
        return value.dtype

    def _plan_stage(self, keys: list[str]) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """The (local value, staging buffer) copies that write the current
        values of ``keys``, every leaf checked against its buffer (kind,
        placement, shape, dtype) before any copy runs. Leaves that alias
        their buffer need no copy."""
        copies = []
        for flat_key in keys:
            shard = _local_shard(self._sources[flat_key])
            (handle,) = self.handles[flat_key]
            if shard is None or shard[0] != handle.tensor_slice:
                raise ValueError(
                    f"refresh of {flat_key!r}: the value is no longer the tensor or shard "
                    f"{handle.tensor_slice} that was registered; re-register after "
                    "changing a param's sharding"
                )
            value = shard[1].detach()
            staged = self.server.buffers[handle.buffer_id]
            if _aliases(staged, value):
                # The trainer writes straight into the published buffer
                # (staging_state_dict): nothing to copy.
                continue
            dtype = self._staged_dtype(value)
            if tuple(value.shape) != tuple(staged.shape) or dtype != staged.dtype:
                raise ValueError(
                    f"refresh of {flat_key!r}: value is now {tuple(value.shape)} "
                    f"{dtype} but {tuple(staged.shape)} {staged.dtype} was "
                    "registered; re-register after changing a param's shape or dtype"
                )
            copies.append((value, staged))
        return copies

    def _stage(self, copies: list[tuple[torch.Tensor, torch.Tensor]]) -> None:
        """Write values into their staging buffers, cast where they live: a
        CPU leaf by the plain cast; the CUDA leaves of each card on one side
        stream, those that need the transfer dtype through ``cast_on_card``
        (the grouped kernel, one launch per chunk; pairs it does not cover
        by ``x.to()``), every device-to-host copy issued non-blocking into
        the page-locked buffers; then one wait per card for its copies."""
        by_card: dict[torch.device, list[tuple[torch.Tensor, torch.Tensor]]] = {}
        for value, staged in copies:
            card = staging.card_of(value)
            if card is None:
                staged.copy_(cast_reference(value, staged.dtype))
            else:
                by_card.setdefault(card, []).append((value, staged))
        streams = []
        for card, items in by_card.items():
            with _D2HStream(card) as stream:
                to_cast = []
                for value, staged in items:
                    if value.dtype == staged.dtype:
                        staged.copy_(value, non_blocking=True)
                    else:
                        to_cast.append((value.contiguous(), staged))
                for indices, outs in staging.cast_on_card(
                    [v for v, _ in to_cast], self._transfer_dtype
                ):
                    for i, out in zip(indices, outs):
                        to_cast[i][1].copy_(out, non_blocking=True)
            streams.append(stream)
        for stream in streams:
            stream.synchronize()

    async def register(
        self,
        state_dict: Any,
        rank: int = 0,
        transfer_dtype: Optional[torch.dtype] = None,
        num_ranks: int = 1,
    ) -> dict[str, list[WeightHandle]]:
        port = await self.server.ensure_started()
        self._transfer_dtype = transfer_dtype
        flat, mapping = flatten_state_dict(state_dict)
        self._mapping = mapping
        shards = {k: _local_shard(v) for k, v in flat.items()}
        self._flat_template = {k: v for k, v in flat.items() if shards[k] is None}
        # Buffers a card copies into are page-locked once, here.
        pin = any(s is not None and staging.card_of(s[1]) is not None for s in shards.values())
        hostname = get_hostname()
        tracker = LatencyTracker("direct_register")
        nbytes = 0
        keys = []
        for flat_key, shard in shards.items():
            if shard is None:
                continue  # non-tensor leaves don't take the direct path
            ts, value = shard
            keys.append(flat_key)
            self._sources[flat_key] = flat[flat_key]
            meta = TensorMeta(tuple(int(s) for s in value.shape),
                              dtype_name(self._staged_dtype(value)))
            buffer_id = self._next_id
            self._next_id += 1
            shm_name = None
            if self.use_shm:
                seg = shm.ShmSegment.create(max(meta.nbytes, 1))
                self.segments[buffer_id] = seg
                staged = seg.view(meta)
                shm_name = seg.name
            else:
                staged = torch.empty(meta.shape, dtype=meta.torch_dtype)
            if pin:
                t0 = time.perf_counter()
                ptr = host_register(staged)
                self.pin_seconds += time.perf_counter() - t0
                if ptr is not None:
                    self._pinned.append(ptr)
            nbytes += meta.nbytes
            self.server.buffers[buffer_id] = staged
            self.handles[flat_key] = [
                WeightHandle(
                    buffer_id=buffer_id,
                    hostname=hostname,
                    port=port,
                    shm_name=shm_name,
                    meta=meta,
                    tensor_slice=ts,
                    source_rank=rank,
                )
            ]
        self._stage(self._plan_stage(keys))
        tracker.track_step("stage", nbytes)
        tracker.log_summary(level=20)
        self._registered = True
        return self.handles

    async def refresh(self) -> None:
        """Re-stage the current values into the registered buffers. A leaf
        that no longer matches its buffer raises before any buffer is
        overwritten, and the generation stays as it was; a failure after
        the overwrite began leaves the generation odd until a refresh
        completes, so no pull takes the torn buffers for a publish."""
        if not self._registered:
            raise RuntimeError("register() must run before refresh()")
        copies = self._plan_stage(list(self._sources))
        self._set_busy(True)  # reported odd while buffers are overwritten
        try:
            self._stage(copies)
        except BaseException:
            self._torn = True
            raise
        else:
            self._torn = False
            self._bump_gen(2)
        finally:
            self._set_busy(False)

    def staging_state_dict(self) -> Optional[Any]:
        """The registered staging buffers in the original structure (a
        sharded leaf as a ``Shard`` of its buffer): a trainer that writes
        its weights into them makes every later direct put copy-free."""
        if not self._registered or self._mapping is None:
            return None
        flat = dict(self._flat_template)
        for flat_key, (handle,) in self.handles.items():
            buf = self.server.buffers[handle.buffer_id]
            full = handle.tensor_slice.is_full() and not handle.tensor_slice.mesh_shape
            flat[flat_key] = buf if full else Shard(buf, handle.tensor_slice)
        return unflatten_state_dict(flat, self._mapping)

    def update_sources(self, state_dict: Any) -> None:
        """Point ``refresh`` at the tensors of ``state_dict`` (same keys)."""
        flat, _ = flatten_state_dict(state_dict)
        for key in self._sources:
            self._sources[key] = flat[key]

    async def close(self) -> None:
        await self.server.stop()
        host_unregister(self._pinned)  # before the mappings go
        self._pinned.clear()
        for seg in self.segments.values():
            seg.unlink()
        self.segments.clear()
        self.server.buffers.clear()
        # The server's generation callback makes a reference cycle: drop the
        # live leaves now, not when the cycle collector runs (they may be
        # the trainer's weights on a card).
        self._sources.clear()


def _aliases(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same memory with the same interpretation (layout included)."""
    return (
        a.device == b.device
        and a.data_ptr() == b.data_ptr()
        and a.dtype == b.dtype
        and a.shape == b.shape
        and a.stride() == b.stride()
    )


# --------------------------------------------------------------------------
# dest side
# --------------------------------------------------------------------------


@dataclass
class _TransferOp:
    """One planned read: ``handle``'s bytes covering global ``region``."""

    flat_key: str
    handle: WeightHandle
    region: Box


class DirectWeightSyncDest:
    def __init__(self) -> None:
        self._plan: Optional[list[_TransferOp]] = None
        self._plan_sig: Optional[tuple] = None
        self._conns: dict[tuple[str, int], dict] = {}
        self._segments: dict[str, shm.ShmSegment] = {}
        # Attachments page-locked for host-to-device copies (name ->
        # pointer), and the seconds their registration took.
        self._pinned: dict[str, int] = {}
        self.pin_seconds = 0.0
        self._lock = asyncio.Lock()

    # ---- plan -------------------------------------------------------------

    def _build_plan(
        self, all_handles: dict[str, list[WeightHandle]], dest_flat: dict[str, Any]
    ) -> list[_TransferOp]:
        """One op per distinct intersection of each target's region with a
        source shard (replicated shards hold identical ones)."""
        plan: list[_TransferOp] = []
        for flat_key, target in dest_flat.items():
            landing = _local_shard(target)
            if landing is None:
                continue
            handles = all_handles.get(flat_key)
            if handles is None:
                raise KeyError(
                    f"dest state dict expects {flat_key!r} but the source "
                    "published no handle for it"
                )
            want = landing[0]
            covered: set[Box] = set()
            covered_elems = 0
            for handle in handles:
                if handle.tensor_slice.global_shape != want.global_shape:
                    raise ValueError(
                        f"{flat_key!r}: source shape {handle.tensor_slice.global_shape} "
                        f"!= target shape {want.global_shape}"
                    )
                inter = intersect_boxes(handle.tensor_slice.box, want.box)
                if inter is None or inter in covered:
                    continue  # disjoint, or a replica's identical region
                covered.add(inter)
                covered_elems += inter.size
                plan.append(_TransferOp(flat_key, handle, inter))
            if covered_elems < want.box.size:
                raise ValueError(
                    f"source shards cover only {covered_elems} of "
                    f"{want.box.size} elements of {flat_key!r} region {want.box}"
                )
        return plan

    @staticmethod
    def _plan_signature(all_handles: dict, dest_flat: dict) -> tuple:
        target_sig = tuple(
            sorted(
                (k, _leaf_signature(v)) for k, v in dest_flat.items()
                if _local_shard(v) is not None
            )
        )
        handle_sig = tuple(
            sorted(
                (k, tuple((h.buffer_id, h.port, h.tensor_slice) for h in v))
                for k, v in all_handles.items()
            )
        )
        return handle_sig, target_sig

    def _ensure_plan(self, all_handles: dict, dest_flat: dict) -> None:
        sig = self._plan_signature(all_handles, dest_flat)
        if self._plan is None or self._plan_sig != sig:
            self._plan = self._build_plan(all_handles, dest_flat)
            self._plan_sig = sig

    @property
    def planned_ops(self) -> int:
        """Regions the last pull copied: one per distinct intersection."""
        return len(self._plan or ())

    # ---- pull -------------------------------------------------------------

    async def pull(self, all_handles: dict[str, list[WeightHandle]], dest_state_dict: Any) -> Any:
        """Pull every planned region into the dest tensors, validated
        against concurrent source refreshes: the generations are read
        before and after the data moves (after the copies to the cards have
        completed), and a pull that a refresh tore is retried once (a retry
        overwrites every landing)."""
        endpoints = sorted({(h.hostname, h.port) for hs in all_handles.values() for h in hs})
        for _ in (0, 1):
            gens0 = await self._stable_gens(endpoints)
            result = await self._pull_once(all_handles, dest_state_dict)
            gens1 = list(await asyncio.gather(*(self._read_gen(h, p) for h, p in endpoints)))
            if gens1 == gens0:
                return result
            logger.info("direct pull raced a source refresh (%s -> %s); retrying", gens0, gens1)
        raise PullRaceError(
            "direct pull torn twice by concurrent source refreshes: throttle "
            "publishes or pull between refreshes"
        )

    async def _read_gen(self, hostname: str, port: int) -> int:
        (gen,) = _U64.unpack(await self._control_op(hostname, port, _GET_GEN))
        return gen

    async def _stable_gens(self, endpoints) -> list:
        """Every source's generation once none is mid-overwrite (odd)."""
        deadline = time.monotonic() + SETTLE_TIMEOUT_S
        delay = 0.02
        while True:
            gens = list(await asyncio.gather(*(self._read_gen(h, p) for h, p in endpoints)))
            if all(g % 2 == 0 for g in gens):
                return gens
            if time.monotonic() >= deadline:
                raise PullRaceError(
                    f"source refresh never settled (generation odd for {SETTLE_TIMEOUT_S:.0f}s)"
                )
            await asyncio.sleep(delay)
            delay = min(delay * 1.5, 0.25)

    async def _pull_once(self, all_handles: dict, dest_state_dict: Any) -> Any:
        tracker = LatencyTracker("direct_pull")
        dest_flat, mapping = flatten_state_dict(dest_state_dict)
        self._ensure_plan(all_handles, dest_flat)
        tracker.track_step("plan")
        # Landing buffer per target: its (local) tensor when contiguous
        # (ops write straight into destination memory), else a contiguous
        # stand-in copied back at the end.
        landings: dict[str, tuple[TensorSlice, torch.Tensor]] = {}
        cards: set = set()
        for flat_key, target in dest_flat.items():
            landing = _local_shard(target)
            if landing is None:
                continue
            want, local = landing
            buf = local if local.is_contiguous() else torch.empty_like(
                local, memory_format=torch.contiguous_format
            )
            landings[flat_key] = (want, buf)
            card = staging.card_of(local)
            if card is not None:
                cards.add(card)
        by_handle: dict[tuple, tuple[WeightHandle, list[_TransferOp]]] = {}
        for op in self._plan:
            hkey = (op.handle.hostname, op.handle.port, op.handle.buffer_id)
            by_handle.setdefault(hkey, (op.handle, []))[1].append(op)
        # Attachments a card copies out of are page-locked once, when first
        # attached; the copies to the cards are then issued non-blocking.
        pin = bool(cards)
        reads = await asyncio.gather(
            *(self._read_shard(handle, pin) for handle, _ in by_handle.values())
        )
        nbytes = 0
        for (_, ops), arr in zip(by_handle.values(), reads):
            nbytes += arr.numel() * arr.element_size()
            for op in ops:
                self._apply_op(op, arr, landings, non_blocking=pin)
        tracker.track_step("reads", nbytes)
        out_flat = dict(dest_flat)
        for flat_key, (_, buf) in landings.items():
            target = dest_flat[flat_key]
            local = _local_shard(target)[1]
            if buf is not local:
                local.copy_(buf)
            out_flat[flat_key] = target.data if isinstance(target, Shard) else target
        for card in cards:
            _synchronize(card)
        tracker.track_step("land")
        tracker.log_summary(level=20)
        return unflatten_state_dict(out_flat, mapping)

    @staticmethod
    def _apply_op(op: _TransferOp, shard: torch.Tensor, landings, non_blocking: bool) -> None:
        """Copy the part of ``shard`` (the handle's whole buffer) that the
        op covers into its place in the landing."""
        want, buf = landings[op.flat_key]
        inter = op.region
        rel_src = tuple(
            slice(o - so, o - so + s)
            for o, so, s in zip(inter.offsets, op.handle.tensor_slice.offsets, inter.shape)
        )
        view = get_destination_view(buf, want.box, inter, require_contiguous=False)
        view.copy_(shard[rel_src], non_blocking=non_blocking)

    async def _get_conn(self, host: str, port: int):
        """A pooled (reader, writer, lock) to a source's peer server."""
        key = (host, port)
        async with self._lock:
            pool = self._conns.setdefault(key, {"conns": [], "rr": 0})
            if len(pool["conns"]) < _POOL_SIZE:
                reader, writer = await asyncio.wait_for(
                    asyncio.open_connection(host, port), timeout=30
                )
                conn = (reader, writer, asyncio.Lock())
                pool["conns"].append(conn)
            else:
                conn = pool["conns"][pool["rr"] % len(pool["conns"])]
                pool["rr"] += 1
        return conn

    async def _control_op(self, hostname: str, port: int, opcode: int) -> bytes:
        host = "127.0.0.1" if hostname == get_hostname() else hostname
        reader, writer, lock = await self._get_conn(host, port)
        async with lock:
            writer.write(_READ_REQ.pack(opcode, 0, 0))
            await writer.drain()
            (length,) = _READ_RESP.unpack(await reader.readexactly(_READ_RESP.size))
            if length == _ERR:
                raise KeyError(f"source refused control op {opcode:#x}")
            return await reader.readexactly(length)

    async def _read_shard(self, handle: WeightHandle, pin: bool = False) -> torch.Tensor:
        """One-hop read of a source buffer: a shared-memory attach on the
        same host (page-locked once when ``pin``), a TCP read otherwise."""
        if handle.shm_name is not None and handle.hostname == get_hostname():
            seg = self._segments.get(handle.shm_name)
            if seg is None:
                seg = shm.ShmSegment.attach(
                    handle.shm_name, max(handle.meta.nbytes, 1), populate=True
                )
                self._segments[handle.shm_name] = seg
            view = seg.view(handle.meta)
            if pin and handle.shm_name not in self._pinned:
                t0 = time.perf_counter()
                ptr = host_register(view)
                self.pin_seconds += time.perf_counter() - t0
                if ptr is not None:
                    self._pinned[handle.shm_name] = ptr
            return view
        host = "127.0.0.1" if handle.hostname == get_hostname() else handle.hostname
        reader, writer, lock = await self._get_conn(host, handle.port)
        async with lock:
            writer.write(_READ_REQ.pack(handle.buffer_id, 0, handle.meta.nbytes))
            await writer.drain()
            (length,) = _READ_RESP.unpack(await reader.readexactly(_READ_RESP.size))
            if length == _ERR:
                raise KeyError(
                    f"source no longer has buffer {handle.buffer_id} (rank {handle.source_rank})"
                )
            raw = bytearray(length)
            view = memoryview(raw)
            pos = 0
            while pos < length:
                chunk = await reader.read(min(length - pos, 4 << 20))
                if not chunk:
                    raise ConnectionError("source closed mid-read")
                view[pos : pos + len(chunk)] = chunk
                pos += len(chunk)
        if length != handle.meta.nbytes:
            raise ConnectionError(
                f"source sent {length} of {handle.meta.nbytes} bytes of buffer {handle.buffer_id}"
            )
        if length == 0:
            return torch.empty(handle.meta.shape, dtype=handle.meta.torch_dtype)
        arr = torch.frombuffer(raw, dtype=torch.uint8).view(handle.meta.torch_dtype)
        return arr.reshape(handle.meta.shape)

    async def close(self) -> None:
        async with self._lock:
            for pool in self._conns.values():
                for _, writer, _ in pool["conns"]:
                    writer.close()
            self._conns.clear()
        host_unregister(self._pinned.values())  # before the mappings go
        self._pinned.clear()
        self._segments.clear()
