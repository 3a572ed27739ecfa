"""Direct (one-hop) weight sync: the dest pulls straight from the source's
staging; the store carries only handles.

Port of ``torchstore_tpu/direct_weight_sync.py``. Two rungs:

- **Device rung** (``register`` when every tensor leaf lives on a card,
  ``config.ici_enabled`` is set and CUDA is available; ``device=False``
  pins the host rung). Every leaf is staged on its own card into one
  staging block per card, allocated once at ``register``: the floating
  leaves cast to the transfer dtype by the hand-written grouped cast
  kernel, writing into the block (one launch per chunk of
  ``ops.plan_chunks``), the others copied. The rank publishes a
  ``DeviceEntry`` per leaf (where it sits in the global tensor and in the
  block). A dest on the same host copies card to card: in the source's own
  process straight from the staging tensors (``direct.device_local_pulls``),
  in another process through CUDA IPC handles of the blocks, opened once
  per registration (``_STAGE_DEVICE``; ``direct.device_ipc_pulls``). A dest
  that cannot open a block (its card is not visible, or the source is on
  another host) asks the source to copy the staging to host buffers once
  per content generation (``_STAGE_HOST``) and reads those over the host
  rung (``direct.device_fallbacks``, logged at WARNING). The reference
  stages the live arrays per pull, which JAX can do because its arrays are
  immutable; torch leaves change in place under ``optimizer.step()``, so
  the port snapshots at publish: ``refresh`` re-stages into the same blocks.
- **Host rung**: every tensor leaf (a ``Shard``'s or a DTensor's local
  shard, with its placement in the handle) is staged once into a buffer of
  its own (a ``/dev/shm`` segment, or process memory without shared
  memory), page-locked with ``cudaHostRegister`` when the leaves live on a
  card; CUDA floating leaves are first cast on the card by the grouped
  kernel, so the device-to-host copies move the transfer dtype's bytes. The
  peer server serves ranged reads of the buffers over TCP (each connection
  first passes the auth challenge of ``runtime/auth.py`` when the store has
  a secret). The dest builds
  a transfer plan once (one region per distinct intersection of a target's
  slice with a source shard; cached, and buildable ahead by ``preplan``),
  reads each buffer once (shared-memory attach on the same host,
  page-locked once for CUDA targets; TCP otherwise, only the rows the plan
  needs) and copies the regions into the caller's tensors in place. With
  ``key_order`` / ``on_layer`` it pulls key by key in that order and hands
  each key over as it lands.

Both rungs keep one generation seqlock per source: odd while the staging is
being overwritten, +2 per publish once every copy has landed. A dest reads
the generations before and after the data moves (after its copies to the
cards completed) and retries once when a refresh tore the pull.
"""

from __future__ import annotations

import asyncio
import math
import os
import pickle
import struct
import threading
import time
import uuid
import weakref
from dataclasses import dataclass
from typing import Any, Optional

import torch

from torchstore_tpu_torch import sharding
from torchstore_tpu_torch.client import Shard
from torchstore_tpu_torch.config import StoreConfig, default_config
from torchstore_tpu_torch.logging import LatencyTracker, get_logger
from torchstore_tpu_torch.observability import metrics as obs_metrics
from torchstore_tpu_torch.ops import staging
from torchstore_tpu_torch.ops.staging import cast_reference
from torchstore_tpu_torch.provision.pool import local_pool
from torchstore_tpu_torch.config import advertise_host, bind_host
from torchstore_tpu_torch.runtime.auth import (
    client_authenticate,
    close_unauthenticated,
    server_authenticate,
)
from torchstore_tpu_torch.runtime.serialization import tensor_bytes
from torchstore_tpu_torch.state_dict_utils import (
    _leaf_signature,
    flatten_state_dict,
    unflatten_state_dict,
)
from torchstore_tpu_torch.transport import device_transfer as dt
from torchstore_tpu_torch.transport import shared_memory as shm
from torchstore_tpu_torch.transport.pinning import host_register, host_unregister, side_stream
from torchstore_tpu_torch.transport.types import TensorMeta, TensorSlice, dtype_name, full_slice
from torchstore_tpu_torch.utils import (
    Box,
    boxes_cover,
    get_destination_view,
    get_hostname,
    intersect_boxes,
    maybe_await,
)

logger = get_logger("torchstore_tpu_torch.direct")

# The device rung's three routes, counted apart, and the pulls a refresh tore.
DEVICE_LOCAL_PULLS = obs_metrics.counter("direct.device_local_pulls",
                             "Device-rung pulls served in the source's own process")
DEVICE_IPC_PULLS = obs_metrics.counter("direct.device_ipc_pulls", "Device-rung pulls over CUDA IPC")
DEVICE_FALLBACKS = obs_metrics.counter("direct.device_fallbacks",
                           "Device-rung pulls served from the source's host staging")
PULL_RETRIES = obs_metrics.counter("direct.pull_retries",
                                   "Direct pulls retried after a refresh tore them")
# A first pull that reuses a plan built by ``preplan`` (``api.prewarm``).
PLAN_PREWARM_HITS = obs_metrics.counter("ts_prewarm_plan_cache_hits_total",
                            "Direct-sync pulls that hit a prewarm-built transfer plan")


class PullRaceError(RuntimeError):
    """A direct pull lost its race with source refreshes (the generation
    never settled, or moved during two attempts)."""


_READ_REQ = struct.Struct("<QQQ")  # buffer_id, offset, length
_READ_RESP = struct.Struct("<Q")  # length (_ERR = error)
_ERR = (1 << 64) - 1
# buffer_id sentinel: "reply with the CUDA IPC handles of the staging blocks"
# (the device rung's control op; the handles are stable per registration).
_STAGE_DEVICE = (1 << 64) - 2
# buffer_id sentinel: "copy the staging to host buffers (once per content
# generation) and reply with their pickled WeightHandles": the fallback for
# dests that cannot open the blocks.
_STAGE_HOST = (1 << 64) - 3
# buffer_id sentinel: "reply with the source's current weight generation".
_GET_GEN = (1 << 64) - 4
_U64 = struct.Struct("<Q")
# Connections per source: concurrent reads overlap instead of queueing.
_POOL_SIZE = 4
# Byte alignment of each leaf in a staging block (the cast kernel's bulk
# copies want 16).
_ALIGN = 256

# Device-mode sources of this process by registration token: the in-process
# route of the device rung (a process cannot open its own IPC handles).
_local_sources: "weakref.WeakValueDictionary[str, DirectWeightSyncSource]" = (
    weakref.WeakValueDictionary()
)


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
    # The address dests dial (the source's advertised one); None: by host.
    address: Optional[str] = None


@dataclass
class DeviceEntry:
    """One staged leaf of a device-mode publication: where it sits in the
    global tensor (``tensor_slice``), what it is (``spec``), and where it
    sits in the rank's staging (block ``block``, byte ``offset``)."""

    flat_key: str
    spec: dt.DeviceSpec
    tensor_slice: TensorSlice
    block: int
    offset: int


# --------------------------------------------------------------------------
# source side
# --------------------------------------------------------------------------


class _PeerReadServer:
    """Serves ranged reads of registered buffers, the generation and the
    device rung's control ops."""

    def __init__(self) -> None:
        self.buffers: dict[int, torch.Tensor] = {}
        self.gen_fn = lambda: 0
        # Set in device mode: () -> pickled IPC handles of the staging, and
        # () -> pickled {flat_key: [WeightHandle]} of its host copy.
        self.stage_device_fn = None
        self.stage_host_fn = None
        self._server: Optional[asyncio.AbstractServer] = None
        self.port: Optional[int] = None
        self.address: Optional[str] = None  # what dests dial (advertised)
        self._writers: set = set()

    async def ensure_started(self) -> int:
        if self._server is None:
            host = bind_host()
            self._server = await asyncio.start_server(self._handle, host, 0)
            self.port = self._server.sockets[0].getsockname()[1]
            self.address = advertise_host(host)
        return self.port

    async def _control(self, fn, in_thread: bool) -> Optional[bytes]:
        """Run a control op; a failure reaches the dest as a refusal."""
        if fn is None:
            return None
        try:
            if in_thread:  # copies a model: off the event loop
                return await asyncio.get_running_loop().run_in_executor(None, fn)
            return fn()
        except Exception:
            logger.exception("direct sync control op failed")
            return None

    async def _handle(self, reader, writer) -> None:
        # The peer proves it knows the store's secret before any staging
        # byte is served.
        if not await server_authenticate(reader, writer):
            await close_unauthenticated(writer)
            return
        self._writers.add(writer)
        try:
            while True:
                req = await reader.readexactly(_READ_REQ.size)
                buffer_id, offset, length = _READ_REQ.unpack(req)
                if buffer_id == _GET_GEN:
                    payload = _U64.pack(self.gen_fn())
                elif buffer_id == _STAGE_DEVICE:
                    payload = await self._control(self.stage_device_fn, False)
                elif buffer_id == _STAGE_HOST:
                    payload = await self._control(self.stage_host_fn, True)
                else:
                    buf = self.buffers.get(buffer_id)
                    payload = None if buf is None else tensor_bytes(buf)[offset : offset + length]
                if payload is None:
                    writer.write(_READ_RESP.pack(_ERR))
                else:
                    writer.write(_READ_RESP.pack(len(payload)))
                    writer.write(memoryview(payload))
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
    """(placement, local tensor) of a source leaf: a whole tensor, a
    ``Shard``'s data or a DTensor's local shard; None for a leaf the direct
    path leaves alone. A torch process holds one shard of each leaf, so
    this is the counterpart of the reference's ``_shards_of``."""
    if isinstance(value, Shard):
        if value.data is None:
            raise ValueError("direct sync moves Shard data; pass Shard(tensor, slice)")
        return value.tensor_slice, value.data
    if sharding.is_dtensor(value):
        return sharding.target_slice(value), sharding.local_tensor(value)
    if isinstance(value, torch.Tensor):
        return full_slice(tuple(value.shape)), value
    return None


def _target_region(value: Any) -> Optional[tuple[TensorSlice, Optional[torch.Tensor]]]:
    """(region, local tensor) of a pull target, the reference's
    ``_target_slices``: as ``_local_shard``, and a buffer-less ``Shard``
    (region only: the pull allocates it in the source's dtype)."""
    if isinstance(value, Shard) and value.data is None:
        return value.tensor_slice, None
    return _local_shard(value)


def device_rung_eligible(shards: dict, config: StoreConfig) -> bool:
    """The device rung engages when every tensor leaf (``_local_shard``'s
    value per flat key, None for the others) lives on a card,
    ``config.ici_enabled`` is set and CUDA is available."""
    if not config.ici_enabled or not dt.is_available():
        return False
    tensors = [s[1] for s in shards.values() if s is not None]
    return bool(tensors) and all(staging.card_of(t) is not None for t in tensors)


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


class DirectWeightSyncSource:
    """Registers a state dict's tensors into pull-able staging."""

    def __init__(
        self, use_shm: bool = True, config: Optional[StoreConfig] = None,
        device: Optional[bool] = None,
    ) -> None:
        self.use_shm = use_shm and shm.is_available()
        self.config = config or default_config()
        # None: the device rung when eligible; False pins the host rung.
        self.device = device
        self.server = _PeerReadServer()
        self.segments: dict[int, shm.ShmSegment] = {}
        self.handles: dict[str, list[WeightHandle]] = {}
        self._sources: dict[str, Any] = {}  # flat_key -> live leaf
        # flat_key -> (placement, staging): a host buffer, or a view of a
        # card's staging block in device mode.
        self._staged: dict[str, tuple[TensorSlice, torch.Tensor]] = {}
        self._transfer_dtype: Optional[torch.dtype] = None
        self._next_id = 0
        self._registered = False
        self._mapping: Optional[dict] = None
        self._flat_template: dict[str, Any] = {}
        # Device mode: the published info, one staging block per card, and
        # the host copy of the staging served to fallback dests (flat_key ->
        # buffer id), cached per content generation.
        self.device_info: Optional[dict] = None
        self._blocks: list[torch.Tensor] = []
        self._host_fallback_ids: dict[str, int] = {}
        self._host_fallback_lock = threading.Lock()
        self._staged_gen: Optional[int] = None
        self._staged_payload: Optional[bytes] = None
        self.host_materializations = 0
        # Held while the staging is overwritten (refresh) or read into the
        # host copy (a fallback's executor thread).
        self._stage_lock = threading.Lock()
        # Host pointers of the page-locked staging buffers, and the seconds
        # their registration took (it faults in every page).
        self._pinned: list[int] = []
        self.pin_seconds = 0.0
        # Weight generation (seqlock): _gen is even and moves +2 per
        # publish; the server reports _gen + 1 (odd) while an overwrite of
        # the staging runs, and from a refresh that failed after it began
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

    def _device_mode_eligible(self, shards: dict) -> bool:
        """Whether ``register`` takes the device rung (``device_rung_eligible``,
        unless ``device=False`` pinned the host rung)."""
        return self.device is not False and device_rung_eligible(shards, self.config)

    def _plan_stage(self, keys: list[str]) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """The (local value, staging) copies that write the current values
        of ``keys``, every leaf checked against its staging (kind,
        placement, shape, dtype, and in device mode its card) before any
        copy runs. Leaves that alias their staging need no copy."""
        copies = []
        for flat_key in keys:
            shard = _local_shard(self._sources[flat_key])
            ts, staged = self._staged[flat_key]
            if shard is None or shard[0] != ts:
                raise ValueError(
                    f"refresh of {flat_key!r}: the value is no longer the tensor or shard "
                    f"{ts} that was registered; re-register after changing a param's "
                    "sharding"
                )
            value = shard[1].detach()
            if _aliases(staged, value):
                # The trainer writes straight into the published staging
                # (staging_state_dict): nothing to copy.
                continue
            dtype = self._staged_dtype(value)
            if tuple(value.shape) != tuple(staged.shape) or dtype != staged.dtype:
                raise ValueError(
                    f"refresh of {flat_key!r}: value is now {tuple(value.shape)} "
                    f"{dtype} but {tuple(staged.shape)} {staged.dtype} was "
                    "registered; re-register after changing a param's shape or dtype"
                )
            if self.device_info is not None and value.device != staged.device:
                raise ValueError(
                    f"refresh of {flat_key!r}: value moved from {staged.device} to "
                    f"{value.device}; re-register after changing a param's placement"
                )
            copies.append((value, staged))
        return copies

    def _stage(self, copies: list[tuple[torch.Tensor, torch.Tensor]]) -> None:
        """Write values into their staging, cast where they live: a CPU
        leaf by the plain cast; the CUDA leaves of each card on one side
        stream, those that need the transfer dtype through ``cast_on_card``
        (the grouped kernel, one launch per chunk; pairs it does not cover
        by ``x.to()``), written by the kernel straight into card-side
        staging, or copied non-blocking into the page-locked host buffers;
        then one wait per card for its copies."""
        by_card: dict[torch.device, list[tuple[torch.Tensor, torch.Tensor]]] = {}
        for value, staged in copies:
            card = staging.card_of(value)
            if card is None:
                staged.copy_(cast_reference(value, staged.dtype))
            else:
                by_card.setdefault(card, []).append((value, staged))
        on_card = self.device_info is not None
        streams = []
        for card, items in by_card.items():
            with _D2HStream(card) as stream:
                to_cast = []
                for value, staged in items:
                    if value.dtype == staged.dtype:
                        staged.copy_(value, non_blocking=True)
                    else:
                        to_cast.append((value.contiguous(), staged))
                outs = [s for _, s in to_cast] if on_card else None
                for indices, cast in staging.cast_on_card(
                    [v for v, _ in to_cast], self._transfer_dtype, outs=outs
                ):
                    if not on_card:
                        for i, out in zip(indices, cast):
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
        keys = [k for k, s in shards.items() if s is not None]
        for flat_key in keys:
            self._sources[flat_key] = flat[flat_key]
        tracker = LatencyTracker("direct_register")
        if self._device_mode_eligible(shards):
            self._register_device(shards, keys, port, rank)
        else:
            self._register_host(shards, keys, port, rank)
        self._stage(self._plan_stage(keys))
        tracker.track_step("stage", sum(s.numel() * s.element_size()
                                        for _, s in self._staged.values()))
        tracker.log_summary(level=20)
        self._registered = True
        return self.handles

    def _register_host(self, shards: dict, keys: list[str], port: int, rank: int) -> None:
        """Host rung: one buffer per leaf, page-locked once here when a card
        copies into it."""
        pin = any(staging.card_of(shards[k][1]) is not None for k in keys)
        hostname = get_hostname()
        for flat_key in keys:
            ts, value = shards[flat_key]
            meta = TensorMeta(tuple(int(s) for s in value.shape),
                              dtype_name(self._staged_dtype(value)))
            buffer_id = self._next_id
            self._next_id += 1
            shm_name = None
            if self.use_shm:
                # A segment ``prewarm(direct=True)`` made ahead, else a new one.
                size = max(meta.nbytes, 1)
                seg = local_pool().take(size) or shm.ShmSegment.create(size)
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
            self.server.buffers[buffer_id] = staged
            self._staged[flat_key] = (ts, staged)
            self.handles[flat_key] = [
                WeightHandle(
                    buffer_id=buffer_id,
                    hostname=hostname,
                    port=port,
                    address=self.server.address,
                    shm_name=shm_name,
                    meta=meta,
                    tensor_slice=ts,
                    source_rank=rank,
                )
            ]

    def _register_device(self, shards: dict, keys: list[str], port: int, rank: int) -> None:
        """Device rung: one staging block per card, each leaf at an aligned
        offset in its card's block; no host staging, no handles."""
        layout: dict[torch.device, list[str]] = {}
        for flat_key in keys:
            layout.setdefault(shards[flat_key][1].device, []).append(flat_key)
        where: dict[str, tuple[int, int]] = {}
        for b, (card, card_keys) in enumerate(layout.items()):
            total = 0
            sizes = {}
            for flat_key in card_keys:
                value = shards[flat_key][1]
                sizes[flat_key] = value.numel() * _itemsize(self._staged_dtype(value))
                where[flat_key] = (b, total)
                total += -(-sizes[flat_key] // _ALIGN) * _ALIGN
            block = torch.empty(max(total, _ALIGN), dtype=torch.uint8, device=card)
            self._blocks.append(block)
            for flat_key in card_keys:
                ts, value = shards[flat_key]
                off = where[flat_key][1]
                view = block[off : off + sizes[flat_key]].view(self._staged_dtype(value))
                self._staged[flat_key] = (ts, view.view(value.shape))
        entries = [
            DeviceEntry(flat_key=k, spec=dt.DeviceSpec.of(self._staged[k][1]),
                        tensor_slice=self._staged[k][0], block=where[k][0], offset=where[k][1])
            for k in keys
        ]
        token = uuid.uuid4().hex
        self.server.stage_device_fn = self._export_device
        self.server.stage_host_fn = self._stage_host_handles
        self.device_info = {
            "address": dt.DeviceTransferEngine.get().ensure_server(),
            "hostname": get_hostname(),
            "control_port": port,
            "control_address": self.server.address,
            "pid": os.getpid(),
            "token": token,
            "keys": list(keys),
            "entries": entries,
            "source_rank": rank,
        }
        _local_sources[token] = self
        self.handles = {}
        logger.info("direct sync rank %d registered %d tensors in %d staging blocks on the "
                    "device rung", rank, len(keys), len(self._blocks))

    def _export_device(self) -> bytes:
        """The ``_STAGE_DEVICE`` reply: the registration's token and the
        IPC handles of its blocks (one export per request: torch counts
        one reference per export, which the opener releases)."""
        blocks = dt.DeviceTransferEngine.get().stage(self._blocks)
        return pickle.dumps({"token": self.device_info["token"], "blocks": blocks})

    def _stage_host_handles(self) -> bytes:
        """Copy the staging into host buffers and return pickled
        ``{flat_key: [WeightHandle]}`` serving them: for dests that cannot
        open the blocks. Runs on the server's executor. The copy is cached
        per content generation: concurrent fallback dests at one generation
        share one materialization, and it never moves the generation (it is
        reported odd while the host buffers are overwritten, so a dest still
        reading the previous copy retries)."""
        with self._host_fallback_lock, self._stage_lock:
            gen = self._read_gen()
            if self._staged_gen == gen and self._staged_payload is not None:
                return self._staged_payload
            self._set_busy(True)
            try:
                payload = self._materialize_host_handles()
            finally:
                self._set_busy(False)
            self._staged_gen, self._staged_payload = gen, payload
            return payload

    def _materialize_host_handles(self) -> bytes:
        """One device-to-host copy of every staged leaf into buffers reused
        across generations (``/dev/shm`` segments when shared memory is on,
        so dests of this host attach them)."""
        info = self.device_info
        handles: dict[str, list[WeightHandle]] = {}
        for flat_key in info["keys"]:
            ts, staged = self._staged[flat_key]
            meta = TensorMeta.of(staged)
            buffer_id = self._host_fallback_ids.get(flat_key)
            if buffer_id is None:
                buffer_id = self._host_fallback_ids[flat_key] = self._next_id
                self._next_id += 1
                if self.use_shm:
                    seg = shm.ShmSegment.create(max(meta.nbytes, 1))
                    self.segments[buffer_id] = seg
                    self.server.buffers[buffer_id] = seg.view(meta)
                else:
                    self.server.buffers[buffer_id] = torch.empty(meta.shape,
                                                                 dtype=meta.torch_dtype)
            self.server.buffers[buffer_id].copy_(staged)
            seg = self.segments.get(buffer_id)
            handles[flat_key] = [WeightHandle(
                buffer_id=buffer_id, hostname=info["hostname"], port=info["control_port"],
                address=info.get("control_address"), shm_name=None if seg is None else seg.name, meta=meta, tensor_slice=ts,
                source_rank=info["source_rank"],
            )]
        self.host_materializations += 1
        return pickle.dumps(handles)

    async def refresh(self) -> None:
        """Re-stage the current values into the registered staging. A leaf
        that no longer matches its staging raises before any of it is
        overwritten, and the generation stays as it was; a failure after
        the overwrite began leaves the generation odd until a refresh
        completes, so no pull takes the torn staging for a publish."""
        if not self._registered:
            raise RuntimeError("register() must run before refresh()")
        copies = self._plan_stage(list(self._sources))
        with self._stage_lock:
            self._set_busy(True)  # reported odd while the staging is overwritten
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
        """The registered staging in the original structure (a sharded leaf
        as a ``Shard`` of its staging; card-side in device mode): a trainer
        that writes its weights into it makes every later direct put
        copy-free."""
        if not self._registered or self._mapping is None:
            return None
        flat = dict(self._flat_template)
        for flat_key, (ts, buf) in self._staged.items():
            full = ts.is_full() and not ts.mesh_shape
            flat[flat_key] = buf if full else Shard(buf, ts)
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
        if self.device_info is not None:
            _local_sources.pop(self.device_info["token"], None)
        # Staging a dest still holds open stays allocated until the dest
        # lets go (torch's IPC reference counts); collect what is free.
        had_blocks = any(b.is_cuda for b in self._blocks)
        self._blocks.clear()
        self._staged.clear()
        self._staged_payload = None
        if had_blocks:
            torch.cuda.ipc_collect()
        # The server's callbacks make reference cycles: drop the live
        # leaves now, not when the cycle collector runs (they may be the
        # trainer's weights on a card).
        self._sources.clear()
        self.server.stage_device_fn = self.server.stage_host_fn = None


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


def _hkey(handle: WeightHandle) -> tuple:
    # Buffer ids are per-source counters: two ranks' buffers share ids.
    return handle.hostname, handle.port, handle.buffer_id


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
        # Set by preplan(); the first pull that reuses its plan counts a hit.
        self._preplanned = False
        # Device rung: the staging blocks opened over IPC, by registration.
        self._opened: dict[str, list[torch.Tensor]] = {}

    # ---- plan -------------------------------------------------------------

    def _build_plan(
        self, all_handles: dict[str, list[WeightHandle]], dest_flat: dict[str, Any]
    ) -> list[_TransferOp]:
        """One op per distinct intersection of each target's region with a
        source shard (replicated shards hold identical ones)."""
        plan: list[_TransferOp] = []
        for flat_key, target in dest_flat.items():
            landing = _target_region(target)
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
                if _target_region(v) is not None
            )
        )
        handle_sig = tuple(
            sorted(
                (k, tuple((h.buffer_id, h.port, h.tensor_slice) for h in v))
                for k, v in all_handles.items()
            )
        )
        return handle_sig, target_sig

    def _ensure_plan(self, all_handles: dict, dest_flat: dict) -> bool:
        """Build (or reuse) the plan; True when the cached plan was reused."""
        sig = self._plan_signature(all_handles, dest_flat)
        if self._plan is not None and self._plan_sig == sig:
            return True
        self._plan = self._build_plan(all_handles, dest_flat)
        self._plan_sig = sig
        return False

    @property
    def planned_ops(self) -> int:
        """Regions the last pull copied: one per distinct intersection."""
        return len(self._plan or ())

    async def preplan(self, all_handles: dict[str, list[WeightHandle]],
                      dest_state_dict: Any) -> dict:
        """Build and cache the transfer plan, dial each source once and
        attach its same-host segments, so the first pull pays only the data
        movement. A coverage error raises; a failed dial or attach does not
        (the pull dials and attaches lazily)."""
        dest_flat, _ = flatten_state_dict(dest_state_dict)
        reused = self._ensure_plan(all_handles, dest_flat)
        self._preplanned = True
        dials = dial_errors = attached = 0
        endpoints = sorted({_endpoint(h) for hs in all_handles.values() for h in hs})
        for host, port in endpoints:
            try:
                await self._get_conn(host, port)
                dials += 1
            except OSError:
                dial_errors += 1
        for handles in all_handles.values():
            for h in handles:
                if (h.shm_name is None or h.hostname != get_hostname()
                        or h.shm_name in self._segments):
                    continue
                try:
                    self._segments[h.shm_name] = shm.ShmSegment.attach(
                        h.shm_name, max(h.meta.nbytes, 1), populate=True)
                    attached += 1
                except OSError:
                    pass  # gone or re-registered: the pull resolves it
        return {"plan_ops": len(self._plan or ()), "plan_reused": reused, "dials": dials,
                "dial_errors": dial_errors, "segments_attached": attached}

    # ---- pull (host rung) -------------------------------------------------

    async def pull(
        self,
        all_handles: dict[str, list[WeightHandle]],
        dest_state_dict: Any,
        key_order: Optional[list] = None,
        on_layer=None,
    ) -> Any:
        """Pull every planned region into the dest tensors, validated
        against concurrent source refreshes: the generations are read
        before and after the data moves (after the copies to the cards have
        completed), and a pull that a refresh tore is retried once (a retry
        overwrites every landing).

        ``key_order`` pulls key by key in that order (keys it leaves out
        after it), calling ``on_layer(flat_key, value)`` (sync or async) as
        each lands. The generations are checked at the end: a consumer
        treats served keys as tentative until the pull returns (a torn pull
        serves every key again)."""
        endpoints = sorted({_endpoint(h) for hs in all_handles.values() for h in hs})
        for _ in (0, 1):
            gens0 = await self._stable_gens(endpoints)
            result = await self._pull_once(all_handles, dest_state_dict, key_order, on_layer)
            gens1 = list(await asyncio.gather(*(self._read_gen(h, p) for h, p in endpoints)))
            if gens1 == gens0:
                return result
            PULL_RETRIES.inc()
            logger.info("direct pull raced a source refresh (%s -> %s); retrying", gens0, gens1)
        raise PullRaceError(
            "direct pull torn twice by concurrent source refreshes: throttle "
            "publishes or pull between refreshes"
        )

    async def _read_gen(self, host: str, port: int) -> int:
        (gen,) = _U64.unpack(await self._control_op(host, port, _GET_GEN))
        return gen

    async def _stable_gens(self, endpoints) -> list:
        """Every source's generation once none is mid-overwrite (odd),
        waiting at most ``config.direct_settle_timeout``."""
        timeout = default_config().direct_settle_timeout
        deadline = time.monotonic() + timeout
        delay = 0.02
        while True:
            gens = list(await asyncio.gather(*(self._read_gen(h, p) for h, p in endpoints)))
            if all(g % 2 == 0 for g in gens):
                return gens
            if time.monotonic() >= deadline:
                raise PullRaceError(
                    f"source refresh never settled (generation odd for {timeout:.0f}s)"
                )
            await asyncio.sleep(delay)
            delay = min(delay * 1.5, 0.25)

    async def _pull_once(self, all_handles: dict, dest_state_dict: Any,
                         key_order: Optional[list] = None, on_layer=None) -> Any:
        tracker = LatencyTracker("direct_pull")
        dest_flat, mapping = flatten_state_dict(dest_state_dict)
        if self._ensure_plan(all_handles, dest_flat) and self._preplanned:
            PLAN_PREWARM_HITS.inc()
            self._preplanned = False
        tracker.track_step("plan")
        # Landing buffer per target: its (local) tensor when contiguous
        # (ops write straight into destination memory), else a contiguous
        # stand-in copied back at the end; a buffer-less Shard lands in a
        # new host tensor of the source's dtype.
        landings: dict[str, tuple[TensorSlice, torch.Tensor]] = {}
        cards: dict[str, torch.device] = {}
        for flat_key, target in dest_flat.items():
            region = _target_region(target)
            if region is None:
                continue
            want, local = region
            if local is None:
                buf = torch.empty(want.local_shape,
                                  dtype=all_handles[flat_key][0].meta.torch_dtype)
            elif local.is_contiguous():
                buf = local
            else:
                buf = torch.empty_like(local, memory_format=torch.contiguous_format)
            landings[flat_key] = (want, buf)
            card = staging.card_of(buf)
            if card is not None:
                cards[flat_key] = card
        by_handle: dict[tuple, tuple[WeightHandle, list[_TransferOp]]] = {}
        for op in self._plan:
            by_handle.setdefault(_hkey(op.handle), (op.handle, []))[1].append(op)
        rows = {hk: _row_range(handle, ops) for hk, (handle, ops) in by_handle.items()}
        # Attachments a card copies out of are page-locked once, when first
        # attached; the copies to the cards are then issued non-blocking.
        pin = bool(cards)
        out_flat = dict(dest_flat)

        def land(flat_key: str) -> Any:
            """The key's result, its stand-in copied back."""
            target = dest_flat[flat_key]
            buf = landings[flat_key][1]
            local = _target_region(target)[1]
            if local is None:
                return buf  # a buffer-less Shard: the pulled region
            if buf is not local:
                local.copy_(buf)
            return target.data if isinstance(target, Shard) else target

        nbytes = 0
        served: set[str] = set()
        if key_order is not None or on_layer is not None:
            # Ordered waves: each key's reads and copies complete before the
            # next key starts; a shard feeding several keys is read once.
            ops_by_key: dict[str, list[_TransferOp]] = {}
            for op in self._plan:
                ops_by_key.setdefault(op.flat_key, []).append(op)
            order = [k for k in (key_order or []) if k in ops_by_key]
            seen = set(order)
            reads: dict[tuple, tuple[torch.Tensor, int]] = {}
            for flat_key in order + [k for k in ops_by_key if k not in seen]:
                need = list(dict.fromkeys(_hkey(op.handle) for op in ops_by_key[flat_key]
                                          if _hkey(op.handle) not in reads))
                got = await asyncio.gather(
                    *(self._read_shard(by_handle[hk][0], pin, rows[hk]) for hk in need))
                for hk, read in zip(need, got):
                    reads[hk] = read
                    nbytes += read[0].numel() * read[0].element_size()
                for op in ops_by_key[flat_key]:
                    self._apply_op(op, *reads[_hkey(op.handle)], landings, non_blocking=pin)
                out_flat[flat_key] = land(flat_key)
                served.add(flat_key)
                if on_layer is not None:
                    if flat_key in cards:
                        _synchronize(cards[flat_key])
                    await maybe_await(on_layer(flat_key, out_flat[flat_key]))
        else:
            got = await asyncio.gather(
                *(self._read_shard(handle, pin, rows[hk]) for hk, (handle, _) in by_handle.items()))
            for (_, ops), (arr, row0) in zip(by_handle.values(), got):
                nbytes += arr.numel() * arr.element_size()
                for op in ops:
                    self._apply_op(op, arr, row0, landings, non_blocking=pin)
        tracker.track_step("reads", nbytes)
        for flat_key in landings.keys() - served:
            out_flat[flat_key] = land(flat_key)
        for card in set(cards.values()):
            _synchronize(card)
        tracker.track_step("land")
        tracker.log_summary(level=20)
        return unflatten_state_dict(out_flat, mapping)

    @staticmethod
    def _apply_op(op: _TransferOp, shard: torch.Tensor, row0: int, landings,
                  non_blocking: bool) -> None:
        """Copy the part of ``shard`` (rows ``row0`` on of the handle's
        buffer) that the op covers into its place in the landing."""
        want, buf = landings[op.flat_key]
        inter = op.region
        rel_src = tuple(
            slice(o - so - (row0 if d == 0 else 0), o - so - (row0 if d == 0 else 0) + s)
            for d, (o, so, s) in enumerate(
                zip(inter.offsets, op.handle.tensor_slice.offsets, inter.shape))
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
                    asyncio.open_connection(host, port),
                    timeout=default_config().handshake_timeout,
                )
                try:
                    await client_authenticate(reader, writer)
                except BaseException:
                    writer.close()
                    raise
                conn = (reader, writer, asyncio.Lock())
                pool["conns"].append(conn)
            else:
                conn = pool["conns"][pool["rr"] % len(pool["conns"])]
                pool["rr"] += 1
        return conn

    async def _drop_conns(self, host: str, port: int) -> None:
        async with self._lock:
            pool = self._conns.pop((host, port), None)
        for _, writer, _ in (pool or {}).get("conns", ()):
            writer.close()

    async def _control_op(self, host: str, port: int, opcode: int) -> bytes:
        """One control op against a source's peer server (dialed at
        ``host``). A source that refuses it, or is gone (closed,
        restarted), raises ``KeyError``."""
        try:
            reader, writer, lock = await self._get_conn(host, port)
            async with lock:
                writer.write(_READ_REQ.pack(opcode, 0, 0))
                await writer.drain()
                (length,) = _READ_RESP.unpack(await reader.readexactly(_READ_RESP.size))
                if length == _ERR:
                    raise KeyError(f"source refused control op {opcode:#x} (see its log)")
                return await reader.readexactly(length)
        except (asyncio.IncompleteReadError, ConnectionError, OSError) as exc:
            await self._drop_conns(host, port)
            raise KeyError(f"direct-sync source at {host}:{port} is gone: {exc!r}") from exc

    async def _read_shard(self, handle: WeightHandle, pin: bool = False,
                          row_range: Optional[tuple[int, int]] = None
                          ) -> tuple[torch.Tensor, int]:
        """One-hop read of a source buffer, as (rows, first row): a
        shared-memory attach on the same host (the whole buffer; page-locked
        once when ``pin``), else a TCP read of the rows ``row_range`` names
        (all without one)."""
        shape = handle.meta.shape
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
            return view, 0
        if row_range is not None:
            r0, r1 = row_range
            row_bytes = handle.meta.nbytes // shape[0]
            offset, want_len = r0 * row_bytes, (r1 - r0) * row_bytes
            out_shape = (r1 - r0,) + tuple(shape[1:])
        else:
            r0, offset, want_len, out_shape = 0, 0, handle.meta.nbytes, tuple(shape)
        reader, writer, lock = await self._get_conn(*_endpoint(handle))
        async with lock:
            writer.write(_READ_REQ.pack(handle.buffer_id, offset, want_len))
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
        if length != want_len:
            raise ConnectionError(
                f"source sent {length} of {want_len} bytes of buffer {handle.buffer_id}"
            )
        if length == 0:
            return torch.empty(out_shape, dtype=handle.meta.torch_dtype), r0
        arr = torch.frombuffer(raw, dtype=torch.uint8).view(handle.meta.torch_dtype)
        return arr.reshape(out_shape), r0

    # ---- pull (device rung) -----------------------------------------------

    def _route(self, info: dict) -> str:
        """How this process reaches one rank's staging: ``local`` (the
        source is in this process), ``ipc`` (every block's card is visible
        here) or ``host`` (another host, or a card this process cannot
        open)."""
        if info["hostname"] != get_hostname():
            return "host"
        local = info["pid"] == os.getpid() and info["token"] in _local_sources
        for entry in info["entries"]:
            card = entry.spec.placement.card
            if dt.card_index(card) is None and not (local and card == dt.HOST_CARD):
                return "host"
        return "local" if local else "ipc"

    async def pull_device(self, device_infos: list[dict], dest_state_dict: Any) -> Any:
        """One-hop pull of every source rank's card-side staging into the
        dest targets (tensors, ``Shard`` targets, DTensors' local tensors;
        on a card or the host), assembled region by region with torch
        slicing and ``copy_``. The generations are read before and after
        the copies (after every card involved finished them); a torn pull,
        or one that mixed the ranks' generations, is retried once. A rank
        this process cannot reach card to card sends the whole pull to the
        ranks' host staging (``_STAGE_HOST``) and the host rung."""
        routes = [self._route(info) for info in device_infos]
        if "host" in routes:
            DEVICE_FALLBACKS.inc()
            logger.warning(
                "device rung unavailable for %d of %d source ranks (another host, or a card "
                "this process cannot open); pulling from their host staging",
                routes.count("host"), len(routes))
            fetched = await asyncio.gather(*(self._fetch_host_handles(i) for i in device_infos))
            all_handles: dict[str, list[WeightHandle]] = {}
            for rank_handles in fetched:
                for flat_key, handles in rank_handles.items():
                    all_handles.setdefault(flat_key, []).extend(handles)
            return await self.pull(all_handles, dest_state_dict)
        tokens = {info["token"] for info in device_infos}
        self._opened = {t: b for t, b in self._opened.items() if t in tokens}
        tracker = LatencyTracker("direct_pull_device")
        dest_flat, mapping = flatten_state_dict(dest_state_dict)
        endpoints = [_info_endpoint(info) for info in device_infos]
        for _ in (0, 1):
            gens0 = await self._stable_gens(endpoints)
            parts_by_key: dict[str, list[tuple[TensorSlice, torch.Tensor]]] = {}
            nbytes = 0
            for info, route in zip(device_infos, routes):
                blocks = await self._device_blocks(info, route)
                for entry in info["entries"]:
                    view = _entry_view(blocks[entry.block], entry)
                    parts_by_key.setdefault(entry.flat_key, []).append((entry.tensor_slice, view))
                    nbytes += view.numel() * view.element_size()
            tracker.track_step("open")
            out_flat = dict(dest_flat)
            devices: set[torch.device] = set()
            for flat_key, target in dest_flat.items():
                region = _target_region(target)
                if region is None:
                    continue
                parts = parts_by_key.get(flat_key)
                if parts is None:
                    raise KeyError(f"dest state dict expects {flat_key!r} but no source "
                                   "rank published a device entry for it")
                out_flat[flat_key] = _assemble_device(flat_key, target, *region, parts, devices)
            for device in devices:
                _synchronize(device)
            tracker.track_step("land", nbytes)
            gens1 = list(await asyncio.gather(*(self._read_gen(h, p) for h, p in endpoints)))
            tracker.track_step("generation")
            if gens1 == gens0 and len(set(gens0)) <= 1:
                for route in set(routes):
                    (DEVICE_LOCAL_PULLS if route == "local" else DEVICE_IPC_PULLS).inc()
                tracker.log_summary(level=20)
                return unflatten_state_dict(out_flat, mapping)
            PULL_RETRIES.inc()
            logger.info("device pull raced a source refresh or mixed the ranks' generations "
                        "(%s -> %s); retrying", gens0, gens1)
        raise PullRaceError(
            "device pull torn twice by source refreshes, or the source ranks publish out "
            "of lockstep"
        )

    async def _device_blocks(self, info: dict, route: str) -> list[torch.Tensor]:
        """One rank's staging blocks: the tensors themselves in the
        source's process, else its IPC export opened here (once per
        registration; later exports of the same blocks are released at
        once)."""
        if route == "local":
            source = _local_sources.get(info["token"])
            if source is None:
                raise KeyError(f"direct-sync source rank {info['source_rank']} was closed")
            return source._blocks
        payload = pickle.loads(await self._control_request(info, _STAGE_DEVICE))
        token = payload["token"]
        if token != info["token"]:
            raise KeyError(f"source rank {info['source_rank']} re-registered; re-resolve")
        blocks = dt.DeviceTransferEngine.get().pull(payload["blocks"],
                                                    fresh=token not in self._opened)
        self._opened[token] = blocks
        return blocks

    async def _control_request(self, device_info: dict, opcode: int) -> bytes:
        return await self._control_op(*_info_endpoint(device_info), opcode)

    async def _fetch_host_handles(self, device_info: dict) -> dict[str, list[WeightHandle]]:
        """Ask one source rank to copy its staging to host buffers; returns
        the WeightHandles serving them."""
        return pickle.loads(await self._control_request(device_info, _STAGE_HOST))

    async def close(self) -> None:
        async with self._lock:
            for pool in self._conns.values():
                for _, writer, _ in pool["conns"]:
                    writer.close()
            self._conns.clear()
        host_unregister(self._pinned.values())  # before the mappings go
        self._pinned.clear()
        self._segments.clear()
        self._opened.clear()  # releases the IPC mappings


# --------------------------------------------------------------------------
# helpers shared by plan and pull
# --------------------------------------------------------------------------


def _dial_host(hostname: str, address: Optional[str] = None) -> str:
    """The address a dest dials to reach a source: the one the source
    advertised (its bind address, or ``ADVERTISE_HOST``); for a source
    that advertised none, loopback on the same host, else its hostname."""
    if address:
        return address
    return "127.0.0.1" if hostname == get_hostname() else hostname


def _endpoint(handle: WeightHandle) -> tuple[str, int]:
    return _dial_host(handle.hostname, handle.address), handle.port


def _info_endpoint(info: dict) -> tuple[str, int]:
    return _dial_host(info["hostname"], info.get("control_address")), info["control_port"]


def _row_range(handle: WeightHandle, ops: list[_TransferOp]) -> Optional[tuple[int, int]]:
    """Shard-local dim-0 row range covering every op, or None for a full
    read. Ranging applies only when each op's region spans the shard's full
    extent in every trailing dim (the rows are then one contiguous byte
    range of the buffer)."""
    ts = handle.tensor_slice
    if not ts.local_shape:
        return None
    lo = hi = None
    for op in ops:
        for d in range(1, len(ts.local_shape)):
            if op.region.offsets[d] != ts.offsets[d] or op.region.shape[d] != ts.local_shape[d]:
                return None
        r0 = op.region.offsets[0] - ts.offsets[0]
        r1 = r0 + op.region.shape[0]
        lo = r0 if lo is None else min(lo, r0)
        hi = r1 if hi is None else max(hi, r1)
    if lo == 0 and hi == ts.local_shape[0]:
        return None  # the whole shard anyway
    return lo, hi


def _entry_view(block: torch.Tensor, entry: DeviceEntry) -> torch.Tensor:
    """The staged leaf ``entry`` names, as a view of its block."""
    spec = entry.spec
    dtype = getattr(torch, spec.dtype)
    nbytes = math.prod(spec.shape) * _itemsize(dtype)
    return block[entry.offset : entry.offset + nbytes].view(dtype).view(spec.shape)


def _assemble_device(flat_key: str, target: Any, want: TensorSlice,
                     local: Optional[torch.Tensor], parts: list, devices: set) -> Any:
    """Land the staged parts of one leaf (one per source rank, or several)
    into the target's region: each overlap sliced out of its part and
    copied in place into the target's tensor (a DTensor's local tensor, a
    ``Shard``'s data, or a new tensor on the part's card for a buffer-less
    ``Shard``), casting where the dtypes differ. Coverage is checked by
    exact box union: overlapping or replicated parts cannot mask a hole."""
    deduped: dict[tuple, tuple[TensorSlice, torch.Tensor]] = {}
    for ts, view in parts:
        deduped.setdefault((ts.offsets, ts.local_shape), (ts, view))
    parts = list(deduped.values())
    global_shape = parts[0][0].global_shape
    if global_shape != want.global_shape:
        raise ValueError(f"pulled global shape {global_shape} != target shape "
                         f"{want.global_shape} for {flat_key!r}")
    if not boxes_cover(Box((0,) * len(global_shape), global_shape), [ts.box for ts, _ in parts]):
        raise ValueError(f"source ranks do not cover all of {flat_key!r} {global_shape}: "
                         "missing regions would read as garbage")
    if local is None:
        local = torch.empty(want.local_shape, dtype=parts[0][1].dtype, device=parts[0][1].device)
    touched = []
    for ts, view in parts:
        inter = intersect_boxes(ts.box, want.box)
        if inter is None:
            continue
        rel = tuple(slice(o - so, o - so + s)
                    for o, so, s in zip(inter.offsets, ts.offsets, inter.shape))
        dst = get_destination_view(local, want.box, inter, require_contiguous=False)
        dst.copy_(view[rel], non_blocking=dst.is_cuda)
        touched.append(inter)
        devices.update(t.device for t in (view, dst) if t.is_cuda)
    if not boxes_cover(want.box, touched):
        raise ValueError(f"source ranks do not cover region {want.box} of {flat_key!r}")
    if isinstance(target, Shard):
        return local
    return target
