"""Transport buffer contract and per-side transport caches.

Port of ``torchstore_tpu/transport/buffers.py``. One buffer object carries
one request batch between a client and a volume; the lifecycle makes
transports pluggable:

    client                                 server (storage volume)
    ------                                 -----------------------
    [_pre_handshake
     volume.handshake(buffer, metas, op) ─▶ recv_handshake
     _post_handshake(reply)]  ◀───────────── (offers, e.g. pooled segments)
    _pre_put_hook / _pre_get_hook
    volume.put/get(buffer, metas) ──RPC──▶ handle_put_request /
                                           handle_get_request
    _handle_put_reply /
    _handle_storage_volume_response ◀────── (buffer rides the response)
    drop() in finally

The handshake runs only for the ops a transport names in
``handshake_ops`` when it ``requires_handshake``: the shared-memory rung
asks the volume for warm segments before it copies a put. The buffer is
pickled into the RPC both ways; each implementation strips its
client-only state in ``__getstate__``.
"""

from __future__ import annotations

import time
from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Optional

import torch

from torchstore_tpu_torch.observability import metrics as obs_metrics
from torchstore_tpu_torch.observability import recorder as obs_recorder
from torchstore_tpu_torch.observability.tracing import span
from torchstore_tpu_torch.transport.types import Request
from torchstore_tpu_torch.utils import maybe_await

if TYPE_CHECKING:
    from torchstore_tpu_torch.strategy import StorageVolumeRef

# Per-transport instruments of the client side, by rung and op.
_OPS = obs_metrics.counter("ts_transport_ops_total", "Data-plane transfers by transport and op")
_BYTES = obs_metrics.counter(
    "ts_transport_bytes_total", "Logical payload bytes handed to / received from each transport"
)
_ERRORS = obs_metrics.counter("ts_transport_errors_total", "Failed transfers by transport and op")
_OP_SECONDS = obs_metrics.histogram(
    "ts_transport_op_seconds", "Wall time of one transfer by transport and op"
)

# Data-plane RPCs carry (or wait on) tensor bytes: their deadline grows with
# the payload, at a conservative floor rate.
MIN_TRANSFER_RATE_BPS = 50e6


def transfer_timeout(base: Optional[float], nbytes: int) -> Optional[float]:
    if base is None or base <= 0:
        return base  # deadlines disabled
    return base + nbytes / MIN_TRANSFER_RATE_BPS


@dataclass
class Served:
    """A volume's answer to one tensor request: the stored tensor, the key
    its transport cache knows it by ((key, coordinates), coordinates None
    for a whole tensor), and the index of the wanted part in it (None: the
    whole tensor). Transports return only that part."""

    tensor: torch.Tensor
    cache_key: tuple
    index: Optional[tuple] = None

    def part(self) -> torch.Tensor:
        return self.tensor if self.index is None else self.tensor[self.index]


class TransportCache:
    """Base of the per-volume caches a transport keeps on either side."""

    def delete_key(self, key: str) -> None:  # noqa: B027 - optional hook
        pass

    def clear(self) -> None:  # noqa: B027 - optional hook
        pass


class TransportContext:
    """Type-keyed lazy registry of ``TransportCache`` instances: one per
    client, and one per storage volume."""

    def __init__(self) -> None:
        self._caches: dict[type, TransportCache] = {}

    def get_cache(self, cache_cls: type) -> Any:
        cache = self._caches.get(cache_cls)
        if cache is None:
            cache = cache_cls()
            self._caches[cache_cls] = cache
        return cache

    def peek(self, cache_cls: type) -> Any:
        """The cache of ``cache_cls`` if one was made, without making one."""
        return self._caches.get(cache_cls)

    def delete_key(self, key: str) -> None:
        for cache in self._caches.values():
            cache.delete_key(key)

    def clear(self) -> None:
        for cache in self._caches.values():
            cache.clear()
        self._caches.clear()


class TransportBuffer(ABC):
    """One instance per request batch; drives the lifecycle above and
    releases staged resources in ``drop()`` on success and failure."""

    transport_name: str = "unknown"
    requires_handshake: bool = False
    # The ops that pay the handshake RPC when ``requires_handshake``: a
    # put's (a get's answer describes itself).
    handshake_ops: tuple = ("put",)
    # Per-key write generations the volume gave the last put this buffer
    # carried.
    write_gens: Optional[dict[str, int]] = None

    # ---- client side -----------------------------------------------------

    async def put_to_storage_volume(
        self, volume: "StorageVolumeRef", requests: list[Request]
    ) -> None:
        for req in requests:
            if not req.is_object and req.tensor_val is None:
                raise ValueError(f"put of key {req.key!r} carries no tensor data")
        nbytes = sum(r.nbytes for r in requests)
        t0 = time.perf_counter()
        try:
            with span("transport.put", transport=self.transport_name, volume=volume.volume_id,
                      keys=len(requests), nbytes=nbytes):
                if self.requires_handshake and "put" in self.handshake_ops:
                    await self._perform_handshake(volume, requests, op="put")
                await self._pre_put_hook(volume, requests)
                metas = [r.meta_only() for r in requests]
                put = volume.actor.put
                reply = await put.with_timeout(
                    transfer_timeout(put.effective_timeout(), nbytes)
                ).call_one(self, metas)
                self.write_gens = reply["write_gens"]
                self._handle_put_reply(volume, reply["reply"], requests)
            self._count("put", nbytes, t0, volume, len(requests))
        except BaseException as exc:
            self._count_error("put", volume, exc)
            raise
        finally:
            self.drop()

    async def get_from_storage_volume(
        self, volume: "StorageVolumeRef", requests: list[Request]
    ) -> list[Any]:
        t0 = time.perf_counter()
        try:
            with span("transport.get", transport=self.transport_name, volume=volume.volume_id,
                      keys=len(requests)) as sp:
                await self._pre_get_hook(volume, requests)
                metas = [r.meta_only() for r in requests]
                nbytes = sum(m.tensor_meta.nbytes for m in metas if m.tensor_meta is not None)
                sp.set(nbytes=nbytes)
                get = volume.actor.get
                remote = await get.with_timeout(
                    transfer_timeout(get.effective_timeout(), nbytes)
                ).call_one(self, metas)
                results = await maybe_await(
                    self._handle_storage_volume_response(volume, remote, requests)
                )
            self._count("get", nbytes, t0, volume, len(requests))
            return results
        except BaseException as exc:
            self._count_error("get", volume, exc)
            raise
        finally:
            self.drop()

    def _count(self, op: str, nbytes: int, t0: float, volume, keys: int) -> None:
        _OPS.inc(transport=self.transport_name, op=op)
        _BYTES.inc(nbytes, transport=self.transport_name, op=op)
        _OP_SECONDS.observe(time.perf_counter() - t0, transport=self.transport_name, op=op)
        obs_recorder.record("transfer", f"{op}/{self.transport_name}",
                            volume=volume.volume_id, keys=keys, nbytes=nbytes)

    def _count_error(self, op: str, volume, exc: BaseException) -> None:
        _ERRORS.inc(transport=self.transport_name, op=op)
        obs_recorder.record("error", f"{op}/{self.transport_name}", volume=volume.volume_id,
                            error=f"{type(exc).__name__}: {exc}"[:200])

    async def _perform_handshake(
        self, volume: "StorageVolumeRef", requests: list[Request], op: str
    ) -> None:
        self._pre_handshake(volume, requests, op)
        metas = [r.meta_only() for r in requests]
        from torchstore_tpu_torch.config import default_config

        # A buffer that carries the caller's config (shm) takes its timeout.
        config = getattr(self, "config", None) or default_config()
        reply = await volume.actor.handshake.with_timeout(config.handshake_timeout).call_one(
            self, metas, op
        )
        await maybe_await(self._post_handshake(volume, requests, reply, op))

    def _pre_handshake(self, volume, requests, op) -> None:  # noqa: B027
        pass

    def _post_handshake(self, volume, requests, reply, op) -> Any:  # noqa: B027
        """Act on the volume's handshake reply (may be a coroutine)."""

    async def _pre_put_hook(self, volume, requests) -> None:  # noqa: B027
        pass

    async def _pre_get_hook(self, volume, requests) -> None:  # noqa: B027
        pass

    def _handle_put_reply(self, volume, reply, requests) -> None:  # noqa: B027
        """Process the volume's small put reply (``put_reply()``)."""

    @abstractmethod
    def _handle_storage_volume_response(
        self, volume, remote: "TransportBuffer", requests: list[Request]
    ) -> list[Any]:
        """Land fetched data into each request's ``destination_view`` when
        it has one, else return fresh tensors, in request order."""

    def drop(self) -> None:  # noqa: B027
        """Release staged resources; safe to call more than once."""

    # ---- server side (inside the storage-volume process) -----------------

    def recv_handshake(
        self, ctx: TransportContext, metas: list[Request], existing: dict[int, Any], op: str
    ) -> Any:
        """The volume's side of the handshake; returns a small picklable
        reply."""
        return None

    @abstractmethod
    def handle_put_request(
        self, ctx: TransportContext, metas: list[Request], existing: dict[int, Any]
    ) -> dict[int, Any]:
        """Materialize incoming data: {request index: tensor or object} for
        the store to keep. ``existing`` maps request index to the entry the
        store holds now."""

    def put_reply(self) -> Any:
        """Small picklable reply returned with the put RPC."""
        return None

    @abstractmethod
    def handle_get_request(
        self, ctx: TransportContext, metas: list[Request], entries: list[Any]
    ) -> None:
        """Load outgoing data into this buffer: per request (in order) an
        object, or the ``Served`` part of a stored tensor."""


def land(dest: Optional[torch.Tensor], src: torch.Tensor) -> torch.Tensor:
    """Copy ``src`` into ``dest`` when given (CPU or CUDA; shapes must
    match exactly), else return ``src``."""
    if dest is None:
        return src
    if tuple(dest.shape) != tuple(src.shape):
        raise ValueError(
            f"destination shape {tuple(dest.shape)} != fetched {tuple(src.shape)}"
        )
    dest.copy_(src)
    return dest
