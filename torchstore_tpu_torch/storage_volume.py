"""Storage volume actor: an in-memory key -> tensor/object store.

Port of the ``put``/``get``/``get_meta``/``delete_batch`` endpoints of
``torchstore_tpu/storage_volume.py`` over an in-memory dict of whole
tensors and objects. Sharded entries (``TensorSlice`` keys), tiering, the
one-sided planes and the health and repair endpoints are later work.
"""

from __future__ import annotations

import os
from typing import Any, Optional

from torchstore_tpu_torch.runtime import Actor, endpoint
from torchstore_tpu_torch.transport import shared_memory
from torchstore_tpu_torch.transport.buffers import TransportBuffer, TransportContext
from torchstore_tpu_torch.transport.types import Request, TensorMeta
from torchstore_tpu_torch.utils import get_hostname, maybe_await


class StorageVolume(Actor):
    def __init__(self, strategy) -> None:
        self.volume_id = str(strategy.get_volume_id())
        self.store: dict[str, Any] = {}
        self.ctx = TransportContext()
        if shared_memory.is_available():
            # Crashed processes leave segments behind; sweep before serving.
            shared_memory.reap_orphaned_segments()

    @endpoint
    async def get_id(self) -> dict:
        return {"volume_id": self.volume_id, "hostname": get_hostname(), "pid": os.getpid()}

    @endpoint
    async def put(self, buffer: TransportBuffer, metas: list[Request]) -> Any:
        existing = {
            idx: self.store[m.key] for idx, m in enumerate(metas) if m.key in self.store
        }
        values = await maybe_await(buffer.handle_put_request(self.ctx, metas, existing))
        for idx, meta in enumerate(metas):
            self.store[meta.key] = values[idx]
        return buffer.put_reply()

    @endpoint
    async def get(self, buffer: TransportBuffer, metas: list[Request]) -> TransportBuffer:
        entries = [self._entry(meta.key) for meta in metas]
        await maybe_await(buffer.handle_get_request(self.ctx, metas, entries))
        return buffer

    @endpoint
    async def get_meta(self, metas: list[Request]) -> list[Optional[TensorMeta]]:
        """Shape and dtype of each stored tensor (None for objects)."""
        out = []
        for meta in metas:
            entry = self._entry(meta.key)
            out.append(None if meta.is_object else TensorMeta.of(entry))
        return out

    @endpoint
    async def delete_batch(self, keys: list[str]) -> int:
        """Idempotent: missing keys are ignored so cleanup retries are safe."""
        deleted = 0
        for key in keys:
            if self.store.pop(key, None) is not None:
                deleted += 1
            self.ctx.delete_key(key)
        return deleted

    @endpoint
    async def reset(self) -> None:
        self.store.clear()
        self.ctx.clear()

    async def on_stop(self) -> None:
        self.store.clear()
        self.ctx.clear()  # unlinks every segment this volume owns

    def _entry(self, key: str) -> Any:
        try:
            return self.store[key]
        except KeyError:
            raise KeyError(f"key {key!r} not found on volume {self.volume_id}") from None
