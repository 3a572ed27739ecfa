"""RPC transport: payloads ride the actor-RPC frames.

Port of ``torchstore_tpu/transport/rpc.py``, the rung that always works.
CPU tensors travel as out-of-band pickle buffers; a CUDA tensor is staged
to the host before the frame is written (frames refuse device tensors).
"""

from __future__ import annotations

from typing import Any

import torch

from torchstore_tpu_torch.transport.buffers import TransportBuffer, TransportContext, land
from torchstore_tpu_torch.transport.types import Request


class RPCTransportBuffer(TransportBuffer):
    transport_name = "rpc"

    def __init__(self) -> None:
        # index -> payload; filled by the client on put, by the volume on get.
        self.tensors: dict[int, torch.Tensor] = {}
        self.objects: dict[int, Any] = {}

    # ---- client ----------------------------------------------------------

    async def _pre_put_hook(self, volume, requests: list[Request]) -> None:
        for idx, req in enumerate(requests):
            if req.is_object:
                self.objects[idx] = req.objects
            else:
                # Device-to-host staging for CUDA payloads; CPU ones ride as is.
                self.tensors[idx] = req.tensor_val.detach().to("cpu").contiguous()

    def _handle_storage_volume_response(
        self, volume, remote: "RPCTransportBuffer", requests: list[Request]
    ) -> list[Any]:
        results: list[Any] = []
        for idx, req in enumerate(requests):
            if idx in remote.objects:
                results.append(remote.objects[idx])
            else:
                results.append(land(req.destination_view, remote.tensors[idx]))
        return results

    def drop(self) -> None:
        self.tensors = {}
        self.objects = {}

    # ---- server ----------------------------------------------------------

    def handle_put_request(
        self, ctx: TransportContext, metas: list[Request], existing: dict[int, Any]
    ) -> dict[int, Any]:
        out: dict[int, Any] = dict(self.objects)
        out.update(self.tensors)  # already private copies: they were framed
        return out

    def handle_get_request(
        self, ctx: TransportContext, metas: list[Request], entries: list[Any]
    ) -> None:
        for idx, (meta, entry) in enumerate(zip(metas, entries)):
            if meta.is_object:
                self.objects[idx] = entry
            else:
                self.tensors[idx] = entry.part()  # the frame carries only the part's bytes
