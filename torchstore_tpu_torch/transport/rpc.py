"""RPC transport: payloads ride the actor-RPC frames.

Port of ``torchstore_tpu/transport/rpc.py``, the rung that always works.
CPU tensors travel as out-of-band pickle buffers; a CUDA tensor is staged
to the host before the frame is written (frames refuse device tensors).
A colocated volume's endpoints are called without serialization, so with
``inproc_copy`` the volume copies what it stores and what it serves, as the
frames would have.
"""

from __future__ import annotations

import copy
from typing import Any

import torch

from torchstore_tpu_torch.transport.buffers import TransportBuffer, TransportContext, land
from torchstore_tpu_torch.transport.types import Request


class RPCTransportBuffer(TransportBuffer):
    transport_name = "rpc"

    def __init__(self, inproc_copy: bool = False) -> None:
        # index -> payload; filled by the client on put, by the volume on get.
        self.tensors: dict[int, torch.Tensor] = {}
        self.objects: dict[int, Any] = {}
        self.inproc_copy = inproc_copy

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
        if not self.inproc_copy:  # private copies already: they were framed
            return {**self.objects, **self.tensors}
        out: dict[int, Any] = {idx: copy.deepcopy(obj) for idx, obj in self.objects.items()}
        out.update((idx, t.clone()) for idx, t in self.tensors.items())
        return out

    def handle_get_request(
        self, ctx: TransportContext, metas: list[Request], entries: list[Any]
    ) -> None:
        for idx, (meta, entry) in enumerate(zip(metas, entries)):
            if meta.is_object:
                self.objects[idx] = copy.deepcopy(entry) if self.inproc_copy else entry
            elif self.inproc_copy:
                self.tensors[idx] = entry.part().clone()  # never hand out the stored storage
            else:
                self.tensors[idx] = entry.part()  # the frame carries only the part's bytes
