"""Wire serialization for the actor runtime.

Port of ``torchstore_tpu/runtime/serialization.py``. Messages are pickled
with protocol 5; CPU torch tensors ride as out-of-band buffers (their bytes
are written to the socket without a copy into the pickle stream and rebuilt
on the receiving side over the received buffer). A CUDA tensor is refused
at the frame: the transports stage device tensors to the host themselves.

Frame layout:
    u32 magic | u8 kind | u64 payload_len | u32 nbufs | u64 buf_len * nbufs
    | payload bytes | buffer bytes...
"""

from __future__ import annotations

import asyncio
import io
import pickle
import struct
from typing import Any

import torch

MAGIC = 0x7E5701AC

_HEADER = struct.Struct("<IBQI")
_U64 = struct.Struct("<Q")

KIND_REQUEST = 0
KIND_RESPONSE = 1
KIND_ERROR = 2
KIND_CONTROL = 3

_WRITE_CHUNK = 4 * 1024 * 1024


class SerializationError(RuntimeError):
    pass


def tensor_bytes(t: torch.Tensor):
    """A flat uint8 numpy view of a contiguous CPU tensor's bytes."""
    return t.reshape(-1).view(torch.uint8).numpy()


def _rebuild_tensor(dtype_name: str, shape: tuple, buf) -> torch.Tensor:
    dtype = getattr(torch, dtype_name)
    if len(memoryview(buf)) == 0:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(buf, dtype=torch.uint8).view(dtype).reshape(shape)


class _Pickler(pickle.Pickler):
    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            if obj.device.type != "cpu":
                raise SerializationError(
                    f"a {obj.device.type} tensor cannot ride an RPC frame; "
                    "stage it to the host first"
                )
            t = obj.detach().contiguous()
            dtype_name = str(t.dtype).removeprefix("torch.")
            return (
                _rebuild_tensor,
                (dtype_name, tuple(t.shape), pickle.PickleBuffer(tensor_bytes(t))),
            )
        return NotImplemented


def dumps(obj: Any) -> tuple[bytes, list[pickle.PickleBuffer]]:
    buffers: list[pickle.PickleBuffer] = []
    out = io.BytesIO()
    _Pickler(out, protocol=5, buffer_callback=buffers.append).dump(obj)
    return out.getvalue(), buffers


def loads(payload: bytes, buffers: list) -> Any:
    return pickle.loads(payload, buffers=buffers)


async def write_message(writer: asyncio.StreamWriter, kind: int, obj: Any) -> None:
    payload, buffers = dumps(obj)
    raws = [b.raw() for b in buffers]
    header = bytearray(_HEADER.pack(MAGIC, kind, len(payload), len(raws)))
    for raw in raws:
        header += _U64.pack(raw.nbytes)
    writer.write(bytes(header))
    writer.write(payload)
    for raw in raws:
        if raw.nbytes <= _WRITE_CHUNK:
            writer.write(raw)
        else:
            for off in range(0, raw.nbytes, _WRITE_CHUNK):
                writer.write(raw[off : off + _WRITE_CHUNK])
                await writer.drain()
    await writer.drain()
    for b in buffers:
        b.release()


async def read_message(reader: asyncio.StreamReader) -> tuple[int, Any]:
    header = await reader.readexactly(_HEADER.size)
    magic, kind, payload_len, nbufs = _HEADER.unpack(header)
    if magic != MAGIC:
        raise SerializationError(f"bad frame magic {magic:#x}")
    buf_lens = []
    if nbufs:
        lens_raw = await reader.readexactly(_U64.size * nbufs)
        buf_lens = [_U64.unpack_from(lens_raw, i * _U64.size)[0] for i in range(nbufs)]
    payload = await reader.readexactly(payload_len)
    buffers: list[bytearray] = []
    for blen in buf_lens:
        buf = bytearray(blen)
        await _read_into(reader, memoryview(buf))
        buffers.append(buf)
    return kind, loads(payload, buffers)


async def _read_into(reader: asyncio.StreamReader, view: memoryview) -> None:
    remaining = view.nbytes
    pos = 0
    while remaining:
        chunk = await reader.read(min(remaining, _WRITE_CHUNK))
        if not chunk:
            raise asyncio.IncompleteReadError(bytes(view[:pos]), view.nbytes)
        view[pos : pos + len(chunk)] = chunk
        pos += len(chunk)
        remaining -= len(chunk)
