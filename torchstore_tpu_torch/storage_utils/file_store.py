"""Durable storage: a file-backed store of volume entries.

Port of ``torchstore_tpu/storage_utils/file_store.py`` over torch tensors.
It holds the durable copy of a volume started with a storage directory
(``initialize(storage_dir=)``) and the disk half of the spill tier
(``tiering/spill.py``). Its entries take the volume's shapes: a tensor, a
``ShardedEntry`` of (``TensorSlice``, tensor) per mesh coordinate, or an
object. Tensors are served as shared mappings of their files
(``torch.from_file``), so a get reads through the page cache.

Layout: ``<root>/<urlsafe(key)>/meta.json`` beside ``data.bin`` (a tensor),
``shard_<coords>.bin`` (one per stored coordinate) or ``object.bin``. A data
file is the tensor's raw bytes; ``meta.json`` records its dtype by its wire
name and its shape (bf16 has no numpy dtype, so every tensor is mapped as
bytes and viewed in the recorded dtype). An object's bytes are the client's
pickle (``OpaqueBlob``) as it arrived; the metadata file is JSON, the
port's own format.

Crash safety: every fresh persist writes a temporary sibling, flushes and
fsyncs it, then renames it into place, and ``meta.json`` is fsynced before
its atomic replace. A process killed at any instant leaves no entry, the
old one, or the complete new one, never a torn file a later load or
fault-in would trust. ``*.tmp`` files a death left behind are swept at
load. A write through a served mapping reaches the committed file (best
effort, not fsynced), and persisting a mapped tensor again is safe: the
new file replaces the one it maps only by the rename.
"""

from __future__ import annotations

import base64
import json
import math
import os
import pickle
import shutil
from typing import Any, Optional

import torch

from torchstore_tpu_torch.logging import get_logger
from torchstore_tpu_torch.storage_volume import ShardedEntry
from torchstore_tpu_torch.transport.types import (
    OpaqueBlob,
    Request,
    TensorMeta,
    TensorSlice,
    dtype_name,
    torch_dtype,
)

logger = get_logger("torchstore_tpu_torch.file_store")

_META = "meta.json"
_DATA = "data.bin"
_OBJECT = "object.bin"
_SLICE_FIELDS = ("offsets", "local_shape", "global_shape", "coordinates", "mesh_shape")


def _keydir(root: str, key: str) -> str:
    return os.path.join(root, base64.urlsafe_b64encode(key.encode()).decode().rstrip("="))


def _dir_key(name: str) -> str:
    return base64.urlsafe_b64decode(name + "=" * (-len(name) % 4)).decode()


def _shard_file(coords: tuple) -> str:
    return "shard_" + "_".join(str(c) for c in coords) + ".bin"


def _map_file(path: str, dtype: torch.dtype, shape) -> torch.Tensor:
    """A tensor over the file's bytes, written through to it; an empty
    tensor has no file."""
    shape = tuple(shape)
    nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    if nbytes == 0:
        return torch.empty(shape, dtype=dtype)
    raw = torch.from_file(path, shared=True, size=nbytes, dtype=torch.uint8)
    return raw.view(dtype).view(shape)


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_atomic(final: str, data) -> None:
    """Write ``data`` (a buffer) to ``final`` through a fsynced temporary
    and a rename."""
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)


def _tensor_bytes(t: torch.Tensor) -> memoryview:
    return memoryview(t.detach().contiguous().reshape(-1).view(torch.uint8).numpy())


def _slice_json(ts: TensorSlice) -> dict:
    return {name: list(getattr(ts, name)) for name in _SLICE_FIELDS}


def _slice_of(d: dict) -> TensorSlice:
    return TensorSlice(**{name: tuple(d[name]) for name in _SLICE_FIELDS})


def entry_requests(key: str, entry: Any) -> tuple[list[Request], dict[int, Any]]:
    """(metas, values) in ``store``'s shape for one entry of the volume's
    store."""
    if isinstance(entry, ShardedEntry):
        metas, values = [], {}
        for idx, (ts, t) in enumerate(entry.values()):
            metas.append(Request(key=key, tensor_slice=ts, tensor_meta=TensorMeta.of(t)))
            values[idx] = t
        return metas, values
    if isinstance(entry, torch.Tensor):
        return [Request(key=key, tensor_meta=TensorMeta.of(entry))], {0: entry}
    return [Request(key=key, is_object=True)], {0: entry}


class FileBackedStore:
    """A directory of entries; ``kv`` holds them as the volume does, each
    tensor a mapping of its committed file."""

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.kv: dict[str, Any] = {}
        self._load_all()

    # ---- loading ---------------------------------------------------------

    def _load_all(self) -> None:
        for name in os.listdir(self.root):
            path = os.path.join(self.root, name)
            if not os.path.isdir(path):
                continue
            # A temporary the rename never committed is garbage no entry
            # references; a directory holding only one is an aborted first
            # persist, skipped below for want of its meta.json.
            for fname in os.listdir(path):
                if fname.endswith(".tmp"):
                    try:
                        os.unlink(os.path.join(path, fname))
                    except OSError:
                        pass
            meta_path = os.path.join(path, _META)
            if not os.path.isfile(meta_path):
                continue
            try:
                with open(meta_path) as f:
                    meta = json.load(f)
                self.kv[_dir_key(name)] = self._open_entry(path, meta)
            except Exception:  # noqa: BLE001 - a corrupt entry is skipped, not fatal
                logger.warning("skipping corrupt entry %s", path)

    @staticmethod
    def _open_entry(path: str, meta: dict) -> Any:
        if meta["type"] == "object":
            with open(os.path.join(path, _OBJECT), "rb") as f:
                data = f.read()
            return OpaqueBlob(data) if meta["blob"] else pickle.loads(data)
        dtype = torch_dtype(meta["dtype"])
        if meta["type"] == "tensor":
            return _map_file(os.path.join(path, _DATA), dtype, meta["shape"])
        entry = ShardedEntry()
        for d in meta["slices"]:
            ts = _slice_of(d)
            entry[ts.coordinates] = (
                ts, _map_file(os.path.join(path, _shard_file(ts.coordinates)), dtype,
                              ts.local_shape))
        return entry

    # ---- persisting ------------------------------------------------------

    @staticmethod
    def _write_meta(path: str, meta: dict) -> None:
        _write_atomic(os.path.join(path, _META), json.dumps(meta).encode())
        _fsync_dir(path)

    @staticmethod
    def _persist_file(path: str, fname: str, t: torch.Tensor) -> torch.Tensor:
        """Commit ``t``'s bytes as ``fname`` (crash-safe) and map the
        committed file."""
        if t.numel() == 0:
            return torch.empty(t.shape, dtype=t.dtype)
        final = os.path.join(path, fname)
        _write_atomic(final, _tensor_bytes(t))
        return _map_file(final, t.dtype, t.shape)

    def _persist_object(self, key: str, value: Any) -> None:
        path = _keydir(self.root, key)
        if isinstance(self.kv.get(key), torch.Tensor | ShardedEntry):
            shutil.rmtree(path, ignore_errors=True)  # another kind: its files go
        os.makedirs(path, exist_ok=True)
        blob = isinstance(value, OpaqueBlob)
        _write_atomic(os.path.join(path, _OBJECT), value.data if blob else pickle.dumps(value))
        self._write_meta(path, {"type": "object", "blob": blob})
        self.kv[key] = value

    def _persist_tensor(self, key: str, t: torch.Tensor) -> None:
        old = self.kv.get(key)
        path = _keydir(self.root, key)
        if old is not None and not isinstance(old, torch.Tensor):
            shutil.rmtree(path, ignore_errors=True)  # another kind: its files go
        os.makedirs(path, exist_ok=True)
        mapped = self._persist_file(path, _DATA, t)
        self._write_meta(path, {"type": "tensor", "dtype": dtype_name(t.dtype),
                                "shape": list(t.shape)})
        self.kv[key] = mapped

    def _persist_shard(self, key: str, ts: TensorSlice, t: torch.Tensor) -> None:
        path = _keydir(self.root, key)
        entry = self.kv.get(key)
        if not isinstance(entry, ShardedEntry):
            if entry is not None:
                shutil.rmtree(path, ignore_errors=True)
            entry = self.kv[key] = ShardedEntry()
        # A shard of another layout (mesh or global shape) or dtype goes with
        # its file: meta.json records one layout and one dtype per key, and a
        # recovery must never map a mix.
        stale = [c for c, (s, old) in entry.items()
                 if (s.mesh_shape, s.global_shape) != (ts.mesh_shape, ts.global_shape)
                 or old.dtype != t.dtype]
        for coords in stale:
            del entry[coords]
            try:
                os.unlink(os.path.join(path, _shard_file(coords)))
            except OSError:
                pass
        os.makedirs(path, exist_ok=True)
        entry[ts.coordinates] = (ts, self._persist_file(path, _shard_file(ts.coordinates), t))
        self._write_meta(path, {"type": "sharded", "dtype": dtype_name(t.dtype),
                                "slices": [_slice_json(s) for s, _ in entry.values()]})

    def store(self, metas: list[Request], values: dict[int, Any]) -> None:
        """Persist each value under its request's key: an object, a whole
        tensor, or one shard (same-layout shards replace each other by
        coordinate)."""
        for idx, meta in enumerate(metas):
            if idx not in values:
                raise ValueError(f"no value for {meta.key!r}")
            value = values[idx]
            if meta.is_object:
                self._persist_object(meta.key, value)
            elif meta.tensor_slice is not None:
                self._persist_shard(meta.key, meta.tensor_slice, value)
            else:
                self._persist_tensor(meta.key, value)

    # ---- deletes and recovery ---------------------------------------------

    def delete(self, key: str) -> bool:
        existed = self.kv.pop(key, None) is not None
        shutil.rmtree(_keydir(self.root, key), ignore_errors=True)
        return existed

    def reset(self) -> None:
        self.kv.clear()
        shutil.rmtree(self.root, ignore_errors=True)
        os.makedirs(self.root, exist_ok=True)

    def manifest(self, exclude: Optional[set] = None) -> list[dict]:
        """``{"meta": Request, "mtime": float}`` for every persisted entry
        (one per shard), for the controller's index rebuild. File mtimes let
        the rebuild keep only the newest layout of a key whose volumes
        disagree (a crash mid re-shard)."""
        out: list[dict] = []
        for key, entry in self.kv.items():
            if exclude and key in exclude:
                continue
            path = _keydir(self.root, key)

            def mtime(name: str) -> float:
                try:
                    return os.path.getmtime(os.path.join(path, name))
                except OSError:
                    return 0.0

            if isinstance(entry, ShardedEntry):
                for coords, (ts, t) in entry.items():
                    out.append({"meta": Request(key=key, tensor_slice=ts,
                                                tensor_meta=TensorMeta.of(t)),
                                "mtime": mtime(_shard_file(coords))})
            elif isinstance(entry, torch.Tensor):
                out.append({"meta": Request(key=key, tensor_meta=TensorMeta.of(entry)),
                            "mtime": mtime(_DATA)})
            else:
                out.append({"meta": Request(key=key, is_object=True), "mtime": mtime(_META)})
        return out
