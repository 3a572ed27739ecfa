"""The port's durable storage (``storage_utils/file_store.py``) and crash
recovery, held to the JAX package.

Twins of ``tests/test_file_store.py``: ``FileBackedStore`` round trips
(tensors, shards, objects), writes through a served mapping, crash-safe
persists and torn temporaries, deletes, empty tensors, reset, superseded
layouts and dtypes, ``resolve_manifests``, a durable store that survives its
volume's crash, and ``recover`` without a directory. The same numpy inputs
from one seed go through both packages' stores, and their data and
manifests must agree. Added: a bf16 round trip (bf16 has no numpy dtype:
the file is raw bytes, the dtype is in ``meta.json``), and a torn write
through the whole store (a leftover ``.tmp`` beside a committed entry and
an aborted first persist: swept at start, never served).
"""

import asyncio
import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

import torchstore_tpu as ts_ref
import torchstore_tpu_torch as tst
from torchstore_tpu import api as ref_api
from torchstore_tpu import config as ref_config
from torchstore_tpu.config import StoreConfig as RefStoreConfig
from torchstore_tpu.controller import resolve_manifests as ref_resolve_manifests
from torchstore_tpu.runtime import stop_singleton as ref_stop_singleton
from torchstore_tpu.storage_utils.file_store import FileBackedStore as RefFileBackedStore
from torchstore_tpu.transport import shared_memory as ref_shm
from torchstore_tpu.transport.types import Request as RefRequest
from torchstore_tpu.transport.types import TensorMeta as RefTensorMeta
from torchstore_tpu.transport.types import TensorSlice as RefTensorSlice
from torchstore_tpu_torch import api as port_api
from torchstore_tpu_torch.metadata.index_core import resolve_manifests
from torchstore_tpu_torch.runtime import stop_singleton as port_stop_singleton
from torchstore_tpu_torch.storage_utils.file_store import FileBackedStore
from torchstore_tpu_torch.transport.types import OpaqueBlob, Request, TensorMeta, TensorSlice


def t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def manifest_view(manifest: list) -> list:
    """Each item's key, shape, dtype and slice, in key order."""
    out = []
    for item in manifest:
        meta = item["meta"]
        tm = meta.tensor_meta
        ts = meta.tensor_slice
        out.append((meta.key, meta.is_object, tuple(tm.shape) if tm else None,
                    str(tm.dtype) if tm else None,
                    (ts.offsets, ts.local_shape, ts.global_shape, ts.coordinates,
                     ts.mesh_shape) if ts else None))
    return sorted(out)


def slices(n: int, rows: int, cols: int):
    """Row shards of a (n*rows, cols) tensor over a mesh of n, in both
    packages' types."""
    out = []
    for r in range(n):
        kw = dict(offsets=(r * rows, 0), local_shape=(rows, cols), global_shape=(n * rows, cols),
                  coordinates=(r,), mesh_shape=(n,))
        out.append((TensorSlice(**kw), RefTensorSlice(**kw)))
    return out


class TestFileBackedStoreUnit:
    def test_tensor_roundtrip_and_reload(self, tmp_path):
        x = np.random.default_rng(0).random((32, 16)).astype(np.float32)
        store = FileBackedStore(str(tmp_path / "port"))
        store.store([Request.from_tensor("a/b", t(x)).meta_only()], {0: t(x)})
        np.testing.assert_array_equal(store.kv["a/b"].numpy(), x)
        store2 = FileBackedStore(str(tmp_path / "port"))  # a fresh instance maps the file
        np.testing.assert_array_equal(store2.kv["a/b"].numpy(), x)
        ref = RefFileBackedStore(str(tmp_path / "ref"))
        ref.store([RefRequest.from_tensor("a/b", x).meta_only()], {0: x})
        assert manifest_view(store2.manifest()) == manifest_view(
            RefFileBackedStore(str(tmp_path / "ref")).manifest())

    def test_sharded_roundtrip_and_reload(self, tmp_path):
        g = np.arange(32.0, dtype=np.float32).reshape(4, 8)
        store = FileBackedStore(str(tmp_path / "port"))
        ref = RefFileBackedStore(str(tmp_path / "ref"))
        for r, (sl, rsl) in enumerate(slices(2, 2, 8)):
            store.store([Request(key="w", tensor_slice=sl)], {0: t(g[r * 2:r * 2 + 2])})
            ref.store([RefRequest(key="w", tensor_slice=rsl)], {0: g[r * 2:r * 2 + 2]})
        store2 = FileBackedStore(str(tmp_path / "port"))
        np.testing.assert_array_equal(store2.kv["w"][(1,)][1].numpy(), g[2:4])
        assert len(store2.manifest()) == 2
        assert manifest_view(store2.manifest()) == manifest_view(
            RefFileBackedStore(str(tmp_path / "ref")).manifest())

    def test_objects_persist(self, tmp_path):
        store = FileBackedStore(str(tmp_path))
        store.store([Request.from_objects("cfg", None).meta_only()], {0: {"lr": 1}})
        blob = OpaqueBlob.wrap({"step": 3})
        store.store([Request.from_objects("blob", None).meta_only()], {0: blob})
        store2 = FileBackedStore(str(tmp_path))
        assert store2.kv["cfg"] == {"lr": 1}
        got = store2.kv["blob"]
        assert isinstance(got, OpaqueBlob) and got.unwrap() == {"step": 3}

    def test_inplace_overwrite_writes_through(self, tmp_path):
        """A write into the served mapping reaches the file, and persisting
        that very mapping again (no transport of the port writes in place,
        but a caller may) commits the same bytes: the new file replaces the
        one it maps only by the rename."""
        store = FileBackedStore(str(tmp_path))
        x = torch.zeros(8)
        meta = Request.from_tensor("k", x).meta_only()
        store.store([meta], {0: x})
        store.kv["k"][:] = 7.0
        np.testing.assert_array_equal(FileBackedStore(str(tmp_path)).kv["k"].numpy(),
                                      np.full(8, 7.0, np.float32))
        store.store([meta], {0: store.kv["k"]})
        np.testing.assert_array_equal(FileBackedStore(str(tmp_path)).kv["k"].numpy(),
                                      np.full(8, 7.0, np.float32))

    def test_persist_commits_atomically_no_tmp_left(self, tmp_path):
        store = FileBackedStore(str(tmp_path))
        x = np.random.default_rng(1).random(64).astype(np.float32)
        store.store([Request.from_tensor("k", t(x)).meta_only()], {0: t(x)})
        leftovers = [os.path.join(d, f) for d, _dirs, files in os.walk(str(tmp_path))
                     for f in files if f.endswith(".tmp")]
        assert leftovers == []
        np.testing.assert_array_equal(store.kv["k"].numpy(), x)

    def test_torn_tmp_from_mid_write_death_never_trusted(self, tmp_path):
        store = FileBackedStore(str(tmp_path))
        x = np.random.default_rng(2).random(16).astype(np.float32)
        store.store([Request.from_tensor("good", t(x)).meta_only()], {0: t(x)})
        # Two death points: a torn data temporary beside a committed entry,
        # and an aborted first persist (only a temporary, no meta.json).
        good_dir = os.path.join(str(tmp_path), os.listdir(str(tmp_path))[0])
        with open(os.path.join(good_dir, "data.bin.tmp"), "wb") as f:
            f.write(b"\x00garbage\x00" * 3)
        aborted = os.path.join(str(tmp_path), "YWJvcnRlZA")  # "aborted"
        os.makedirs(aborted)
        with open(os.path.join(aborted, "data.bin.tmp"), "wb") as f:
            f.write(b"torn")
        store2 = FileBackedStore(str(tmp_path))
        assert set(store2.kv) == {"good"}
        np.testing.assert_array_equal(store2.kv["good"].numpy(), x)
        assert not os.path.exists(os.path.join(good_dir, "data.bin.tmp"))
        assert not os.path.exists(os.path.join(aborted, "data.bin.tmp"))

    def test_delete_removes_files(self, tmp_path):
        store = FileBackedStore(str(tmp_path))
        store.store([Request.from_tensor("k", torch.ones(4)).meta_only()], {0: torch.ones(4)})
        assert store.delete("k")
        assert not store.delete("k")
        assert len(os.listdir(tmp_path)) == 0
        store2 = FileBackedStore(str(tmp_path))
        assert "k" not in store2.kv

    def test_zero_size_tensor(self, tmp_path):
        store = FileBackedStore(str(tmp_path))
        x = torch.zeros((0, 128))
        store.store([Request.from_tensor("empty", x).meta_only()], {0: x})
        assert tuple(store.kv["empty"].shape) == (0, 128)
        store2 = FileBackedStore(str(tmp_path))
        assert tuple(store2.kv["empty"].shape) == (0, 128)

    def test_reset_clears_dir(self, tmp_path):
        store = FileBackedStore(str(tmp_path))
        store.store([Request.from_tensor("k", torch.ones(4)).meta_only()], {0: torch.ones(4)})
        store.reset()
        assert os.listdir(tmp_path) == []

    def test_layout_change_prunes_superseded_shards(self, tmp_path):
        g = np.arange(32.0, dtype=np.float32).reshape(4, 8)
        manifests = {}
        for pkg, cls, req in (("port", FileBackedStore, Request),
                              ("ref", RefFileBackedStore, RefRequest)):
            store = cls(str(tmp_path / pkg))
            for r, pair in enumerate(slices(2, 2, 8)):  # the old layout: 2-way rows
                sl = pair[0] if pkg == "port" else pair[1]
                part = g[r * 2:r * 2 + 2]
                store.store([req(key="w", tensor_slice=sl)], {0: t(part) if pkg == "port" else part})
            new = slices(4, 1, 8)[0][0 if pkg == "port" else 1]  # the new: 4-way
            store.store([req(key="w", tensor_slice=new)], {0: t(g[:1]) if pkg == "port" else g[:1]})
            assert len(store.manifest()) == 1  # the old layout's shards are gone
            assert store.manifest()[0]["meta"].tensor_slice.mesh_shape == (4,)
            manifests[pkg] = manifest_view(cls(str(tmp_path / pkg)).manifest())  # and from disk
        assert len(manifests["port"]) == 1 and manifests["port"] == manifests["ref"]

    def test_dtype_change_prunes_old_dtype_shards(self, tmp_path):
        store = FileBackedStore(str(tmp_path))
        sl0 = TensorSlice((0,), (4,), (8,), (0,), (2,))
        sl1 = TensorSlice((4,), (4,), (8,), (1,), (2,))
        store.store([Request(key="w", tensor_slice=sl0)], {0: torch.ones(4)})
        store.store([Request(key="w", tensor_slice=sl1)], {0: torch.ones(4)})
        store.store([Request(key="w", tensor_slice=sl0)], {0: torch.ones(4, dtype=torch.float16)})
        manifest = FileBackedStore(str(tmp_path)).manifest()
        assert len(manifest) == 1
        assert manifest[0]["meta"].tensor_meta.dtype == "float16"

    def test_bf16_round_trip(self, tmp_path):
        """bf16 has no numpy dtype: the file is raw bytes, the dtype lives in
        meta.json, and the mapping is viewed back bit for bit; the JAX
        package's store holds the same bits as ml_dtypes.bfloat16."""
        rng = np.random.default_rng(3)
        x = rng.standard_normal((16, 24)).astype(np.float32)
        xb = torch.from_numpy(x).to(torch.bfloat16)
        sl = TensorSlice((8, 0), (8, 24), (16, 24), (1,), (2,))
        store = FileBackedStore(str(tmp_path / "port"))
        store.store([Request.from_tensor("w", xb).meta_only(),
                     Request(key="s", tensor_slice=sl)], {0: xb, 1: xb[8:]})
        store2 = FileBackedStore(str(tmp_path / "port"))
        got = store2.kv["w"]
        assert got.dtype == torch.bfloat16 and torch.equal(got, xb)
        shard = store2.kv["s"][(1,)][1]
        assert torch.equal(shard, xb[8:])
        with open(os.path.join(store2.root, os.listdir(store2.root)[0], "meta.json")) as f:
            assert json.load(f)["dtype"] == "bfloat16"
        ref = RefFileBackedStore(str(tmp_path / "ref"))
        xr = x.astype(ml_dtypes.bfloat16)
        ref.store([RefRequest.from_tensor("w", xr).meta_only()], {0: xr})
        ref_bits = RefFileBackedStore(str(tmp_path / "ref")).get_data(
            RefRequest.meta_request("w")).view(np.uint16)
        np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), ref_bits)
        assert manifest_view(store2.manifest())[1][3] == "bfloat16"


class TestResolveManifests:
    """Mixed-layout recovery: one volume already re-sharded, another still
    holding old-layout shards; only the newest layout survives."""

    @staticmethod
    def _items(key, coords, mesh, offsets, local, global_, mtime, dtype="float32"):
        kw = dict(offsets=offsets, local_shape=local, global_shape=global_, coordinates=coords,
                  mesh_shape=mesh)
        return ({"meta": Request(key=key, tensor_slice=TensorSlice(**kw),
                                 tensor_meta=TensorMeta(shape=local, dtype=dtype)),
                 "mtime": mtime},
                {"meta": RefRequest(key=key, tensor_slice=RefTensorSlice(**kw),
                                    tensor_meta=RefTensorMeta(shape=local, dtype=dtype)),
                 "mtime": mtime})

    @staticmethod
    def _both(per_volume):
        got = resolve_manifests([(v, [i[0] for i in items]) for v, items in per_volume])
        want = ref_resolve_manifests([(v, [i[1] for i in items]) for v, items in per_volume])
        view = lambda res: ([(v, m.key, m.tensor_slice.coordinates if m.tensor_slice else None,  # noqa: E731
                              m.tensor_slice.mesh_shape if m.tensor_slice else None, g)
                             for v, m, g in res[0]], res[1])
        assert view(got) == view(want)
        return got

    def test_newest_layout_wins(self):
        old0 = self._items("w", (0,), (2,), (0, 0), (2, 8), (4, 8), 100.0)
        old1 = self._items("w", (1,), (2,), (2, 0), (2, 8), (4, 8), 100.0)
        new0 = self._items("w", (0,), (4,), (0, 0), (1, 8), (4, 8), 200.0)
        survivors, dropped = self._both([("v0", [new0]), ("v1", [old0, old1])])
        assert dropped == 2 and len(survivors) == 1
        assert survivors[0][1].tensor_slice.mesh_shape == (4,)

    def test_single_layout_untouched(self):
        a = self._items("w", (0,), (2,), (0, 0), (2, 8), (4, 8), 50.0)
        b = self._items("w", (1,), (2,), (2, 0), (2, 8), (4, 8), 60.0)
        survivors, dropped = self._both([("v0", [a]), ("v1", [b])])
        assert dropped == 0 and len(survivors) == 2

    def test_bare_requests_accepted(self):
        survivors, dropped = resolve_manifests([("v0", [Request(key="obj", is_object=True)])])
        want = ref_resolve_manifests([("v0", [RefRequest(key="obj", is_object=True)])])
        assert dropped == want[1] == 0 and survivors[0][1].key == want[0][0][1].key == "obj"


# ---------------------------------------------------------------------------
# durable stores through the public API
# ---------------------------------------------------------------------------


async def _crash(pkg, store_name: str) -> None:
    """Kill a store's volume processes and stop its controller, with no
    teardown (teardown would reset the volumes)."""
    api = port_api if pkg is tst else ref_api
    handle = api._stores.pop(store_name)
    if pkg is tst:
        handle.client.close()
    for proc in handle.volume_mesh._processes:
        proc.terminate()
        proc.join(5)
    if pkg is tst:
        await port_stop_singleton(port_api._controller_name(store_name))
    else:
        await ref_stop_singleton(f"ts_{store_name}_controller")


async def durable_session(pkg, storage_dir: str, config=None) -> dict:
    """test_durable_store_survives_volume_crash through ``pkg``."""
    name = "dur_port" if pkg is tst else "dur_ref"
    rng = np.random.default_rng(11)
    x = rng.random((64, 32)).astype(np.float32)
    xb = x.astype(ml_dtypes.bfloat16)
    port = pkg is tst
    leaf = (lambda a: torch.from_numpy(a.copy())) if port else (lambda a: a.copy())
    bf16 = torch.from_numpy(x).to(torch.bfloat16) if port else xb
    mk = (lambda **kw: TensorSlice(**kw)) if port else (lambda **kw: RefTensorSlice(**kw))
    sl = mk(offsets=(0, 0), local_shape=(32, 32), global_shape=(64, 32), coordinates=(0,),
            mesh_shape=(2,))
    sl2 = mk(offsets=(32, 0), local_shape=(32, 32), global_shape=(64, 32), coordinates=(1,),
             mesh_shape=(2,))
    await pkg.initialize(store_name=name, storage_dir=storage_dir, config=config)
    await pkg.put("w", pkg.Shard(leaf(x[:32]), sl), store_name=name)
    await pkg.put("w", pkg.Shard(leaf(x[32:]), sl2), store_name=name)
    await pkg.put("dense", leaf(x), store_name=name)
    await pkg.put("half", bf16, store_name=name)
    await pkg.put("cfg", {"step": 9}, store_name=name)
    await _crash(pkg, name)
    await pkg.initialize(store_name=name, storage_dir=storage_dir, recover=True, config=config)
    try:
        out = {
            "w": np.asarray(await pkg.get("w", store_name=name)),
            "dense": np.asarray(await pkg.get("dense", store_name=name)),
            "cfg": await pkg.get("cfg", store_name=name),
            "keys": sorted(await pkg.keys(store_name=name)),
        }
        half = await pkg.get("half", store_name=name)
        out["half"] = (half.view(torch.int16).numpy().view(np.uint16) if port
                       else np.asarray(half).view(np.uint16))
    finally:
        await pkg.shutdown(name)
    out["x"], out["x_bits"] = x, xb.view(np.uint16)
    out["left"] = [f for _, _, files in os.walk(storage_dir) for f in files]
    return out


@pytest.fixture(scope="module")
def durable(tmp_path_factory):
    root = tmp_path_factory.mktemp("durable")
    port = asyncio.run(asyncio.wait_for(durable_session(tst, str(root / "port")), 240))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_config, "_default_config", None)
        mp.setattr(ref_shm, "is_available", lambda: False)
        mp.setenv("TORCHSTORE_TPU_META_STAMPED", "0")
        mp.setenv("TORCHSTORE_TPU_ONE_SIDED", "0")
        ref = asyncio.run(asyncio.wait_for(durable_session(
            ts_ref, str(root / "ref"), RefStoreConfig(shm_enabled=False, bulk_tcp_enabled=False)),
            240))
    return port, ref


def test_durable_store_survives_volume_crash(durable):
    port, ref = durable
    np.testing.assert_array_equal(port["w"], port["x"])
    np.testing.assert_array_equal(port["dense"], port["x"])
    np.testing.assert_array_equal(port["half"], port["x_bits"])
    assert port["cfg"] == {"step": 9}
    assert port["keys"] == ["cfg", "dense", "half", "w"]
    for key in ("w", "dense", "half", "cfg", "keys"):
        np.testing.assert_equal(port[key], ref[key])
    assert port["left"] == []  # the final shutdown's teardown resets the directory


async def _torn_session(storage_dir: str) -> dict:
    x = torch.arange(64.0).reshape(8, 8).to(torch.bfloat16)
    await tst.initialize(store_name="torn", storage_dir=storage_dir)
    await tst.put("good", x, store_name="torn")
    await _crash(tst, "torn")
    vol_dir = os.path.join(storage_dir, os.listdir(storage_dir)[0])
    (entry,) = os.listdir(vol_dir)
    with open(os.path.join(vol_dir, entry, "data.bin.tmp"), "wb") as f:
        f.write(b"\xff" * 128)  # a torn overwrite the rename never committed
    aborted = os.path.join(vol_dir, "dG9ybg")  # "torn": a first persist that died
    os.makedirs(aborted)
    with open(os.path.join(aborted, "data.bin.tmp"), "wb") as f:
        f.write(b"\xff" * 128)
    await tst.initialize(store_name="torn", storage_dir=storage_dir, recover=True)
    try:
        out = {"keys": await tst.keys(store_name="torn"),
               "good": torch.equal(await tst.get("good", store_name="torn"), x),
               "tmp_left": [f for d, _, fs in os.walk(storage_dir) for f in fs
                            if f.endswith(".tmp")]}
        try:
            await tst.get("torn", store_name="torn")
            out["torn_served"] = True
        except KeyError:
            out["torn_served"] = False
    finally:
        await tst.shutdown("torn")
    return out


def test_torn_write_is_swept_and_never_served(tmp_path):
    out = asyncio.run(asyncio.wait_for(_torn_session(str(tmp_path / "store")), 240))
    assert out == {"keys": ["good"], "good": True, "tmp_left": [], "torn_served": False}


def test_recover_without_dir_rejected():
    with pytest.raises(ValueError, match="requires storage_dir"):
        asyncio.run(tst.initialize(store_name="bad", recover=True))
    from torchstore_tpu_torch import api

    assert "bad" not in api._stores


def test_reindex_seeds_generations_past_any_earlier_one():
    """A recovered key's update generation starts at one random offset of
    at least 2**45: a subscriber that outlived the restart holds a small
    generation of the old index, and ``wait_for_change`` (which wakes on
    inequality) must wake it at once rather than match it."""
    from torchstore_tpu_torch.metadata.index_core import IndexCore

    items = [{"meta": Request(key=k, tensor_meta=TensorMeta((4,), "float32")), "mtime": 1.0,
              "write_gen": 7} for k in ("a", "b/c")]
    survivors, dropped = resolve_manifests([("0", items)])

    async def go():
        core = IndexCore()
        count = await core.reindex(survivors)
        change = await core.wait_for_change("a", last_gen=3, timeout=1.0)
        return count, dict(core._key_gens), change, core.locate(["a"])["a"]["0"].write_gen

    count, gens, change, write_gen = asyncio.run(go())
    assert dropped == 0 and count == 2 and write_gen == 7
    assert len(set(gens.values())) == 1 and min(gens.values()) >= 1 << 45
    assert change == {"gen": gens["a"], "state": "committed"}
