"""Port parity for the weight-sync round trip: the same numpy-seeded
Llama-shaped tree goes through torchstore_tpu (numpy leaves) and
torchstore_tpu_torch (CPU tensors via ``from_numpy_tree``), buffered and
direct, with a refresh after an in-place update of the source. Results are
compared bit for bit (bf16 transfer dtype), with the flat keys, the stored
keys and the MAPPING commit marker equal. Also the port's single-key ops,
its no-matching-push error and its segment hygiene at shutdown."""

import copy
import multiprocessing
import os
import uuid

import anyio
import ml_dtypes
import numpy as np
import pytest
import torch

import torchstore_tpu as ts_ref
import torchstore_tpu_torch as tst
from torchstore_tpu import config as ref_config
from torchstore_tpu.config import StoreConfig as RefStoreConfig
from torchstore_tpu.state_dict_utils import flatten_state_dict as ref_flatten
from torchstore_tpu.transport import shared_memory as ref_shm
from torchstore_tpu_torch.state_dict_utils import flatten_state_dict as port_flatten
from torchstore_tpu_torch.transport import shared_memory as port_shm
from torchstore_tpu_torch.workloads import llama_shapes

GEOMETRY = dict(hidden=64, intermediate=128, vocab=256, layers=2, heads=4, kv_heads=2)
TIMEOUT_S = 120


def numpy_tree(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)

    def fill(node):
        if isinstance(node, dict):
            return {k: fill(v) for k, v in node.items()}
        return rng.standard_normal(node).astype(np.float32)

    tree = fill(llama_shapes(**GEOMETRY))
    tree["step"] = 7  # a non-tensor leaf rides along
    return tree


def map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def bits(leaf):
    """uint16 bits of a bf16 leaf from either package; other leaves as is."""
    if isinstance(leaf, torch.Tensor):
        return leaf.view(torch.int16).numpy().view(np.uint16).copy()
    if isinstance(leaf, np.ndarray):
        return np.asarray(leaf).view(np.uint16).copy()
    return leaf


def assert_trees_bit_equal(port, ref):
    pf, pm = port_flatten(map_leaves(bits, port))
    rf, rm = ref_flatten(map_leaves(bits, ref))
    assert pm == rm
    assert list(pf) == list(rf)
    for key in rf:
        if isinstance(rf[key], np.ndarray):
            np.testing.assert_array_equal(pf[key], rf[key], err_msg=key)
        else:
            assert pf[key] == rf[key], key


async def run_reference(tree: dict, monkeypatch) -> dict:
    store = f"ref_{uuid.uuid4().hex[:8]}"
    tree = copy.deepcopy(tree)
    bf16 = ml_dtypes.bfloat16
    # The reference over its RPC and TCP rungs, without its stamped
    # metadata and one-sided planes: its results do not depend on the rung,
    # and it then adds no ts_shm_* segments to the machine-wide segment
    # counts of the reference's own tests beside it. The spawned controller
    # and volume read the two switches from the environment.
    # The process's default config is read from the environment once: it
    # must not be first read under these switches, or the reference's own
    # tests that run later in this process would inherit them.
    monkeypatch.setattr(ref_config, "_default_config", None)
    monkeypatch.setattr(ref_shm, "is_available", lambda: False)
    monkeypatch.setenv("TORCHSTORE_TPU_META_STAMPED", "0")
    monkeypatch.setenv("TORCHSTORE_TPU_ONE_SIDED", "0")
    config = RefStoreConfig(shm_enabled=False, bulk_tcp_enabled=False)
    await ts_ref.initialize(store_name=store, config=config)
    try:
        await ts_ref.put_state_dict("policy", tree, transfer_dtype=bf16, store_name=store)
        got = await ts_ref.get_state_dict("policy", store_name=store)
        buffered = map_leaves(lambda v: np.array(v) if isinstance(v, np.ndarray) else v, got)
        marker = await ts_ref.get("policy/MAPPING", store_name=store)
        keys = await ts_ref.keys("policy", store_name=store)
        targets = map_leaves(
            lambda v: np.zeros(v.shape, bf16) if isinstance(v, np.ndarray) else v, tree
        )
        await ts_ref.put_state_dict(
            "policy_direct", tree, transfer_dtype=bf16, direct=True, store_name=store
        )
        await ts_ref.get_state_dict("policy_direct", targets, direct=True, store_name=store)
        direct = copy.deepcopy(targets)
        for leaf in port_flatten(tree)[0].values():
            if isinstance(leaf, np.ndarray):
                leaf += 1.0  # the training step, in place
        await ts_ref.put_state_dict(
            "policy_direct", tree, transfer_dtype=bf16, direct=True, store_name=store
        )
        await ts_ref.get_state_dict("policy_direct", targets, direct=True, store_name=store)
        direct_keys = await ts_ref.keys("policy_direct", store_name=store)
    finally:
        await ts_ref.shutdown(store)
    return dict(
        buffered=buffered, marker=marker, keys=keys, direct=direct,
        refreshed=targets, direct_keys=direct_keys,
    )


async def run_port(tree: dict, shm: bool) -> dict:
    store = f"port_{uuid.uuid4().hex[:8]}"
    src = tst.from_numpy_tree(tree, "cpu")
    bf16 = torch.bfloat16
    config = tst.StoreConfig(shm_enabled=shm)
    await tst.initialize(store_name=store, config=config)
    try:
        pids = [p.pid for p in multiprocessing.active_children()]
        await tst.put_state_dict("policy", src, transfer_dtype=bf16, store_name=store)
        buffered = await tst.get_state_dict("policy", store_name=store)
        marker = await tst.get("policy/MAPPING", store_name=store)
        keys = await tst.keys("policy", store_name=store)
        targets = map_leaves(
            lambda v: torch.zeros(v.shape, dtype=bf16) if isinstance(v, torch.Tensor) else v, src
        )
        # The buffered path also lands in caller tensors, in place.
        into = await tst.get_state_dict("policy", targets, store_name=store)
        assert into["embed"] is targets["embed"]
        assert_trees_bit_equal(targets, buffered)
        await tst.put_state_dict(
            "policy_direct", src, transfer_dtype=bf16, direct=True, store_name=store
        )
        await tst.get_state_dict("policy_direct", targets, direct=True, store_name=store)
        direct = map_leaves(lambda v: v.clone() if isinstance(v, torch.Tensor) else v, targets)
        for leaf in port_flatten(src)[0].values():
            if isinstance(leaf, torch.Tensor):
                leaf.add_(1.0)
        await tst.put_state_dict(
            "policy_direct", src, transfer_dtype=bf16, direct=True, store_name=store
        )
        await tst.get_state_dict("policy_direct", targets, direct=True, store_name=store)
        direct_keys = await tst.keys("policy_direct", store_name=store)
    finally:
        await tst.shutdown(store)
    return dict(
        buffered=buffered, marker=marker, keys=keys, direct=direct,
        refreshed=targets, direct_keys=direct_keys, pids=pids,
    )


def own_segments(pids) -> list[str]:
    names = os.listdir(port_shm.SHM_DIR)
    return [
        n for n in names
        if n.startswith(port_shm.PREFIX) and int(n[len(port_shm.PREFIX):].split("_")[0]) in pids
    ]


@pytest.mark.parametrize("shm", [True, False], ids=["shm", "rpc_tcp"])
async def test_weight_sync_round_trip_matches_reference(shm, monkeypatch):
    tree = numpy_tree(seed=1)
    with anyio.fail_after(TIMEOUT_S):
        ref = await run_reference(tree, monkeypatch)
        port = await run_port(tree, shm)
    assert_trees_bit_equal(port["buffered"], ref["buffered"])
    assert_trees_bit_equal(port["direct"], ref["direct"])
    assert_trees_bit_equal(port["refreshed"], ref["refreshed"])
    # The refresh really moved the weights.
    assert not np.array_equal(bits(port["direct"]["embed"]), bits(port["refreshed"]["embed"]))
    assert port["marker"] == ref["marker"]
    assert port["keys"] == ref["keys"]
    assert port["direct_keys"] == ref["direct_keys"]
    assert port_flatten(tst.from_numpy_tree(tree, "cpu"))[1] == ref_flatten(tree)[1]
    assert own_segments(set(port["pids"]) | {os.getpid()}) == []


async def test_single_key_ops_and_errors():
    store = f"port_{uuid.uuid4().hex[:8]}"
    with anyio.fail_after(TIMEOUT_S):
        await tst.initialize(store_name=store)
        try:
            pids = [p.pid for p in multiprocessing.active_children()]
            assert len(pids) >= 2  # a volume and the controller
            small = torch.arange(12, dtype=torch.float32).reshape(3, 4)
            large = torch.randn(256, 256, generator=torch.Generator().manual_seed(0))
            await tst.put("small", small, store_name=store)
            await tst.put("large", large, store_name=store)
            await tst.put("obj", {"lr": 1e-3, "names": ["a", "b"]}, store_name=store)
            assert torch.equal(await tst.get("small", store_name=store), small)
            zero_copy = await tst.get("large", store_name=store)
            assert torch.equal(zero_copy, large)
            zero_copy.mul_(0)  # a reader's writes never reach the store
            assert torch.equal(await tst.get("large", store_name=store), large)
            target = torch.empty(256, 256)
            assert await tst.get("large", target, store_name=store) is target
            assert torch.equal(target, large)
            assert await tst.get("obj", store_name=store) == {"lr": 1e-3, "names": ["a", "b"]}
            assert await tst.keys(store_name=store) == ["large", "obj", "small"]
            assert await tst.exists("large", store_name=store)
            # Overwrite with a new shape, then delete.
            await tst.put("large", large[:8], store_name=store)
            assert torch.equal(await tst.get("large", store_name=store), large[:8])
            await tst.delete("large", store_name=store)
            assert not await tst.exists("large", store_name=store)
            with pytest.raises(KeyError):
                await tst.get("large", store_name=store)
            with pytest.raises(tst.NoMatchingPush):
                await tst.get_state_dict("never_pushed", store_name=store)
            with pytest.raises(tst.NoMatchingPush):
                await tst.get_state_dict(
                    "never_pushed", {"w": torch.zeros(2)}, direct=True, store_name=store
                )
            with pytest.raises(ValueError, match="reserved"):
                await tst.put_state_dict("bad", {"MAPPING": torch.zeros(1)}, store_name=store)
            await tst.put_state_dict("sd", {"w": torch.ones(4)}, store_name=store)
            with pytest.raises(ValueError, match="not present"):
                await tst.get_state_dict("sd", {"w": torch.zeros(4), "x": torch.zeros(1)},
                                         store_name=store)
        finally:
            await tst.shutdown(store)
    assert own_segments(set(pids) | {os.getpid()}) == []


def test_from_numpy_tree_bf16_forms():
    x = np.array([1.0, 1.00390625, -2.5, np.inf], np.float32)
    as_bits = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    from_bits = tst.from_numpy_tree({"w": as_bits}, "cpu", dtype=torch.bfloat16)["w"]
    from_f32 = tst.from_numpy_tree({"w": x}, "cpu", dtype=torch.bfloat16)["w"]
    from_ml = tst.from_numpy_tree({"w": x.astype(ml_dtypes.bfloat16)}, "cpu")["w"]
    for t in (from_bits, from_f32, from_ml):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(bits(t), as_bits)
    tree = tst.from_numpy_tree(
        {"a": [np.zeros(2, np.int64), (np.ones(1, np.float32), 3)]}, "cpu"
    )
    assert tree["a"][0].dtype == torch.int64 and isinstance(tree["a"][1], tuple)
    assert tree["a"][1][1] == 3
