"""The port's RL example (``torchstore_tpu_torch/examples/torchstore_rl.py``)
on the CPU at the tiny Llama, and the sharding rules it lays its
generators out with, held to the JAX package's ``parallel`` module.

- ``shard_params`` gives each mesh coordinate the box JAX's
  ``shard_params`` (``NamedSharding`` over the 8 CPU devices the tests
  run with) gives the same device, for ``{"tp": 8}``, ``{"fsdp": 4}`` and
  ``{"fsdp": 2, "tp": 4}``; ``logical_to_mesh_axes`` matches too.
- ``main`` runs a learner and two generators as actor processes for three
  steps with a bf16 transfer: the loss falls, every generator decodes the
  tokens of a local bf16 copy of the learner's weights, every target is
  filled in place, and no process is left.
"""

import asyncio
import dataclasses
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchstore_tpu import parallel as ref_parallel
from torchstore_tpu.models.llama import Llama as RefLlama
from torchstore_tpu.models.llama import LlamaConfig as RefConfig
from torchstore_tpu_torch import parallel
from torchstore_tpu_torch.examples import torchstore_rl
from torchstore_tpu_torch.models.llama import Llama, LlamaConfig, init_params

MESHES = [{"tp": 8}, {"fsdp": 4}, {"fsdp": 2, "tp": 4}]


def jax_boxes(mesh_shape: dict) -> dict:
    """{port key: {mesh coordinate: (offsets, local shape)}} of the flax
    tiny Llama placed by the JAX package's shard_params."""
    mesh = ref_parallel.make_mesh(mesh_shape)
    boxed = RefLlama(RefConfig.tiny()).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))
    placed = ref_parallel.unbox(ref_parallel.shard_params(boxed, mesh))
    out = {}
    for path, arr in jax.tree_util.tree_flatten_with_path(placed)[0]:
        names = [p.key for p in path]
        key = ".".join(names[1:])  # drop the "params" collection
        boxes = {}
        for shard in arr.addressable_shards:
            coords = tuple(int(c) for c in np.argwhere(mesh.devices == shard.device)[0])
            offsets = tuple(s.start or 0 for s in shard.index)
            local = tuple(shard.data.shape)
            boxes[coords] = (offsets, local)
        out[key] = boxes
    return out


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda m: "x".join(f"{k}{v}" for k, v in m.items()))
def test_shard_params_boxes_match_jax(mesh_shape):
    want = jax_boxes(mesh_shape)
    model = init_params(LlamaConfig.tiny(), torch.Generator().manual_seed(0), "cpu")
    trees = parallel.shard_params(model, mesh_shape)
    assert len(trees) == int(np.prod(list(mesh_shape.values())))
    assert set(want) == set(trees[0])
    state = model.state_dict()
    for tree in trees:
        for key, shard in tree.items():
            ts = shard.tensor_slice
            assert want[key][ts.coordinates] == (ts.offsets, ts.local_shape), key
            assert ts.mesh_shape == tuple(mesh_shape.values())
            # A view of the parameter: a get into it fills the model.
            assert shard.data.untyped_storage().data_ptr() == \
                state[key].untyped_storage().data_ptr()
            assert torch.equal(shard.data, state[key][ts.box.to_index()])


@pytest.mark.parametrize("axes", [("embed", "heads", None), ("vocab", "embed"), ("mlp", "embed"),
                                  ("heads", None, "embed"), (None,), ("embed", "mlp", "mlp")])
@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda m: "x".join(m))
def test_logical_to_mesh_axes_matches_jax(axes, mesh_shape):
    mesh = ref_parallel.make_mesh(mesh_shape)
    want = tuple(ref_parallel.logical_to_mesh_axes(axes, mesh))
    assert parallel.logical_to_mesh_axes(axes, tuple(mesh_shape)) == want


def test_logical_axes_match_the_flax_boxes():
    boxed = RefLlama(RefConfig.tiny()).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))
    from flax.core import meta

    want = {}
    leaves = jax.tree_util.tree_flatten_with_path(
        boxed, is_leaf=lambda x: isinstance(x, meta.Partitioned))[0]
    for path, leaf in leaves:
        want[".".join(p.key for p in path[1:])] = tuple(leaf.names)
    assert Llama(LlamaConfig.tiny(), "cpu").logical_axes() == want


@pytest.fixture(scope="module")
def rl_run():
    before = {p.pid for p in multiprocessing.active_children()}
    records = asyncio.run(asyncio.wait_for(
        torchstore_rl.main(device="cpu", steps=3, transfer_dtype=torch.bfloat16), timeout=300))
    alive = [p.pid for p in multiprocessing.active_children() if p.pid not in before]
    return records, alive


def test_rl_example_loss_falls(rl_run):
    records, _ = rl_run
    losses = [r["loss"] for r in records]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert [r["version"] for r in records] == [0, 1, 2]


def test_rl_example_generators_agree_with_local_decoder(rl_run):
    records, _ = rl_run
    for r in records:
        gens = r["generators"]
        assert len(gens) == 2
        for g in gens:
            assert g["versions"] == [r["version"]]  # every tp rank got this version
            assert g["tokens"] == r["local_tokens"]
            assert g["copies"] == 0  # every target filled in place
            assert g["targets"] == 8 * 21  # 8 tp ranks x the tiny Llama's 21 tensors


def test_rl_example_leaves_no_process(rl_run):
    assert rl_run[1] == []


def test_rl_example_main_defaults_to_the_card():
    import inspect

    assert inspect.signature(torchstore_rl.main).parameters["device"].default == "cuda"
    cfg = dataclasses.replace(LlamaConfig.tiny(), param_dtype=torch.float32)
    assert torchstore_rl._generator_config(cfg, torch.bfloat16).param_dtype == torch.bfloat16
