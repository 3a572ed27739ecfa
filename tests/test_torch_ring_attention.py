"""Port parity for sequence-parallel attention (ring and Ulysses).

One spawn of 4 gloo ranks (``test_torch_sp_worker``) runs every case of the
port's ``ring_attention_sharded`` / ``ulysses_attention_sharded`` on global
tensors; each parametrised test holds one case's output and q/k/v
gradients against the JAX package on its 4-device virtual CPU mesh (the
Pallas stats kernel in interpret mode for the fused body), on the same
numpy inputs. Tolerances: fp32 outputs 2e-5 and gradients 3e-5, as
tests/test_ring_attention.py uses against dense attention; bf16 within two
bf16 ulps (rtol 2**-6) plus 1e-3 absolute, since both packages round fp32
results that differ in their last bits to bf16.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import test_torch_sp_worker as worker
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from torchstore_tpu import parallel as ref_parallel
from torchstore_tpu.ops.ring_attention import ring_attention_sharded as ref_ring
from torchstore_tpu.ops.ulysses_attention import ulysses_attention_sharded as ref_ulysses
from torchstore_tpu_torch.ops._sharded import make_sharded_attention
from torchstore_tpu_torch.ops.ring_attention import ring_attention
from torchstore_tpu_torch.ops.ulysses_attention import ulysses_attention_sharded

CASES = {case[0]: case for case in worker.ATTENTION_CASES}


@pytest.fixture(scope="module")
def port_runs():
    return worker.spawn("attention")


def reference(case):
    """The JAX package's output and q/k/v gradients for one case."""
    _, seed, (b, s, h, hk, d), body, impl, causal, dtype = case
    q, k, v, w = worker.qkv_inputs(seed, b, s, h, hk, d)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    mesh = ref_parallel.make_mesh({"sp": 1 if body == "ring_sp1" else worker.WORLD})
    spec = NamedSharding(mesh, P(None, "sp", None, None))

    def attend(q, k, v):
        if body == "ulysses":
            return ref_ulysses(q, k, v, mesh, "sp", causal=causal)
        return ref_ring(q, k, v, mesh, "sp", causal=causal, impl=impl)

    def loss(q, k, v):
        return jnp.sum(attend(q, k, v).astype(jnp.float32) * w)

    args = [jax.device_put(jnp.asarray(x, jdt), spec) for x in (q, k, v)]
    grads = jax.grad(loss, argnums=(0, 1, 2))(*args)
    out = {"out": attend(*args)}
    out.update({f"d{n}": g for n, g in zip("qkv", grads)})
    return {key: np.asarray(val, np.float32) for key, val in out.items()}


@pytest.mark.parametrize("name", CASES)
def test_outputs_and_gradients_match_reference(port_runs, name):
    case = CASES[name]
    got = port_runs[0][name]
    want = reference(case)
    for key in ("out", "dq", "dk", "dv"):
        if case[-1] == "bfloat16":
            tol = dict(rtol=2.0**-6, atol=1e-3)
        else:
            tol = dict(rtol=2e-5, atol=2e-5) if key == "out" else dict(rtol=3e-5, atol=3e-5)
        np.testing.assert_allclose(got[key], want[key], err_msg=f"{name} {key}", **tol)


@pytest.mark.parametrize("name", CASES)
def test_every_rank_returns_the_global_result(port_runs, name):
    for rank in range(1, worker.WORLD):
        for key, val in port_runs[0][name].items():
            np.testing.assert_array_equal(port_runs[rank][name][key], val, err_msg=f"rank {rank}")


def test_single_rank_ring_degenerates_to_dense(port_runs):
    _, seed, (b, s, h, hk, d), *_ = CASES["ring-sp1-causal"]
    q, k, v, _ = worker.qkv_inputs(seed, b, s, h, hk, d)
    want = jax.nn.dot_product_attention(q, k, v, is_causal=True)
    np.testing.assert_allclose(port_runs[0]["ring-sp1-causal"]["out"], np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_fused_causal_needs_equal_lengths():
    q = torch.zeros(1, 16, 2, 8)
    kv = torch.zeros(1, 8, 2, 8)
    with pytest.raises(ValueError, match="requires equal q/kv"):
        ring_attention(q, kv, kv, group=None, causal=True, impl="fused")


def fake_mesh(size):
    """A stand-in for a DeviceMesh with one ``sp`` axis (the checks run
    before any collective)."""
    return types.SimpleNamespace(
        shape=(size,), mesh_dim_names=("sp",), get_group=lambda name: None
    )


def test_ulysses_needs_divisible_heads():
    q = torch.zeros(1, 16, 8, 8)
    kv = torch.zeros(1, 16, 2, 8)
    with pytest.raises(ValueError, match=r"k heads \(2\) divisible by the 'sp' axis size \(4\)"):
        ulysses_attention_sharded(q, kv, kv, fake_mesh(4), "sp")


def test_sharded_attention_needs_divisible_sequence():
    x = torch.zeros(1, 30, 4, 8)
    fn = make_sharded_attention(ring_attention, fake_mesh(4), "sp", causal=False)
    with pytest.raises(ValueError, match=r"sequence length \(30\) is not divisible"):
        fn(x, x, x)
