"""Port parity for the model side: the Llama (torchstore_tpu_torch.models),
its train step and its KV-cached decoder, against the flax Llama of the JAX
package with the same weights (``params_from_flax``) on the same tokens.

Tolerances: logits rtol/atol 1e-4 at dtype = param_dtype = float32; at the
default bf16 compute, atol 0.05 and rtol 0.05 (both frameworks round every
product and activation to bf16, at other places); one AdamW step against
``optax.adamw(1e-3)``: loss rtol 1e-5, parameters atol 5e-5 (the update is
lr * g / (|g| + eps) on a first step, about lr * sign(g): fp32 differences
in g move a parameter by far less than lr, except where |g| is near eps =
1e-8, where they move it by up to a few percent of lr); greedy tokens
equal. The 4-rank cases
(ring and Ulysses attention inside the model) run in one spawn of gloo
ranks (``test_torch_sp_worker``) and are held at 5e-4, as tests/test_models.py
holds the JAX package's own sequence-parallel logits.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import test_torch_sp_worker as worker

from torchstore_tpu import parallel as ref_parallel
from torchstore_tpu.models.generate import Decoder as RefDecoder
from torchstore_tpu.models.generate import forward_key_order as ref_forward_key_order
from torchstore_tpu.models.llama import Llama as RefLlama
from torchstore_tpu.models.llama import LlamaConfig as RefConfig
from torchstore_tpu_torch.models.generate import Decoder, forward_key_order
from torchstore_tpu_torch.models.llama import Llama, LlamaConfig, init_params, params_from_flax
from torchstore_tpu_torch.parallel import make_train_step
from torchstore_tpu_torch.workloads import llama3_8b_config

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# name -> (config classmethod, overrides)
CONFIGS = {
    "llama": ("tiny", {}),
    "llama-gqa": ("tiny", {"num_kv_heads": 4}),
    "gemma": ("tiny_gemma", {}),
    "qwen-bias": ("tiny", {"num_kv_heads": 2, "attention_bias": True}),
}


def configs(name, dtype="float32", param_dtype="float32", **extra):
    """The same configuration in both packages."""
    method, overrides = CONFIGS[name]
    kw = {**overrides, **extra}
    ref = dataclasses.replace(getattr(RefConfig, method)(), dtype=DTYPES[dtype][1],
                              param_dtype=DTYPES[param_dtype][1], **kw)
    port = dataclasses.replace(getattr(LlamaConfig, method)(), dtype=DTYPES[dtype][0],
                               param_dtype=DTYPES[param_dtype][0], **kw)
    return ref, port


def tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def flax_params(ref_cfg, seed=0):
    """The flax model's initial params as a numpy tree."""
    variables = RefLlama(ref_cfg).init(jax.random.key(seed), jnp.zeros((1, 8), jnp.int32))
    return jax.tree.map(np.asarray, ref_parallel.unbox(variables))


def port_model(port_cfg, tree):
    model = Llama(port_cfg, "cpu")
    model.load_state_dict(params_from_flax(tree))
    return model


@pytest.mark.parametrize("name", CONFIGS)
def test_state_dict_layout_matches_flax(name):
    ref_cfg, port_cfg = configs(name)
    tree = flax_params(ref_cfg)
    flat = params_from_flax(tree)
    model = Llama(port_cfg, "cpu")
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in flat.items()} == want
    assert flat["layer_0.attn.q_proj.kernel"].shape == (64, port_cfg.num_heads, 8)
    assert flat["layer_0.attn.o_proj.kernel"].shape == (port_cfg.num_heads, 8, 64)


@pytest.mark.parametrize("name", CONFIGS)
def test_logits_match_flax_fp32(name):
    ref_cfg, port_cfg = configs(name)
    tree = flax_params(ref_cfg, seed=1)
    toks = tokens(2, (2, 16))
    want = RefLlama(ref_cfg).apply(tree, jnp.asarray(toks))
    with torch.no_grad():
        got = port_model(port_cfg, tree)(torch.from_numpy(toks).long())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["llama", "gemma"])
def test_logits_match_flax_bf16(name):
    ref_cfg, port_cfg = configs(name, dtype="bfloat16")
    tree = flax_params(ref_cfg, seed=3)
    toks = tokens(4, (2, 16))
    want = RefLlama(ref_cfg).apply(tree, jnp.asarray(toks))
    with torch.no_grad():
        got = port_model(port_cfg, tree)(torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0.05, atol=0.05)


def test_bf16_params_carry_across():
    ref_cfg, port_cfg = configs("llama", dtype="bfloat16", param_dtype="bfloat16")
    tree = flax_params(ref_cfg)
    flat = params_from_flax(tree)
    kernel = tree["params"]["layer_0"]["mlp"]["up_proj"]["kernel"]
    assert flat["layer_0.mlp.up_proj.kernel"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        flat["layer_0.mlp.up_proj.kernel"].view(torch.int16).numpy(), kernel.view(np.int16)
    )
    port_model(port_cfg, tree)  # loads without a dtype or shape complaint


def test_train_step_matches_optax():
    ref_cfg, port_cfg = configs("llama")
    tree = flax_params(ref_cfg, seed=5)
    toks = tokens(6, (4, 17))
    opt = optax.adamw(1e-3)
    step = ref_parallel.make_train_step(RefLlama(ref_cfg), opt)
    params = jax.tree.map(jnp.asarray, tree)
    new_params, _, want_loss = step(params, opt.init(params), jnp.asarray(toks))
    model = port_model(port_cfg, tree)
    port_opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4, eps=1e-8)
    loss = make_train_step(model, port_opt)(torch.from_numpy(toks).long())
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    want = params_from_flax(jax.tree.map(np.asarray, new_params))
    for key, val in model.state_dict().items():
        np.testing.assert_allclose(val.numpy(), want[key].numpy(), rtol=0, atol=5e-5, err_msg=key)


@pytest.mark.parametrize("name", ["llama", "llama-gqa", "gemma"])
def test_greedy_decode_matches_jax_decoder(name):
    ref_cfg, port_cfg = configs(name)
    tree = flax_params(ref_cfg, seed=7)
    prompt = tokens(8, (2, 5))
    want = RefDecoder(ref_cfg, max_len=16).generate(tree, jnp.asarray(prompt), max_new_tokens=6)
    got = Decoder(port_cfg, max_len=16, device="cpu").generate(
        port_model(port_cfg, tree), prompt, max_new_tokens=6
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def greedy_recompute(model, prompt, steps):
    """Oracle: argmax decode recomputing the FULL forward every step."""
    toks = torch.as_tensor(prompt, dtype=torch.int64)
    with torch.no_grad():
        for _ in range(steps):
            nxt = model(toks)[:, -1, :].argmax(dim=-1, keepdim=True)
            toks = torch.cat([toks, nxt], dim=1)
    return toks


@pytest.mark.parametrize("name", ["llama", "gemma", "qwen-bias"])
def test_cached_decode_matches_full_recompute(name):
    _, port_cfg = configs(name)
    model = init_params(port_cfg, torch.Generator().manual_seed(0), "cpu")
    prompt = tokens(9, (2, 5))
    want = greedy_recompute(model, prompt, steps=6)
    got = Decoder(port_cfg, max_len=16, device="cpu").generate(model, prompt, max_new_tokens=6)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_decoder_errors_and_sampling():
    _, port_cfg = configs("llama")
    model = init_params(port_cfg, torch.Generator().manual_seed(0), "cpu")
    dec = Decoder(port_cfg, max_len=12, device="cpu")
    prompt = torch.zeros((2, 3), dtype=torch.int64)
    a = dec.generate(model, prompt, 4, temperature=0.8, generator=torch.Generator().manual_seed(7))
    b = dec.generate(model, prompt, 4, temperature=0.8, generator=torch.Generator().manual_seed(7))
    assert a.shape == (2, 7)
    torch.testing.assert_close(a, b, rtol=0, atol=0)  # same generator seed
    with pytest.raises(ValueError, match="torch.Generator"):
        dec.generate(model, prompt, 2, temperature=0.5)
    with pytest.raises(ValueError, match="exceeds the cache"):
        dec.generate(model, torch.zeros((1, 5), dtype=torch.int64), max_new_tokens=8)
    with pytest.raises(ValueError, match="batch, len"):
        dec.generate(model, torch.zeros(5, dtype=torch.int64), max_new_tokens=1)


@pytest.mark.parametrize("name", ["llama", "gemma"])
def test_forward_key_order_matches_reference(name):
    ref_cfg, port_cfg = configs(name, num_layers=12)
    want = ref_forward_key_order(flax_params(ref_cfg))
    got = forward_key_order(Llama(port_cfg, "cpu").state_dict())
    assert got == [k.removeprefix("params/").replace("/", ".") for k in want]


def test_init_follows_flax_distributions():
    _, port_cfg = configs("gemma", hidden_size=256, intermediate_size=512)
    model = init_params(port_cfg, torch.Generator().manual_seed(0), "cpu")
    sd = model.state_dict()
    assert abs(float(sd["embed.embedding"].std()) - 0.02) < 0.002
    for key, fan_in in (("layer_0.attn.q_proj.kernel", 256), ("layer_0.attn.o_proj.kernel", 64),
                        ("layer_0.mlp.down_proj.kernel", 512)):
        std = float(sd[key].std())
        assert abs(std * fan_in**0.5 - 1.0) < 0.1, key
        assert float(sd[key].abs().max()) <= 2.0 / 0.87962566103423978 / fan_in**0.5 + 1e-6
    assert torch.equal(sd["final_norm.scale"], torch.zeros(256))  # Gemma offset
    _, llama_cfg = configs("llama")
    llama = init_params(llama_cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(llama.state_dict()["final_norm.scale"], torch.ones(64))


def test_moe_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Llama(LlamaConfig.tiny_moe(), "cpu")


def test_llama3_8b_config_cuts_depth_only():
    cfg = llama3_8b_config(4)
    full = LlamaConfig.llama3_8b()
    assert cfg.num_layers == 4
    assert dataclasses.replace(cfg, num_layers=full.num_layers) == full


# --- ring and Ulysses attention inside the model, on 4 gloo ranks -----------

SP_CASES = {  # name -> (kv heads, attn_impl)
    "ring-mha": (8, "ring"),
    "ring-gqa": (4, "ring"),
    "ulysses-mha": (8, "ulysses"),
    "ulysses-gqa": (4, "ulysses"),
    "ulysses-falls-back-to-ring": (2, "ulysses"),
}
SP_TOKENS = tokens(10, (2, 32))  # 8 tokens per rank: the ring takes its fused body
TRAIN_TOKENS = tokens(11, (2, 33))


def sp_trees():
    trees = {}
    for name, (kv, _) in SP_CASES.items():
        ref_cfg, _ = configs("llama", num_kv_heads=kv)
        trees[name] = flax_params(ref_cfg, seed=kv)
    return trees


@pytest.fixture(scope="module")
def sp_runs():
    trees = sp_trees()
    flat = {n: {k: v.numpy() for k, v in params_from_flax(t).items()} for n, t in trees.items()}
    train = {k: v.numpy() for k, v in params_from_flax(flax_params(configs("llama")[0], 12)).items()}
    args = {
        "logits": {n: (kv, impl, flat[n], SP_TOKENS) for n, (kv, impl) in SP_CASES.items()},
        "train": (train, TRAIN_TOKENS),
    }
    return worker.spawn("llama", args), trees


@pytest.mark.parametrize("name", SP_CASES)
def test_sequence_parallel_logits_match_dense_and_reference(sp_runs, name):
    results, trees = sp_runs
    kv, impl = SP_CASES[name]
    ref_cfg, port_cfg = configs("llama", num_kv_heads=kv)
    got = results[0][name]
    with torch.no_grad():
        dense = port_model(port_cfg, trees[name])(torch.from_numpy(SP_TOKENS).long()).numpy()
    np.testing.assert_allclose(got, dense, rtol=5e-4, atol=5e-4)
    mesh = ref_parallel.make_mesh({"sp": worker.WORLD})
    logger = logging.getLogger("torchstore_tpu.models.llama")
    prev, logger.disabled = logger.disabled, True  # the fallback's expected warning
    try:
        want = RefLlama(dataclasses.replace(ref_cfg, attn_impl=impl, mesh=mesh)).apply(
            trees[name], jnp.asarray(SP_TOKENS)
        )
    finally:
        logger.disabled = prev
    np.testing.assert_allclose(got, np.asarray(want), rtol=5e-4, atol=5e-4)
    for rank in range(1, worker.WORLD):
        np.testing.assert_array_equal(results[rank][name], got)


def test_ring_model_train_step_matches_dense(sp_runs):
    """Gradients flow through the model's ring attention: one AdamW step on
    4 ranks equals the dense step in one process."""
    results, _ = sp_runs
    _, port_cfg = configs("llama")
    model = port_model(port_cfg, flax_params(configs("llama")[0], 12))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4, eps=1e-8)
    loss = make_train_step(model, opt)(torch.from_numpy(TRAIN_TOKENS).long())
    got = results[0]["train"]
    np.testing.assert_allclose(got["loss"], loss.numpy(), rtol=1e-5)
    for key, val in model.state_dict().items():
        np.testing.assert_allclose(got[key], val.numpy(), rtol=0, atol=1e-5, err_msg=key)
