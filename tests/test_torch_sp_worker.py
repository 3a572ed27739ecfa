"""Multi-rank drives of the port's sequence-parallel code on the CPU:
``spawn(job, args)`` starts 4 ranks over gloo on an ephemeral port, each
runs ``JOBS[job](rank, args)``, and the per-rank results come back as numpy
arrays. This module imports torch and numpy only, so the spawned ranks load
no JAX; the test files hold the results against the JAX package. It holds
no tests itself."""

from __future__ import annotations

import datetime
import multiprocessing
import socket
import traceback

import numpy as np
import torch
import torch.distributed as dist

WORLD = 4
TIMEOUT_S = 240


def qkv_inputs(seed: int, b: int, s: int, h: int, hk: int, d: int) -> tuple:
    """q (b, s, h, d), k and v (b, s, hk, d) fp32 from a numpy seed, and
    the loss weights cos(arange) of the reference ring gradient tests."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hk, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hk, d)).astype(np.float32)
    w = np.cos(np.arange(q.size, dtype=np.float32)).reshape(q.shape)
    return q, k, v, w


# (name, seed, (b, s, h, hk, d), body, impl, causal, dtype)
ATTENTION_CASES = [
    (f"ring-{impl}-{'causal' if causal else 'full'}-{heads}", seed, shape, "ring", impl, causal,
     "float32")
    for impl in ("fused", "einsum")
    for causal in (False, True)
    for heads, seed, shape in (("mha", 0, (2, 64, 4, 4, 16)), ("gqa", 7, (2, 64, 8, 2, 16)))
] + [
    ("ring-auto-bf16", 3, (2, 64, 4, 4, 16), "ring", "auto", False, "bfloat16"),
    ("ring-sp1-causal", 4, (2, 32, 4, 4, 16), "ring_sp1", "auto", True, "float32"),
] + [
    (f"ulysses-{'causal' if causal else 'full'}-{heads}", 11, shape, "ulysses", None, causal,
     "float32")
    for causal in (False, True)
    for heads, shape in (("mha", (2, 64, 8, 8, 16)), ("gqa", (2, 64, 8, 4, 16)))
]


def _attention_job(rank: int, args) -> dict:
    from torchstore_tpu_torch.ops import ring_attention_sharded, ulysses_attention_sharded
    from torchstore_tpu_torch.parallel import make_mesh

    mesh = make_mesh({"sp": WORLD}, "cpu")
    mesh_sp1 = make_mesh({"dp": WORLD, "sp": 1}, "cpu")
    out = {}
    for name, seed, (b, s, h, hk, d), body, impl, causal, dtype in ATTENTION_CASES:
        q, k, v, w = qkv_inputs(seed, b, s, h, hk, d)
        dt = getattr(torch, dtype)
        qt, kt, vt = (torch.from_numpy(x).to(dt).requires_grad_() for x in (q, k, v))
        if body == "ulysses":
            o = ulysses_attention_sharded(qt, kt, vt, mesh, "sp", causal=causal)
        else:
            m = mesh_sp1 if body == "ring_sp1" else mesh
            o = ring_attention_sharded(qt, kt, vt, m, "sp", causal=causal, impl=impl)
        (o.float() * torch.from_numpy(w)).sum().backward()
        out[name] = {
            "out": o.detach().float().numpy(),
            **{f"d{n}": t.grad.float().numpy() for n, t in (("q", qt), ("k", kt), ("v", vt))},
        }
    return out


def _llama_job(rank: int, args) -> dict:
    """args: the tiny config's overrides, the flax params as a state dict
    of numpy arrays, the logit cases and the train-step tokens."""
    import dataclasses

    from torchstore_tpu_torch.models.llama import Llama, LlamaConfig
    from torchstore_tpu_torch.parallel import make_mesh, make_train_step

    mesh = make_mesh({"sp": WORLD}, "cpu")
    out = {}
    for name, (kv_heads, impl, params, tokens) in args["logits"].items():
        cfg = dataclasses.replace(
            LlamaConfig.tiny(), num_kv_heads=kv_heads, dtype=torch.float32,
            param_dtype=torch.float32, attn_impl=impl, mesh=mesh,
        )
        model = Llama(cfg, "cpu")
        model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
        with torch.no_grad():
            out[name] = model(torch.from_numpy(tokens)).numpy()
    params, tokens = args["train"]
    cfg = dataclasses.replace(
        LlamaConfig.tiny(), dtype=torch.float32, param_dtype=torch.float32, attn_impl="ring",
        mesh=mesh,
    )
    model = Llama(cfg, "cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4, eps=1e-8)
    loss = make_train_step(model, opt)(torch.from_numpy(tokens))
    out["train"] = {
        "loss": loss.numpy(),
        **{k: v.detach().numpy() for k, v in model.state_dict().items()},
    }
    return out


JOBS = {"attention": _attention_job, "llama": _llama_job}


def _rank_main(rank: int, init_method: str, job: str, args, queue) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=init_method, world_size=WORLD, rank=rank,
            timeout=datetime.timedelta(seconds=TIMEOUT_S),
        )
        try:
            queue.put((rank, JOBS[job](rank, args), None))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        queue.put((rank, None, traceback.format_exc()))


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def spawn(job: str, args=None) -> list:
    """Run ``job`` on WORLD gloo ranks; the list of per-rank results."""
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    init = f"tcp://127.0.0.1:{_free_port()}"
    procs = [
        ctx.Process(target=_rank_main, args=(r, init, job, args, queue), daemon=True)
        for r in range(WORLD)
    ]
    for p in procs:
        p.start()
    results: list = [None] * WORLD
    try:
        for _ in range(WORLD):
            rank, res, err = queue.get(timeout=TIMEOUT_S)
            if err is not None:
                raise RuntimeError(f"rank {rank} of job {job!r} failed:\n{err}")
            results[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return results
