"""Multi-rank drives of the port's sequence-parallel code on the CPU:
``spawn(job, args)`` starts 4 ranks over gloo on an ephemeral port, each
runs ``JOBS[job](rank, args)``, and the per-rank results come back as numpy
arrays. ``IpcDest`` is a direct-sync dest in a process of its own, which
pulls a source's card-side staging over CUDA IPC on request.
``spmd_lifecycle`` launches a torchrun-style world of ranks that bring a
store up with ``initialize_spmd`` and exchange shards. This module
imports torch and numpy only, so the spawned processes load no JAX; the
test files hold the results against the JAX package. It holds no tests
itself."""

from __future__ import annotations

import asyncio
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
    # Phi-3-mini's head dim, which the card runs zero-padded on the d = 128
    # instances of the tensor-core kernels.
    ("ring-auto-causal-d96", 5, (1, 64, 4, 2, 96), "ring", "auto", True, "float32"),
    ("ring-auto-bf16-d96", 6, (1, 64, 4, 4, 96), "ring", "auto", False, "bfloat16"),
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


def _dtensor_job(rank: int, args) -> dict:
    """args: the store's controller and a global array. Each rank puts its
    Shard(0) shard on a (4,) mesh, then gets its (Shard(0), Shard(1)) shard
    on a (2, 2) mesh in place, through a client of the one store."""
    import asyncio

    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    from torchstore_tpu_torch.client import LocalClient

    g = torch.from_numpy(args["global"])

    async def run() -> dict:
        client = LocalClient(args["controller"])
        src = distribute_tensor(g, init_device_mesh("cpu", (WORLD,)), [Shard(0)],
                                src_data_rank=None)
        await client.put("w", src)
        dist.barrier()  # every coordinate stored before any rank reads
        mesh = init_device_mesh("cpu", (2, 2))
        target = distribute_tensor(torch.zeros_like(g), mesh, [Shard(0), Shard(1)],
                                   src_data_rank=None)
        got = await client.get("w", target)
        return {
            "coords": mesh.get_coordinate(),
            "local": target.to_local().numpy().copy(),
            "filled_in_place": got is target,
            "full": target.full_tensor().numpy(),
        }

    return asyncio.run(run())


JOBS = {"attention": _attention_job, "llama": _llama_job, "dtensor": _dtensor_job}


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


def _as_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _ipc_dest_main(infos, targets, requests, replies) -> None:
    """Pull ``infos`` into ``targets`` ({key: (shape, dtype name, card
    index)}) once per request, until ``None``; reply ("ok", {key: numpy},
    blocks opened so far) or ("error", exception type, message)."""
    import asyncio

    from torchstore_tpu_torch.direct_weight_sync import DirectWeightSyncDest
    from torchstore_tpu_torch.transport import device_transfer as dt

    async def run():
        dest = DirectWeightSyncDest()
        sd = {k: torch.zeros(shape, dtype=getattr(torch, dtype), device=f"cuda:{card}")
              for k, (shape, dtype, card) in targets.items()}
        try:
            while requests.get(timeout=TIMEOUT_S) is not None:
                try:
                    out = await dest.pull_device(infos, sd)
                    replies.put(("ok", {k: _as_numpy(v) for k, v in out.items()},
                                 dt.DeviceTransferEngine.get().opens))
                except Exception as exc:  # noqa: BLE001 - reported to the parent
                    replies.put(("error", type(exc).__name__, str(exc)))
        finally:
            await dest.close()

    try:
        asyncio.run(run())
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        replies.put(("error", "crash", traceback.format_exc()))


class IpcDest:
    """A dest process: ``pull()`` asks it for one pull and returns its
    reply; ``close()`` ends it."""

    def __init__(self, infos, targets) -> None:
        ctx = multiprocessing.get_context("spawn")
        self.requests, self.replies = ctx.Queue(), ctx.Queue()
        self.proc = ctx.Process(target=_ipc_dest_main,
                                args=(infos, targets, self.requests, self.replies), daemon=True)
        self.proc.start()

    def pull(self):
        self.requests.put(True)
        return self.replies.get(timeout=TIMEOUT_S)

    def close(self) -> None:
        self.requests.put(None)
        self.proc.join(timeout=30)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join(timeout=10)


# --------------------------------------------------------------------------
# an SPMD world: torchrun-style env, initialize_spmd, put, barrier, get
# --------------------------------------------------------------------------

SPMD_STORE = "tst_spmdtest"


def spmd_env(rank: int, world: int, local_world: int, port: int, secret=None,
             hostnames: bool = False) -> dict:
    """The launcher env of one rank (torchrun's names). With several hosts
    the volumes bind every address and advertise loopback; ``hostnames``
    gives each emulated host its own name, so reads across hosts take the
    bulk rung."""
    env = {"RANK": str(rank), "LOCAL_RANK": str(rank % local_world), "WORLD_SIZE": str(world),
           "LOCAL_WORLD_SIZE": str(local_world), "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(port)}
    if local_world != world:
        env["TORCHSTORE_TORCH_ADVERTISE_HOST"] = "127.0.0.1"
        if hostnames:
            env["TORCHSTORE_TORCH_HOSTNAME"] = f"tst-spmd-host{rank // local_world}"
    if secret:
        env["TORCHSTORE_TORCH_AUTH_SECRET"] = secret
    return env


async def _spmd_scenario(rank: int, world: int) -> dict:
    import torchstore_tpu_torch as ts
    from torchstore_tpu_torch.observability import metrics

    await ts.initialize_spmd(store_name=SPMD_STORE)
    g = torch.arange(float(world * 4), dtype=torch.float32).reshape(world, 4)
    sl = ts.TensorSlice(offsets=(rank, 0), local_shape=(1, 4), global_shape=(world, 4),
                        coordinates=(rank,), mesh_shape=(world,))
    await ts.put("g", ts.Shard(g[rank:rank + 1].clone(), sl), store_name=SPMD_STORE)
    await ts.put(f"r{rank}", torch.full((2,), float(rank), dtype=torch.float64),
                 store_name=SPMD_STORE)
    await ts.barrier("puts_done", store_name=SPMD_STORE)
    bulk_gets = metrics.counter("ts_transport_ops_total")
    before = bulk_gets.value(transport="bulk", op="get")
    other = (rank + 1) % world
    peer = await ts.get(f"r{other}", store_name=SPMD_STORE)
    full = await ts.get("g", store_name=SPMD_STORE)
    out = {"peer": peer.numpy().tolist(), "full": full.numpy().tolist(),
           "bulk_gets": bulk_gets.value(transport="bulk", op="get") - before}
    await ts.barrier("reads_done", store_name=SPMD_STORE)
    await ts.shutdown(SPMD_STORE)
    await asyncio.sleep(0.2)
    out["children_left"] = [p.pid for p in multiprocessing.active_children()]
    return out


def _spmd_rank_main(rank: int, world: int, env: dict, queue, scenario=None, args=()) -> None:
    import os

    os.environ.update(env)
    try:
        queue.put((rank, asyncio.run((scenario or _spmd_scenario)(rank, world, *args)), None))
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        queue.put((rank, None, traceback.format_exc()))


def _run_ranks(world: int, envs: list, timeout: float, scenario=None, args=()) -> list:
    """Start one spawned process per rank with its env; the per-rank
    results. Each rank has its own join timeout; a rank left alive is
    killed."""
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_spmd_rank_main, args=(r, world, envs[r], queue, scenario, args))
             for r in range(world)]
    for p in procs:
        p.start()
    results: list = [None] * world
    try:
        for _ in range(world):
            rank, res, err = queue.get(timeout=timeout)
            if err is not None:
                raise RuntimeError(f"spmd rank {rank} failed:\n{err}")
            results[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return results


def spmd_lifecycle(world: int, local_world: int, secret=None, hostnames: bool = False,
                   timeout: float = 180.0) -> list:
    """Launch ``world`` ranks (``local_world`` a host) on an ephemeral
    rendezvous port; the list of per-rank results."""
    port = _free_port()
    return _run_ranks(world, [spmd_env(r, world, local_world, port, secret, hostnames)
                              for r in range(world)], timeout)


DURABLE_STORE = "tst_dspmd"


async def _spmd_durable_scenario(rank: int, world: int, storage: str, phase: str) -> dict:
    """test_spmd_durable_recovery's two phases. ``write``: every rank puts
    its key into a durable store, then the world exits without the
    collective shutdown (a crash: the volumes are killed, nothing is torn
    down). ``recover``: a fresh world over the same directory rebuilds the
    index and every rank reads every rank's key."""
    import torchstore_tpu_torch as ts
    from torchstore_tpu_torch import spmd

    if phase == "write":
        await ts.initialize_spmd(store_name=DURABLE_STORE, storage_dir=storage)
        await ts.put(f"r{rank}", torch.full((4,), float(rank), dtype=torch.float64),
                     store_name=DURABLE_STORE)
        await ts.barrier("puts", store_name=DURABLE_STORE)
        session = spmd._spmd_sessions[DURABLE_STORE]
        # The other ranks confirm no rendezvous request is in flight before
        # rank 0, which hosts the rendezvous server, crashes.
        if rank != 0:
            await session.client.add("drained", 1)
        else:
            await session.client.wait_counter("drained", world - 1)
        if session.volume_mesh is not None:
            for proc in session.volume_mesh._processes:
                proc.terminate()
                proc.join(10)
        return {"wrote": rank}
    await ts.initialize_spmd(store_name=DURABLE_STORE, storage_dir=storage, recover=True)
    reads = [(await ts.get(f"r{other}", store_name=DURABLE_STORE)).tolist()
             for other in range(world)]
    keys = await ts.keys(store_name=DURABLE_STORE)
    await ts.barrier("reads", store_name=DURABLE_STORE)
    await ts.shutdown(DURABLE_STORE)
    await asyncio.sleep(0.2)
    return {"reads": reads, "keys": sorted(keys),
            "children_left": [p.pid for p in multiprocessing.active_children()]}


def spmd_durable(world: int, storage: str, phase: str, timeout: float = 180.0) -> list:
    """One phase of the durable world (one host, ``world`` ranks)."""
    port = _free_port()
    return _run_ranks(world, [spmd_env(r, world, world, port) for r in range(world)], timeout,
                      _spmd_durable_scenario, (storage, phase))
