"""RL weight sync: a learner actor trains a Llama and publishes its weights;
two generator actors pull them, resharded, and decode.

The port's counterpart of ``examples/torchstore_rl.py``. The learner owns
its whole model in one process (the single-process learner of the JAX
example, whose ``fsdp`` mesh lives in one process) and publishes ``{"params":
state}`` through a ``WeightPublisher``. Each generator lays its bf16 model
out tensor-parallel (``parallel.shard_params``, ``{"tp": n}``) and, for each
of its ``n`` ranks, blocks in ``WeightSubscriber.acquire`` until a newer
version commits, pulling that rank's boxes straight into views of its
parameters: every sync reshards, in place. Both generators must decode the
same tokens. Run on the card:

    python -m torchstore_tpu_torch.examples.torchstore_rl            # tiny Llama
    python -m torchstore_tpu_torch.examples.torchstore_rl --config llama3_8b --layers 4

A learner whose shards live in several processes cannot publish one
version with one call (ROADMAP A8).
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import time
from typing import Optional

import torch

import torchstore_tpu_torch as ts
from torchstore_tpu_torch.ops import staging
from torchstore_tpu_torch.runtime import Actor, endpoint, spawn_actors

STORE = "rl_example"
CHANNEL = "policy"
STEPS = 3


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak_bytes(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def _prompt(cfg, batch: int, prompt_len: int, seed: int, device) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed + 1)
    return torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen).to(device)


def _generator_config(cfg, transfer_dtype):
    return dataclasses.replace(cfg, param_dtype=transfer_dtype or cfg.param_dtype)


class _StoreUser(Actor):
    async def on_stop(self) -> None:
        await ts.shutdown(STORE)  # this process's client; the store lives on


class Learner(_StoreUser):
    """Trains the model on one seeded batch (fp32 parameters, AdamW) and
    publishes every step's weights as the channel's next version."""

    def __init__(self, cfg, device: str, transfer_dtype, batch: int, seq: int, lr: float,
                 seed: int) -> None:
        from torchstore_tpu_torch.models.llama import init_params
        from torchstore_tpu_torch.parallel import make_train_step

        self.cfg = cfg
        self.device = torch.device(device)
        self.transfer_dtype = transfer_dtype
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.model = init_params(cfg, gen, self.device)
        opt = torch.optim.AdamW(self.model.parameters(), lr=lr, weight_decay=1e-4, eps=1e-8)
        self.step_fn = make_train_step(self.model, opt)
        self.tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                                    device=self.device)
        self.publisher = ts.WeightPublisher(CHANNEL, store_name=STORE)

    @endpoint
    async def train_and_publish(self, step: int) -> dict:
        t0 = time.perf_counter()
        loss = float(self.step_fn(self.tokens))
        _sync(self.device)
        train_s = time.perf_counter() - t0
        state = {k: v.detach() for k, v in self.model.state_dict().items()}
        launches = staging.cast_kernel.launches
        t0 = time.perf_counter()
        version = await self.publisher.publish({"params": state},
                                               transfer_dtype=self.transfer_dtype)
        _sync(self.device)
        publish_s = time.perf_counter() - t0
        chunks = 0
        if self.transfer_dtype is not None and self.device.type == "cuda":
            chunks = len(staging.plan_chunks(list(state.values()), self.transfer_dtype))
        return {"step": step, "loss": loss, "version": version, "train_s": train_s,
                "publish_s": publish_s, "peak_device_bytes": _peak_bytes(self.device),
                # The cast kernel's launches in this publish, and the
                # planner's chunks it should take.
                "cast_launches": staging.cast_kernel.launches - launches, "cast_chunks": chunks}

    @endpoint
    async def local_tokens(self, batch: int, prompt_len: int, new_tokens: int, seed: int) -> list:
        """Greedy tokens of a local generator-dtype copy of the learner's
        weights: what every generator must decode after the sync."""
        from torchstore_tpu_torch.models.generate import Decoder
        from torchstore_tpu_torch.models.llama import Llama

        gen_cfg = _generator_config(self.cfg, self.transfer_dtype)
        local = Llama(gen_cfg, self.device)
        local.load_state_dict({k: v.detach().to(gen_cfg.param_dtype)
                               for k, v in self.model.state_dict().items()})
        dec = Decoder(gen_cfg, max_len=prompt_len + new_tokens, device=self.device)
        tokens = dec.generate(local, _prompt(self.cfg, batch, prompt_len, seed, self.device),
                              new_tokens)
        del local
        return tokens.tolist()


class Generator(_StoreUser):
    """Holds a generator-dtype model laid out tensor-parallel over ``tp``
    ranks in this process; each sync pulls every rank's boxes into views of
    the parameters, then decodes greedily."""

    def __init__(self, cfg, device: str, transfer_dtype, tp: int) -> None:
        from torchstore_tpu_torch.models.llama import Llama
        from torchstore_tpu_torch.parallel import shard_params

        self.cfg = _generator_config(cfg, transfer_dtype)
        self.device = torch.device(device)
        self.model = Llama(self.cfg, self.device)  # allocated: the first sync fills it
        self.trees = shard_params(self.model, {"tp": tp})
        # One subscriber per tensor-parallel rank, as ranks in processes of
        # their own would each hold.
        self.subscribers = [ts.WeightSubscriber(CHANNEL, store_name=STORE) for _ in range(tp)]

    @endpoint
    async def sync_and_generate(self, batch: int, prompt_len: int, new_tokens: int, seed: int,
                                timeout: Optional[float] = None) -> dict:
        from torchstore_tpu_torch.models.generate import Decoder

        t0 = time.perf_counter()
        pulled = await asyncio.gather(*(
            sub.acquire(user_state_dict={"params": tree}, timeout=timeout)
            for sub, tree in zip(self.subscribers, self.trees)
        ))
        _sync(self.device)
        acquire_s = time.perf_counter() - t0
        versions = sorted({v for _, v in pulled})
        # A target is a view of its parameter, so the get filled the model;
        # a leaf that came back as another tensor is copied in, and counted.
        copies = 0
        for (sd, _), tree in zip(pulled, self.trees):
            for key, shard in tree.items():
                got = sd["params"][key]
                if got is not shard.data:
                    shard.data.copy_(got)
                    copies += 1
        dec = Decoder(self.cfg, max_len=prompt_len + new_tokens, device=self.device)
        tokens = dec.generate(self.model, _prompt(self.cfg, batch, prompt_len, seed, self.device),
                              new_tokens)
        return {"versions": versions, "acquire_s": acquire_s, "tokens": tokens.tolist(),
                "copies": copies, "targets": sum(len(t) for t in self.trees),
                "peak_device_bytes": _peak_bytes(self.device)}


async def main(
    cfg=None,
    device: str = "cuda",
    steps: int = STEPS,
    transfer_dtype: Optional[torch.dtype] = None,
    generators: int = 2,
    tp: int = 8,
    batch: int = 4,
    seq: int = 16,
    lr: float = 1e-4,
    prompt_len: int = 4,
    new_tokens: int = 8,
    seed: int = 0,
    timeout: Optional[float] = 600.0,
) -> list[dict]:
    """Run the loop ``steps`` times; returns one record per step: the
    learner's loss, train and publish seconds, each generator's acquire
    seconds, versions and tokens, and the learner's local tokens. Raises
    when the generators disagree."""
    from torchstore_tpu_torch.models.llama import LlamaConfig

    cfg = cfg or LlamaConfig.tiny()
    await ts.initialize(store_name=STORE)
    learner = gens = None
    try:
        learner = await spawn_actors(1, Learner, f"tst_{STORE}_learner", cfg, device,
                                     transfer_dtype, batch, seq, lr, seed)
        gens = await spawn_actors(generators, Generator, f"tst_{STORE}_generator", cfg, device,
                                  transfer_dtype, tp)
        records = []
        for step in range(steps):
            trained = await learner.refs[0].train_and_publish.call_one(step)
            outs = await asyncio.gather(*(
                ref.sync_and_generate.call_one(batch, prompt_len, new_tokens, seed, timeout)
                for ref in gens.refs
            ))
            local = await learner.refs[0].local_tokens.call_one(batch, prompt_len, new_tokens,
                                                                seed)
            records.append({**trained, "generators": outs, "local_tokens": local})
            print(f"step {step}: loss={trained['loss']:.4f} version={trained['version']} "
                  f"generator_tokens={[o['tokens'][0] for o in outs]}", flush=True)
            if any(o["tokens"] != outs[0]["tokens"] for o in outs):
                raise AssertionError("generators must agree after sync")
    finally:
        for mesh in (gens, learner):
            if mesh is not None:
                await mesh.stop()
        await ts.shutdown(STORE)
    return records


def _cli() -> None:
    from torchstore_tpu_torch.models.llama import LlamaConfig

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default="tiny", choices=("tiny", "llama3_8b"))
    parser.add_argument("--layers", type=int, default=None, help="cut the depth")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--steps", type=int, default=STEPS)
    parser.add_argument("--transfer-dtype", default="bf16", choices=("bf16", "none"))
    args = parser.parse_args()
    cfg = getattr(LlamaConfig, args.config)()
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    dtype = torch.bfloat16 if args.transfer_dtype == "bf16" else None
    asyncio.run(main(cfg, args.device, args.steps, dtype))
    print("RL weight-sync example OK")


if __name__ == "__main__":
    _cli()
