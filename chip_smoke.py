"""Smoke run of torchstore_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, as a user would run it
    python3 chip_smoke.py --phases device,build,parity   # a subset

Phases, each printing one JSON line:

1. device       - the card, its power limit, /dev/shm and host memory;
2. build        - nvcc builds csrc/cast.cu, csrc/flash_attention.cu (the
                  simt flash kernel) and csrc/flash_attention_sm90.cu (the
                  Hopper flash kernel) from the checkout, all at once, and
                  prints each library's ptxas registers and spills; fails if
                  the sm90 kernel spills or ptxas ignored its setmaxnreg;
3. parity       - the grouped cast kernel against its plain version on the
                  card, bit for bit outside NaN (NaN positions equal), for
                  every covered dtype pair: single tensors (groups of one) at
                  ragged sizes, Llama-3-8B shapes and misaligned views, and
                  groups that mix sizes 0 to 2**20 + 3, the Llama-3-8B shapes
                  and views at every storage offset, over one chunk, many
                  chunks and more tensors than one table holds; each group's
                  launches equal to the planner's chunks;
4. timing       - the cast kernel at the shapes the main path casts (groups
                  of one), and one publish: cast_group over the 291 fp32
                  tensors of the Llama-3-8B state dict, beside its memory
                  bound, the plain version and a loop of x.to();
5. main         - the weight-sync round trip at Llama-3-8B width through the
                  port's entry points: initialize, a buffered put/get, a
                  direct publish/pull on the host rung (the device rung
                  switched off, ``rung`` printed per direct step, so the
                  records of earlier runs stay comparable), a refresh after
                  an in-place update,
                  then the buffered steady state of an RL loop (a reput and
                  a reget of the same key into the same targets, twice, each
                  after the volume's pool warm-ups settled and the client's
                  background page-locking ended, both waits printed),
                  shutdown; per step GB/s, the plan cache's hits and misses
                  and the controller's locates and epoch bumps (reput2 and
                  reget2 are plan hits with no locate, no bump and no commit
                  marker fetched), the segment pool's offers by
                  outcome (spare / pooled / miss), segments created and
                  recycled, spares announced, the page-locking seconds and
                  the seconds the step waited for a lock in progress; a
                  fixed matmul workload timed while the locking runs and
                  after it; the cast kernel's launches on each
                  casting step, equal to the planner's chunk count, no cast
                  outside the kernel (cast_fallbacks 0); the reputs make no
                  cold segment; no segment or process is left;
6. reshard      - the same state dict put in an FSDP trainer's layout (8
                  ranks, Shard(0) of every tensor: 2328 shards, views of the
                  fp32 source on the card) and fetched by 4 tensor-parallel
                  generator ranks into bf16 targets on the card, buffered and
                  then direct on the host rung (publish, pull, refresh,
                  repull; ``rung`` printed): every target
                  bit-equal to its box of the source's bf16 cast; the cast
                  kernel's launches per step equal to the planner's chunks;
                  the regions fetched equal to the count the phase works out
                  from the two layouts; a DTensor leg on a one-rank mesh;
7. quant        - the quantized wire tier at full Llama-3-8B (291 fp32
                  tensors on the card, bf16 targets on the card), for each of
                  int8_block, int4_block and int8: the encode alone and the
                  decode alone on the card (CUDA events, beside their HBM
                  byte bounds), then put, get and a plan-cached reput and
                  reget of the same key (and, for int8_block, a reput and
                  reget with the plan cache off); gates: the card's blobs of
                  every norm, the embedding and layer 0 byte-equal to the CPU
                  encode, every target bit-equal to the plain dequant of its
                  blob in bf16 and within one keyframe step of the source, no
                  device memory left by a get, the warm steps plan hits with
                  no locate, epoch bump or marker; then a delta leg at the
                  depth a printed memory plan allows (int8_block, versions
                  v0..v4, keyframe every 4): the reader's state bit-equal to
                  the encoder's baseline at every version, v2 (no change)
                  ships zero bytes, a fresh decoder walks the chain to the
                  same bytes;
8. channel      - the versioned weight channel at full Llama-3-8B width
                  (the port Llama's 291 tensors, fp32 on the card, bf16
                  targets on the card; depth from a printed plan of /dev/shm
                  and card memory): (a) barrier: WeightPublisher(keep=2)
                  publishes v0..v4 in bf16, each after a seeded in-place step,
                  the volume's warm-ups and the client's page-locking (the
                  seconds waited printed), and one WeightSubscriber
                  acquires each in place; per version the publish and
                  acquire seconds and GB/s, the pool's offers by outcome,
                  segments created, attachments page-locked, K1 launches and
                  the versions left after GC; gates: every target bit-equal
                  to its bf16 cast, v0..v4 delivered once each and in order,
                  K1 launches = planned chunks, no fallback, two versions
                  kept; (b) streamed: one publish of a fragment per module
                  in forward order beside acquire_streamed(key_order=
                  forward_key_order); first layer, last layer and seal
                  seconds; gates: a layer served before the seal, served
                  order = key_order, bit-equal, no fallback, K1 launches =
                  the fragments' planned chunks; then a barrier put over the
                  streamed key, served by the next streamed get through the
                  barrier path (one marker_drift fallback), bit-equal; (c) a
                  streamed delta channel (int8_block, keyframe every 3, keep
                  3, v0..v3, v2 unchanged) at the delta plan's depth: the
                  reader's state bit-equal to the encoder's baseline, v2
                  ships nothing and serves every key from the reader's
                  state, targets within one keyframe step; nothing left;
9. flash_parity - the flash kernels, stats mode (K2) and normalized mode
                  (K3), against their plain versions on the card: Llama-3-8B
                  attention width, MHA, d = 64, 72 and 256, lengths 1 to 8192
                  and ragged ones, batch up to 4, a packed qkv projection
                  view, fp32 and bf16, causal and not. Each case names the
                  variant ``sm90_eligible`` picked; the sm90 cases are held
                  against the blockwise plain version and against the fp32
                  one with SDPA's error as the yardstick;
10. flash_timing - K2 and K3 at b=1, h=32, hk=8, d=128, bf16, 8192 tokens
                  (and K2 at 4096) on the sm90 kernel, and at 8192 on the
                  simt kernel, beside their bound (the bf16 tensor-core rate
                  for sm90, the fp32 CUDA-core rate for simt's fp32 math),
                  the plain versions and SDPA (on fp32 copies of the inputs
                  beside simt);
11. ring         - ring attention over a one-rank NCCL group ({"sp": 1}) at
                  Llama-3-8B attention width: a bf16 path (forward at 8192,
                  forward and backward at 4096) and an fp32 forward path at
                  2048, held against the einsum body and the plain version;
                  K2's and K3's launches per variant on each path;
12. model       - the RL loop at Llama-3-8B width (depth cut): a learner
                  trains two steps and publishes with direct=True (cast
                  launches equal to the planner's chunk count; the device
                  rung, in process; ``rung`` printed), a bf16
                  generator pulls and decodes greedily;
13. rl          - the RL example (torchstore_tpu_torch.examples.torchstore_rl)
                  at Llama-3-8B width, 4 layers: a learner process trains 3
                  steps and publishes through the weight channel in bf16;
                  two generator processes, each with its bf16 model laid out
                  tensor-parallel over 8 ranks, acquire resharded into views
                  of their parameters and decode greedily; train, publish
                  and acquire seconds per step, peak card memory per
                  process; gates: the loss falls, both generators' tokens
                  equal a local bf16 decoder's on the learner's weights, K1
                  launches = planned chunks, no process left;
14. direct_device - the device rung of direct weight sync at full
                  Llama-3-8B width (the port Llama's 291 tensors, fp32 on
                  the card, bf16 transfer, bf16 targets on the card; depth
                  from a printed memory plan): (a) in process: publish,
                  pull, an in-place step, republish, repull (two local
                  pulls, no fallback); (b) a generator actor process on the
                  same card pulls over CUDA IPC, before and after a
                  republish (two IPC pulls, one block opened, targets'
                  digests equal to the bf16 cast's); (c) a dest that cannot
                  see the card (its UUID tampered) falls back to the host
                  staging, then two such dests at once share one
                  materialization and leave the generation; (d) a publish
                  lands between a pull's copies and its generation re-read:
                  exactly one retry, the new content; (e) an ordered
                  host-rung pull (a store with the device rung off,
                  key_order = forward_key_order, on_layer timing each key):
                  keys in order. Every leg: seconds and GB/s per step, K1
                  launches per publish (the planner's chunks), card memory
                  a pull leaves (0), peak card memory per process; every
                  target bit-equal; no process or segment left;
15. kernels     - one line listing every ported kernel.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device,
or without the package beside this file, it exits non-zero and prints no
result. Every phase that fails ends the run with a non-zero exit code.
"""

from __future__ import annotations

import argparse
import asyncio
import importlib
import json
import math
import multiprocessing
import os
import subprocess
import sys
import time

try:  # the generator actor of the direct_device phase
    from torchstore_tpu_torch.runtime import Actor as _Actor
    from torchstore_tpu_torch.runtime import endpoint as _endpoint
except ImportError:  # alone in a directory: main() finds no package and fails
    _Actor, _endpoint = object, (lambda fn: fn)

ALL_PHASES = (
    "device", "build", "parity", "timing", "main", "reshard", "quant", "channel",
    "flash_parity", "flash_timing", "ring", "model", "rl", "direct_device", "kernels",
)

# Llama-3-8B geometry (the store's north-star state dict: 291 tensors).
HIDDEN, INTER, VOCAB, LAYERS, HEADS, KV_HEADS = 4096, 14336, 128256, 32, 32, 8
HEAD_DIM = HIDDEN // HEADS
# The shapes the direct-sync source casts, one per distinct tensor kind.
CAST_SHAPES = {
    "embed/lm_head": (VOCAB, HIDDEN),
    "gate/up": (HIDDEN, INTER),
    "down": (INTER, HIDDEN),
    "q/o": (HIDDEN, HEADS * HEAD_DIM),
    "k/v": (HIDDEN, KV_HEADS * HEAD_DIM),
    "norm": (HIDDEN,),
}
# H100 SXM peaks (NVIDIA data sheet): HBM rate, dense bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12  # float32 outside the tensor cores (the simt flash kernel's math)
L2_BYTES = 50 * 2**20


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def sh(cmd: list[str]) -> str:
    try:
        return subprocess.run(
            cmd, capture_output=True, text=True, timeout=60
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"unavailable: {exc}"


def mem_available_bytes() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return 0


def shm_free_bytes() -> int:
    st = os.statvfs("/dev/shm")
    return st.f_frsize * st.f_bavail


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_device(torch) -> dict:
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(smi, flush=True)
    return {
        "phase": "device",
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "dev_shm_df": sh(["df", "-B1", "/dev/shm"]).splitlines()[-1:],
        "dev_shm_free_bytes": shm_free_bytes(),
        "mem_available_bytes": mem_available_bytes(),
        "cpus": os.cpu_count(),
    }


def phase_build(staging, flash) -> dict:
    import re

    from torchstore_tpu_torch.ops._nvcc import build_all

    libs = {"cast": staging.cast_kernel.lib,
            **{f"flash_{name}": lib for name, lib in flash.stats_kernel.libs.items()}}
    t0 = time.perf_counter()
    build_all(list(libs.values()))
    out = {"phase": "build", "seconds": time.perf_counter() - t0}
    for name, lib in libs.items():
        log = lib.build_log.splitlines()
        spills = [int(n) for line in log
                  for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", line)]
        out[name] = {
            "seconds": lib.build_seconds,
            "registers": [int(n) for line in log for n in re.findall(r"Used (\d+) registers", line)],
            "spill_bytes": sum(spills),
            "warnings": [line.strip() for line in log if "warning" in line.lower()][:8],
        }
    sm90 = out["flash_sm90"]
    sm90["setmaxnreg_ignored"] = any("C7508" in w or "setmaxnreg ignored" in w
                                     for w in sm90["warnings"])
    out["ok"] = sm90["spill_bytes"] == 0 and not sm90["setmaxnreg_ignored"]
    return out


def _special_bits(torch, dtype):
    """Edge values of ``dtype`` as a 1-D tensor: +-0, +-Inf, NaNs,
    subnormals, the largest finite values, values around the narrower
    types' overflow and subnormal edges, and exact rounding ties."""
    if dtype == torch.float32:
        vals = [
            0.0, -0.0, math.inf, -math.inf, 1e-45, -1e-45, 1e-40, 1.17549435e-38,
            3.4028235e38, -3.4028235e38, 65504.0, 65519.0, 65519.996, 65520.0,
            -65520.0, 65536.0, 6.1035156e-05, 6.0e-05, 5.9604645e-08,
            2.9802322e-08, 2.9802326e-08, 1e-8, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11,
            3.3895314e38, 3.3961775e38, 1.0, -1.0, 0.1, 1e30,
        ]
        t = torch.tensor(vals, dtype=torch.float32)
        bits = [
            0x7FC00000, 0xFFC00000, 0x7F800001, 0x7FFFFFFF, 0xFFBFFFFF,
            0x3F808000, 0x3F818000, 0x3F80C000, 0x3F7F8000, 0x00008000,
            0x80018000, 0x7F7F8000, 0x7F7FFFFF,
        ]
        signed = [v - (1 << 32) if v >= 1 << 31 else v for v in bits]
        b = torch.tensor(signed, dtype=torch.int32).view(torch.float32)
        return torch.cat([t, b])
    # 16-bit inputs: every bit pattern.
    return torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32).to(torch.int16).view(dtype)


def _random_bits(torch, dtype, n, gen, device):
    if dtype == torch.float32:
        raw = torch.randint(-(2**31), 2**31, (n,), dtype=torch.int64, generator=gen, device=device)
        return raw.to(torch.int32).view(torch.float32)
    raw = torch.randint(-(2**15), 2**15, (n,), dtype=torch.int32, generator=gen, device=device)
    return raw.to(torch.int16).view(dtype)


def _random_values(torch, dtype, shape, gen, device):
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return x.to(dtype)


def compare_cast(torch, got, want) -> dict:
    """Bit equality outside NaN, NaN positions equal."""
    int_t = {2: torch.int16, 4: torch.int32}[got.element_size()]
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    nan_ok = bool(torch.equal(nan_g, nan_w))
    keep = ~(nan_g | nan_w)
    mism = int((got.view(int_t)[keep] != want.view(int_t)[keep]).sum().item())
    fin = keep & torch.isfinite(got) & torch.isfinite(want)
    err = 0.0
    if bool(fin.any()):
        err = float((got[fin].double() - want[fin].double()).abs().max().item())
    return {"bit_mismatches": mism, "nan_positions_equal": nan_ok, "max_abs_err": err}


def phase_parity(torch, staging) -> dict:
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = []
    worst = 0.0
    ok = True

    def check(x, dst, label):
        nonlocal worst, ok
        got = staging.cast_kernel(x, dst)
        want = staging.cast_reference(x, dst)
        torch.cuda.synchronize()
        res = compare_cast(torch, got, want)
        good = res["bit_mismatches"] == 0 and res["nan_positions_equal"]
        ok &= good
        worst = max(worst, res["max_abs_err"])
        cases.append({"case": label, "ok": good, **res})

    def check_group(xs, dst, label, max_chunk_bytes=staging.DEFAULT_CHUNK_BYTES):
        """One cast_group call: every output against x.to(), and its launches
        against the planner's chunks."""
        nonlocal worst, ok
        chunks = len(staging.plan_chunks(xs, dst, max_chunk_bytes))
        before = staging.cast_kernel.launches
        got = staging.cast_group(xs, dst, max_chunk_bytes=max_chunk_bytes)
        launches = staging.cast_kernel.launches - before
        torch.cuda.synchronize()
        res = [compare_cast(torch, y, staging.cast_reference(x, dst)) for x, y in zip(xs, got)]
        mism = sum(r["bit_mismatches"] for r in res)
        nan_ok = all(r["nan_positions_equal"] for r in res)
        err = max(r["max_abs_err"] for r in res)
        good = mism == 0 and nan_ok and launches == chunks
        ok &= good
        worst = max(worst, err)
        cases.append({"case": label, "ok": good, "tensors": len(xs), "launches": launches,
                      "chunks": chunks, "bit_mismatches": mism, "nan_positions_equal": nan_ok,
                      "max_abs_err": err})

    sizes = (1, 7, 1023, 1025, 4096 * 1024 + 3)
    for src, dst in staging.PAIRS:
        name = f"{str(src)[6:]}->{str(dst)[6:]}"
        special = _special_bits(torch, src).to(dev)
        check(special, dst, f"{name} special n={special.numel()}")
        for n in sizes:
            base = _random_bits(torch, src, n + 1, gen, dev)
            base[: min(n, special.numel())] = special[: min(n, special.numel())]
            check(base[:n], dst, f"{name} n={n}")
            check(base[1:], dst, f"{name} n={n} misaligned")
        for label, shape in CAST_SHAPES.items():
            n = math.prod(shape)
            flat = _random_values(torch, src, (n + 1,), gen, dev)
            k = min(n, special.numel())
            flat[:k] = special[:k]
            flat[n + 1 - k :] = special[:k]
            check(flat[:n].view(shape), dst, f"{name} {label} {shape}")
            check(flat[1:].view(shape), dst, f"{name} {label} {shape} misaligned")
            del flat
        group = []
        for n in (0, 1, 7, 8, 9, 1023, (1 << 20) + 3):
            x = _random_bits(torch, src, n, gen, dev)
            k = min(n, special.numel())
            x[:k] = special[:k]
            group.append(x)
        views = _random_bits(torch, src, 100_000, gen, dev)
        views[: special.numel()] = special
        group += [views[k:] for k in range(9)]  # every storage offset
        group += [_random_values(torch, src, shape, gen, dev) for shape in CAST_SHAPES.values()]
        check_group(group, dst, f"{name} group mixed")
        check_group(group[:16], dst, f"{name} group in 256 KiB chunks", 1 << 18)
        check_group([views[k : k + 3] for k in range(1200)], dst, f"{name} group 1200 tensors")
        del group, views
    failed = [c for c in cases if not c["ok"]]
    return {
        "phase": "parity",
        "ok": ok,
        "cases": len(cases),
        "failed": failed[:10],
        "max_abs_err": worst,
        "tolerance": "bit-equal outside NaN; NaN positions equal",
    }


def _time_ms(torch, fn, inputs, iters: int) -> float:
    """Mean ms per call over ``iters`` calls, cycling through ``inputs`` so
    each call reads memory that is not in L2."""
    for i in range(3):
        fn(inputs[i % len(inputs)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(inputs[i % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n: int, src_bytes: int, dst_bytes: int) -> float:
    """Least time for the cast: each input byte read once and each output
    byte written once at the HBM rate (one conversion per element is far
    below the card's operation rate, so bytes bound it)."""
    return n * (src_bytes + dst_bytes) / HBM_BYTES_PER_S * 1e3


def phase_timing(torch, staging) -> dict:
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rows = []
    plan = [(torch.float32, torch.bfloat16, label, shape) for label, shape in CAST_SHAPES.items()]
    plan += [(s, d, "gate/up", CAST_SHAPES["gate/up"]) for s, d in staging.PAIRS[1:]]
    for src, dst, label, shape in plan:
        n = math.prod(shape)
        nbytes = n * (torch.tensor([], dtype=src).element_size())
        copies = max(1, min(64, math.ceil(4 * L2_BYTES / max(nbytes, 1))))
        inputs = [_random_values(torch, src, shape, gen, dev) for _ in range(copies)]
        iters = max(20, copies * 2)
        before = staging.cast_kernel.launches
        fns = {
            "kernel": lambda x: staging.cast_kernel(x, dst),
            "plain": lambda x: staging.cast_reference(x, dst),
            "library": lambda x: x.to(dst),
        }
        runs = {name: [] for name in fns}
        # In turns (kernel, plain, library, library, plain, kernel); each
        # reports the better of its two runs.
        for name in ("kernel", "plain", "library", "library", "plain", "kernel"):
            runs[name].append(_time_ms(torch, fns[name], inputs, iters))
        staging.cast_kernel.launches = before  # timing launches are not path launches
        b = bound_ms(n, inputs[0].element_size(), torch.tensor([], dtype=dst).element_size())
        k = min(runs["kernel"])
        rows.append(
            {
                "pair": f"{str(src)[6:]}->{str(dst)[6:]}",
                "shape": label,
                "dims": list(shape),
                "n": n,
                "ms": k,
                "runs_ms": runs,
                "bound_ms": b,
                "share_of_bound": b / k if k > 0 else None,
                "plain_ms": min(runs["plain"]),
                "library_ms": min(runs["library"]),
                "bytes_per_elem": inputs[0].element_size()
                + torch.tensor([], dtype=dst).element_size(),
            }
        )
        del inputs
        torch.cuda.empty_cache()
    rows.append(_publish_row(torch, staging, gen, dev))
    torch.cuda.empty_cache()
    return {"phase": "timing", "rows": rows, "hbm_bytes_per_s": HBM_BYTES_PER_S}


def _publish_row(torch, staging, gen, dev) -> dict:
    """One publish's cast: cast_group over the 291 fp32 tensors of the
    Llama-3-8B state dict at full width (32.1 GB in, 16.06 GB out), CUDA
    events around the whole call (planning, allocation and launches
    included), three calls after one warm-up, in turns with the plain
    version and a Python loop of x.to() (the library yardstick). host_ms is
    each call's host time until it returns, without a sync."""
    from torchstore_tpu_torch.workloads import llama_state_dict

    bf16 = torch.bfloat16
    leaves = list(_leaves(llama_state_dict(gen, device=dev, dtype=torch.float32)))
    n = sum(t.numel() for t in leaves)
    chunks = len(staging.plan_chunks(leaves, bf16))
    fns = {
        "kernel": lambda: staging.cast_group(leaves, bf16),
        "plain": lambda: staging.cast_group_reference(leaves, bf16),
        "library": lambda: [x.to(bf16) for x in leaves],
    }
    before = staging.cast_kernel.launches

    def timed(fn) -> tuple[list[float], list[float]]:
        """Device ms (events) and host ms (until the call returns, no sync)
        of three calls."""
        fn()  # warm-up; its outputs are dropped at once
        torch.cuda.synchronize()
        dev_ms, host_ms = [], []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            res = fn()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            end.record()
            del res
            torch.cuda.synchronize()
            dev_ms.append(start.elapsed_time(end))
        return dev_ms, host_ms

    runs = {name: [] for name in fns}
    host = {name: [] for name in fns}
    for name in ("kernel", "plain", "library", "library", "plain", "kernel"):
        dev_ms, host_ms = timed(fns[name])
        runs[name] += dev_ms
        host[name] += host_ms
    launches_per_call = (staging.cast_kernel.launches - before) / 8
    staging.cast_kernel.launches = before  # timing launches are not path launches
    del leaves, fns
    b = bound_ms(n, 4, 2)
    k = min(runs["kernel"])
    return {
        "pair": "float32->bfloat16",
        "shape": "publish",
        "tensors": 291,
        "n": n,
        "chunks": chunks,
        "launches_per_call": launches_per_call,
        "ms": k,
        "runs_ms": runs,
        "host_ms": host,
        "bound_ms": b,
        "share_of_bound": b / k if k > 0 else None,
        "plain_ms": min(runs["plain"]),
        "library_ms": min(runs["library"]),
        "bytes_per_elem": 6,
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=",".join(ALL_PHASES))
    args = parser.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(ALL_PHASES)
    if unknown:
        parser.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    from torchstore_tpu_torch.ops import staging

    flash = importlib.import_module("torchstore_tpu_torch.ops.flash_attention")
    results = {}
    for phase in phases:
        t0 = time.perf_counter()
        if phase == "device":
            res = phase_device(torch)
        elif phase == "build":
            res = phase_build(staging, flash)
        elif phase == "parity":
            res = phase_parity(torch, staging)
        elif phase == "timing":
            res = phase_timing(torch, staging)
        elif phase == "main":
            res = phase_main(torch, staging)
        elif phase == "reshard":
            res = phase_reshard(torch, staging)
        elif phase == "quant":
            res = phase_quant(torch)
        elif phase == "channel":
            res = phase_channel(torch, staging)
        elif phase == "flash_parity":
            res = phase_flash_parity(torch, flash)
        elif phase == "flash_timing":
            res = phase_flash_timing(torch, flash)
        elif phase == "ring":
            res = phase_ring(torch, flash)
        elif phase == "model":
            res = phase_model(torch, staging)
        elif phase == "rl":
            res = phase_rl(torch)
        elif phase == "direct_device":
            res = phase_direct_device(torch, staging)
        else:
            res = phase_kernels(results)
        res["seconds"] = time.perf_counter() - t0
        res.setdefault("device", torch.cuda.get_device_name(0))
        emit(res)
        results[phase] = res
        torch.cuda.empty_cache()
        if res.get("ok") is False:
            print(f"chip_smoke: phase {phase} failed", file=sys.stderr)
            return 1
    emit(
        {
            "ok": True,
            "device": {
                "platform": "gpu",
                "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count(),
            },
        }
    )
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _bf16_zeros_like(torch, tree, dev):
    """bf16 zeros on ``dev`` in the shape of every leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _bf16_zeros_like(torch, v, dev) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=torch.bfloat16, device=dev)


def _pairs(a, b):
    """Leaf pairs of two trees of the same structure."""
    if isinstance(a, dict):
        for k in a:
            yield from _pairs(a[k], b[k])
    else:
        yield a, b


SHM_COPIES = 3  # the volume's live set, its warm spare set, the direct staging


def plan_layers() -> tuple[int, dict]:
    """Depth that fits host memory: the volume's live segments, the warm
    set it rotates with, and the direct staging (bf16 each) live in
    /dev/shm at once; and that the default pool cap holds one working set,
    so the reputs rotate through the pool. Widths never change."""
    from torchstore_tpu_torch.config import default_config
    from torchstore_tpu_torch.workloads import LLAMA3_8B, llama_shapes

    geo = dict(LLAMA3_8B)
    per_layer = sum(math.prod(s) for s in _leaves(llama_shapes(**{**geo, "layers": 1})["layers"]))
    outer = sum(math.prod(s) for s in _leaves({**llama_shapes(**{**geo, "layers": 0}), "layers": {}}))
    budget = 0.8 * min(shm_free_bytes(), mem_available_bytes())
    copies_bytes = lambda n: SHM_COPIES * 2 * (outer + n * per_layer)  # bf16 copies
    pool_cap = default_config().shm_pool_max_bytes
    layers = geo["layers"]
    while layers > 1 and (
        copies_bytes(layers) > budget or copies_bytes(layers) // SHM_COPIES > pool_cap
    ):
        layers -= 1
    return layers, {"budget_bytes": int(budget), "needed_bytes": copies_bytes(layers),
                    "shm_copies": SHM_COPIES, "pool_cap": pool_cap}


async def _pool_counts(client) -> dict:
    """The segment pool's counters: the volume's handshake offers by outcome
    and its segments created and recycled, the client's cold creates, and
    the attachments it page-locked (in the background) and the seconds
    that took."""
    stats = await client.controller.stats.call_one(include_volumes=True)
    (vstats,) = stats["volumes"].values()
    pool = vstats.get("shm", {})
    mine = client.shm_stats()
    return {
        **pool.get("offers", {"spare": 0, "pooled": 0, "miss": 0}),
        "volume_created": pool.get("segments_created", 0),
        "recycled": pool.get("segments_recycled", 0),
        "announced": pool.get("spares_announced", 0),
        "cold_create": mine["cold_create"],
        "pinned": mine["pinned"],
        "pin_s": mine["pin_seconds"],
        "pin_wait_s": mine["pin_wait_seconds"],
        "warming": pool.get("warming", 0),
    }


async def _wait_warm(client, limit_s: float = 120.0) -> float:
    """Seconds until the volume has no warm-up in flight (the gap a training
    step leaves before the next put), at most ``limit_s``."""
    t0 = time.perf_counter()
    while (await _pool_counts(client))["warming"] and time.perf_counter() - t0 < limit_s:
        await asyncio.sleep(0.05)
    return time.perf_counter() - t0


def _matmuls_ms(torch, a, b, iters: int = 100) -> dict:
    """A fixed CUDA workload (``iters`` bf16 matmuls), standing for a
    training step's device work: host ms to launch it and to see its last
    kernel end (an event, not a device-wide sync), and its device ms."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        torch.mm(a, b)
    end.record()
    launched = time.perf_counter()
    end.synchronize()
    return {"wall_ms": (time.perf_counter() - t0) * 1e3,
            "launch_ms": (launched - t0) * 1e3, "device_ms": start.elapsed_time(end)}


def _python_ms(n: int = 200_000) -> float:
    """Host ms of a fixed pure-Python loop (shows a thread holding the GIL)."""
    t0 = time.perf_counter()
    x = 0
    for i in range(n):
        x += i
    return (time.perf_counter() - t0) * 1e3


async def _pin_overlap(torch, client, a, b, reps: int = 3) -> dict:
    """The fixed workloads while the client's background page-locking runs,
    then, once it is done (the seconds waited), with nothing beside it."""
    before = client.shm_stats()
    under = [{"python_ms": _python_ms(), **_matmuls_ms(torch, a, b)} for _ in range(reps)]
    after = client.shm_stats()
    waited = await client.wait_pinned()
    idle = [{"python_ms": _python_ms(), **_matmuls_ms(torch, a, b)} for _ in range(reps)]
    return {"under_lock": under, "idle": idle,
            "pending_at_start": before["pin_pending"], "pending_at_end": after["pin_pending"],
            "locked_meanwhile_s": after["pin_seconds"] - before["pin_seconds"],
            "wait_pinned_s": waited}


async def _main_path(torch, staging, layers: int, dev, geometry=None) -> dict:
    import torchstore_tpu_torch as tst
    from torchstore_tpu_torch.config import default_config
    from torchstore_tpu_torch.transport.shared_memory import PREFIX, SHM_DIR
    from torchstore_tpu_torch.workloads import llama_state_dict

    bf16 = torch.bfloat16
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    src = llama_state_dict(gen, device=dev, dtype=torch.float32, layers=layers, **(geometry or {}))
    n_tensors = sum(1 for _ in _leaves(src))
    n_params = sum(t.numel() for t in _leaves(src))
    wire_bytes = 2 * n_params  # bf16 on the wire

    targets = _bf16_zeros_like(torch, src, dev)

    def check(label: str) -> dict:
        bad = [
            i for i, (t, s) in enumerate(_pairs(targets, src)) if not torch.equal(t, s.to(bf16))
        ]
        return {"check": label, "bit_equal": not bad, "mismatched_tensors": len(bad)}

    def clear_targets() -> None:
        for t in _leaves(targets):
            t.zero_()
        torch.cuda.synchronize()

    # The cast launches each step needs: one per chunk of the fp32 leaves.
    chunks = len(staging.plan_chunks(list(_leaves(src)), bf16))
    # A fixed workload beside the background page-locking (warmed up here).
    mm_a = torch.randn(4096, 4096, generator=gen, device=dev, dtype=bf16)
    mm_b = torch.randn(4096, 4096, generator=gen, device=dev, dtype=bf16)
    _matmuls_ms(torch, mm_a, mm_b, iters=10)
    out: dict = {"layers": layers, "tensors": n_tensors, "params": n_params,
                 "wire_bytes": wire_bytes, "source_bytes": 4 * n_params,
                 "pool_cap": default_config().shm_pool_max_bytes}
    checks = []
    timings = {}
    launches_by_step = {}
    fallbacks = {}
    pool = {}
    plans = {}
    staging.cast_kernel.launches = 0  # count the main path's launches only
    staging.cast_kernel.fallbacks = 0
    t0 = time.perf_counter()
    # The direct steps stay on the host rung that earlier records measured
    # (the device rung is the direct_device phase's).
    await tst.initialize(config=tst.StoreConfig(ici_enabled=False))
    timings["initialize_s"] = time.perf_counter() - t0
    pids = [p.pid for p in multiprocessing.active_children()]  # volume + controller
    client = tst.client()
    rungs = {}

    async def step(name: str, coro, cast: bool) -> None:
        """Run one step: its seconds, K1 launches and fallbacks, and the
        pool's and the plan cache's counters over it."""
        before = await _pool_counts(client)
        plan_before = await _plan_counts(client)
        launched, fell_back = staging.cast_kernel.launches, staging.cast_kernel.fallbacks
        t0 = time.perf_counter()
        await coro
        torch.cuda.synchronize()
        timings[f"{name}_s"] = time.perf_counter() - t0
        plans[name] = _delta(await _plan_counts(client), plan_before)
        after = await _pool_counts(client)
        pool[name] = {k: after[k] - before[k] for k in after if k != "warming"}
        if cast:
            launches_by_step[name] = staging.cast_kernel.launches - launched
            fallbacks[name] = staging.cast_kernel.fallbacks - fell_back

    waited = {}
    pin_waited = {}
    try:
        await step("put", tst.put_state_dict("policy", src, transfer_dtype=bf16), True)
        await step("get", tst.get_state_dict("policy", targets), False)
        # The get queued its attachments (reused) and the put's announced
        # spares for page-locking: a training step overlaps it.
        overlap = await _pin_overlap(torch, client, mm_a, mm_b)
        checks.append(check("buffered get"))

        clear_targets()
        await step("publish", tst.put_state_dict("policy_direct", src, transfer_dtype=bf16,
                                                 direct=True), True)
        await step("pull", tst.get_state_dict("policy_direct", targets, direct=True), False)
        rungs["publish"] = rungs["pull"] = tst.direct_sync_stats("policy_direct")["rung"]
        checks.append(check("direct pull"))

        for t in _leaves(src):
            t.add_(1.0)  # the training step, in place
        clear_targets()
        await step("republish", tst.put_state_dict("policy_direct", src, transfer_dtype=bf16,
                                                   direct=True), True)
        await step("repull", tst.get_state_dict("policy_direct", targets, direct=True), False)
        rungs["republish"] = rungs["repull"] = tst.direct_sync_stats("policy_direct")["rung"]
        checks.append(check("direct pull after refresh"))
        pinning = _pinning(tst, "policy_direct", dev)

        # The buffered steady state: the same key re-put from the updated
        # source and fetched into the same targets, twice, each after the
        # volume's warm-ups settled (the training step's gap).
        for n, (put, get) in enumerate((("reput", "reget"), ("reput2", "reget2"))):
            if n:
                for t in _leaves(src):
                    t.add_(1.0)
            waited[put] = await _wait_warm(client)
            pin_waited[put] = await client.wait_pinned()
            clear_targets()
            await step(put, tst.put_state_dict("policy", src, transfer_dtype=bf16), True)
            await step(get, tst.get_state_dict("policy", targets), False)
            checks.append(check(f"buffered {get}"))
        # The client locks attachments on its own thread, so part of it ran
        # between the steps (beside the checks' CUDA calls).
        mine = client.shm_stats()
        in_steps = sum(p["pin_s"] for p in pool.values())
        buffered_pinning = {"attachments": mine["pinned"], "seconds": mine["pin_seconds"],
                            "in_steps_s": in_steps,
                            "between_steps_s": mine["pin_seconds"] - in_steps,
                            "steps_waited_s": mine["pin_wait_seconds"]}
    finally:
        await tst.shutdown()
    launches = staging.cast_kernel.launches
    await asyncio.sleep(0.5)
    alive = [p.pid for p in multiprocessing.active_children()]
    own = set(pids) | {os.getpid()}
    leaked = [
        n for n in os.listdir(SHM_DIR)
        if n.startswith(PREFIX) and int(n[len(PREFIX):].split("_")[0]) in own
    ]
    rotations = ("reput", "reput2")
    out.update(
        {
            "checks": checks,
            "launches": launches,
            "launches_by_step": launches_by_step,
            "launches_needed": chunks,
            "cast_fallbacks": fallbacks,
            "rung": rungs,
            "pinning": pinning,
            "buffered_pinning": buffered_pinning,
            "pin_overlap": overlap,
            "pool": pool,
            "plans": plans,
            "warm_wait_s": waited,
            "wait_pinned_s": pin_waited,
            "timings": timings,
            "gb_per_s": {
                name: wire_bytes / timings[f"{name}_s"] / 1e9
                for name in ("put", "get", "publish", "pull", "republish", "repull",
                             "reput", "reget", "reput2", "reget2")
            },
            "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
            "processes_left": alive,
            "segments_left": leaked[:5],
        }
    )
    out["ok"] = (
        all(c["bit_equal"] for c in checks)
        and (dev.type != "cuda" or all(n == chunks for n in launches_by_step.values()))
        and not any(fallbacks.values())
        and set(rungs.values()) == {"host"}
        and pinning["staging_pinned"] is not False
        and all(pool[r]["miss"] == 0 and pool[r]["cold_create"] == 0 for r in rotations)
        and _plans_warm(plans, "reput2", "reget2")
        and not alive
        and not leaked
    )
    return out


async def _plan_counts(client) -> dict:
    """The controller's locates and placement epoch (read by direct calls,
    which move no count), this client's epoch reads, and the process's
    plan-cache and commit-marker counts."""
    from torchstore_tpu_torch.state_dict_utils import sync_counters

    stats = await client.controller.stats.call_one()
    counts = sync_counters()
    return {"locates": stats["locates"],
            "epoch_bumps": await client.controller.placement_epoch.call_one(),
            "epoch_reads": client.epoch_reads,
            **{k: counts[k] for k in ("plan_hits_put", "plan_hits_get", "plan_misses",
                                      "marker_fetches")}}


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def _plans_warm(plans: dict, put: str, get: str) -> bool:
    """A warm put and get: each a plan hit, with no locate, no epoch bump
    and no commit marker fetched; the get read the epoch once."""
    return (
        all(plans[s]["locates"] == 0 and plans[s]["epoch_bumps"] == 0
            and plans[s]["marker_fetches"] == 0 and plans[s]["plan_misses"] == 0
            for s in (put, get))
        and plans[put]["plan_hits_put"] == 1
        and plans[get]["plan_hits_get"] == 1
        and plans[get]["epoch_reads"] == 1
    )


def _pinning(tst, key: str, dev, store_name: str = "default") -> dict:
    """The seconds the direct sync of ``key`` spent page-locking, and on the
    card whether its first staging buffer reads as pinned."""
    stats = tst.direct_sync_stats(key, store_name=store_name)
    first = next(_leaves(tst.direct_staging_buffers(key, store_name=store_name)))
    first = getattr(first, "data", first)  # a Shard's buffer
    return {**stats, "staging_pinned": first.is_pinned() if dev.type == "cuda" else None}


def phase_main(torch, staging) -> dict:
    layers, sizing = plan_layers()
    if layers < LAYERS:
        emit({"reduced": {"layers": layers}, **sizing})
    res = asyncio.run(_main_path(torch, staging, layers, torch.device("cuda", 0)))
    res["phase"] = "main"
    res["sizing"] = sizing
    return res


# --------------------------------------------------------------------------
# reshard: a trainer's FSDP layout to a generator's tensor-parallel one
# --------------------------------------------------------------------------

FSDP = 8  # trainer: Shard(0) of every tensor over 8 coordinates
TP = 4  # generator: tensor-parallel over 4 coordinates
# The generator's split dimension of each tensor kind in the (in, out)
# layout of workloads.py: column-parallel q/k/v/gate/up and lm_head split
# their output dimension (1), row-parallel o/down and the embedding their
# input dimension (0); the norms are replicated (None).
TP_DIM = {"q_proj": 1, "k_proj": 1, "v_proj": 1, "gate_proj": 1, "up_proj": 1, "lm_head": 1,
          "o_proj": 0, "down_proj": 0, "embed": 0,
          "attn_norm": None, "mlp_norm": None, "final_norm": None}


def _split_bounds(n: int, k: int) -> list:
    """[lo, hi) of each of k pieces of n as torch's Shard splits it: pieces
    of ceil(n / k), the last ones smaller or empty."""
    size = -(-n // k)
    return [(min(i * size, n), min((i + 1) * size, n)) for i in range(k)]


def _layout(tst, shape: tuple, dim, k: int) -> list:
    """The TensorSlice of each of k coordinates of a tensor of ``shape``,
    ``dim`` split as torch's Shard does (None: every coordinate holds all)."""
    out = []
    for c in range(k):
        offsets, local = [0] * len(shape), list(shape)
        if dim is not None:
            lo, hi = _split_bounds(shape[dim], k)[c]
            offsets[dim], local[dim] = lo, hi - lo
        out.append(tst.TensorSlice(tuple(offsets), tuple(local), tuple(shape), (c,), (k,)))
    return out


def _overlap(a, b) -> bool:
    """Whether two slices share an element: every dimension's intervals
    overlap (the phase's own arithmetic, not the store's)."""
    return all(max(ao, bo) < min(ao + an, bo + bn)
               for ao, an, bo, bn in zip(a.offsets, a.local_shape, b.offsets, b.local_shape))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", k, v


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


async def _reshard_path(torch, staging, layers: int, dev, geometry=None) -> dict:
    """The Llama-3-8B state dict (fp32 on the card) put by the FSDP trainer's
    8 ranks (each a state dict of Shard views of the source, as one host
    puts all its shards) and fetched by the generator's 4 tensor-parallel
    ranks into bf16 targets on the card, buffered and then direct (publish,
    pull, refresh after an in-place step, repull). Every target must be
    bit-equal to its box of the source's bf16 cast."""
    import torchstore_tpu_torch as tst
    from torchstore_tpu_torch.transport.shared_memory import PREFIX, SHM_DIR
    from torchstore_tpu_torch.workloads import llama_state_dict

    bf16 = torch.bfloat16
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    src = llama_state_dict(gen, device=dev, dtype=torch.float32, layers=layers, **(geometry or {}))
    leaves = list(_flat(src))  # (path, kind, tensor)
    n_params = sum(t.numel() for _, _, t in leaves)
    wire_bytes = 2 * n_params
    fsdp = {path: _layout(tst, tuple(t.shape), 0, FSDP) for path, _, t in leaves}
    tp = {path: _layout(tst, tuple(t.shape), TP_DIM[kind], TP) for path, kind, t in leaves}
    trainer = [_nest({path: tst.Shard(t[fsdp[path][r].box.to_index()], fsdp[path][r])
                      for path, _, t in leaves}) for r in range(FSDP)]
    generator = [_nest({path: tst.Shard(torch.zeros(tp[path][c].local_shape, dtype=bf16,
                                                    device=dev), tp[path][c])
                        for path, _, _ in leaves}) for c in range(TP)]
    sources = {path: t for path, _, t in leaves}
    # What the two layouts need, by the phase's own box arithmetic and the
    # cast planner: regions fetched per get (summed over the TP ranks), and
    # launches per step (summed over the FSDP ranks).
    regions = sum(_overlap(f, t) for path in tp for t in tp[path] for f in fsdp[path])
    chunks = sum(len(staging.plan_chunks([s.data for s in _leaves(tree)], bf16))
                 for tree in trainer)

    def check(label: str) -> dict:
        bad = 0
        for tree in generator:
            for path, _, shard in _flat(tree):
                want = sources[path][shard.tensor_slice.box.to_index()].to(bf16)
                bad += not torch.equal(shard.data.view(torch.int16), want.view(torch.int16))
        return {"check": label, "bit_equal": not bad, "mismatched_shards": bad}

    def clear_targets() -> None:
        for tree in generator:
            for shard in _leaves(tree):
                shard.data.zero_()
        torch.cuda.synchronize()

    def counts() -> tuple:
        return staging.cast_kernel.launches, staging.cast_kernel.fallbacks

    out: dict = {"layers": layers, "tensors": len(leaves), "params": n_params,
                 "wire_bytes": wire_bytes, "fsdp": FSDP, "tp": TP,
                 "stored_shards": FSDP * len(leaves), "tp_targets": TP * len(leaves),
                 "target_bytes": sum(s.data.numel() * 2 for t in generator for s in _leaves(t))}
    checks, timings, launches, fallbacks, fetched = [], {}, {}, {}, {}

    async def step(name: str, fn):
        before = counts(), tst.client().parts_fetched
        t0 = time.perf_counter()
        pulled = await fn()
        torch.cuda.synchronize()
        timings[f"{name}_s"] = time.perf_counter() - t0
        launches[name] = counts()[0] - before[0][0]
        fallbacks[name] = counts()[1] - before[0][1]
        fetched[name] = tst.client().parts_fetched - before[1] if pulled is None else pulled

    async def put():
        for tree in trainer:
            await tst.put_state_dict("reshard", tree, transfer_dtype=bf16)

    async def get():
        for tree in generator:
            await tst.get_state_dict("reshard", tree)

    async def publish():
        for r, tree in enumerate(trainer):
            await tst.put_state_dict("reshard_direct", tree, transfer_dtype=bf16, direct=True,
                                     rank=r, num_ranks=FSDP)

    rungs = set()

    async def pull():
        regions_pulled = 0
        for tree in generator:
            await tst.get_state_dict("reshard_direct", tree, direct=True)
            stats = tst.direct_sync_stats("reshard_direct")
            regions_pulled += stats["pulled_regions"]
            rungs.add(stats["rung"])
        return regions_pulled

    staging.cast_kernel.launches = 0  # count the reshard path's launches only
    staging.cast_kernel.fallbacks = 0
    t0 = time.perf_counter()
    # The direct steps stay on the host rung that earlier records measured.
    await tst.initialize(config=tst.StoreConfig(ici_enabled=False))
    timings["initialize_s"] = time.perf_counter() - t0
    pids = [p.pid for p in multiprocessing.active_children()]
    try:
        await step("put", put)
        await step("get", get)
        checks.append(check("buffered get"))
        clear_targets()
        await step("publish", publish)
        await step("pull", pull)
        checks.append(check("direct pull"))
        for t in sources.values():
            t.add_(1.0)  # the training step, in place: the Shards are views
        clear_targets()
        await step("republish", publish)
        await step("repull", pull)
        checks.append(check("direct pull after refresh"))
        pinning = _pinning(tst, "reshard_direct", dev)
        out["dtensor"] = await _dtensor_round_trip(torch, tst, sources["layers/0/q_proj"], dev)
    finally:
        await tst.shutdown()
    await asyncio.sleep(0.5)
    alive = [p.pid for p in multiprocessing.active_children()]
    own = set(pids) | {os.getpid()}
    leaked = [n for n in os.listdir(SHM_DIR)
              if n.startswith(PREFIX) and int(n[len(PREFIX):].split("_")[0]) in own]
    steps = ("put", "publish", "republish")
    out.update({
        "checks": checks,
        "launches_by_step": {k: launches[k] for k in steps},
        "launches_needed": {k: chunks for k in steps},
        "cast_fallbacks": fallbacks,
        "fetched_regions": {k: fetched[k] for k in ("get", "pull", "repull")},
        "regions_needed": regions,
        "rung": sorted(rungs),
        "pinning": pinning,
        "timings": timings,
        "gb_per_s": {k: wire_bytes / timings[f"{k}_s"] / 1e9
                     for k in ("put", "get", "publish", "pull", "republish", "repull")},
        "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
        "processes_left": alive,
        "segments_left": leaked[:5],
    })
    out["ok"] = (
        all(c["bit_equal"] for c in checks)
        and (dev.type != "cuda" or all(launches[k] == chunks for k in steps))
        and not any(fallbacks.values())
        and fetched["get"] == fetched["pull"] == fetched["repull"] == regions
        and out["rung"] == ["host"]
        and pinning["staging_pinned"] is not False
        and out["dtensor"]["ok"]
        and not alive
        and not leaked
    )
    return out


async def _dtensor_round_trip(torch, tst, weight, dev) -> dict:
    """One DTensor leg on a one-rank mesh of the card: Shard(0) there is the
    whole tensor, so it is stored as a plain tensor, and a get into a
    DTensor target fills its local tensor in place."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = init_device_mesh(dev.type, (1,))
        await tst.put("reshard_dtensor", distribute_tensor(weight, mesh, [Shard(0)]))
        target = distribute_tensor(torch.zeros_like(weight), mesh, [Shard(0)])
        got = await tst.get("reshard_dtensor", target)
        ok = got is target and torch.equal(target.to_local(), weight)
    finally:
        dist.destroy_process_group()
    return {"shape": list(weight.shape), "filled_in_place": got is target, "ok": bool(ok)}


def phase_reshard(torch, staging) -> dict:
    layers, sizing = plan_layers()
    if layers < LAYERS:
        emit({"reduced": {"reshard_layers": layers}, **sizing})
    res = asyncio.run(_reshard_path(torch, staging, layers, torch.device("cuda", 0)))
    res["phase"] = "reshard"
    res["sizing"] = sizing
    res["nvidia_smi"] = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    return res


# --------------------------------------------------------------------------
# quant: the quantized wire tier at full width
# --------------------------------------------------------------------------

QUANT_FMTS = ("int8_block", "int4_block", "int8")
QUANT_BLOCK = 256
DELTA_VERSIONS = 5  # v0 keyframe, v1 update, v2 unchanged, v3 update, v4 keyframe
DELTA_KEYFRAME = 4
# The delta leg's card bytes a parameter: the fp32 source, the encoder's
# baseline and the decoder's state (f32 each), the bf16 target, and the
# blobs and scale tables (about 1).
DELTA_BYTES_PER_PARAM = 15


def _plain_dequant(torch, blob, numel: int):
    """A blob's f32 values by the format's definition, apart from the
    port's decoder: header fields by struct, sections by the layout rules
    (header and shape, bitmap and codes each on a 64-byte boundary, the f32
    scale table 4-byte aligned after the codes), int4 codes low nibble
    first, value = f32(code) * f32(scale)."""
    import struct

    head = blob[:128].cpu().numpy().tobytes()
    _, _, fmt_code, _, block, nblocks, changed = struct.unpack_from("<IHBBIII", head)
    up = lambda n, a: (n + a - 1) // a * a  # noqa: E731
    bitmap = up(64 + 8 * head[20], 64)
    payload = up(bitmap + (nblocks + 7) // 8, 64)
    per_block = block if fmt_code == 1 else (block + 1) // 2
    scales_at = up(payload + changed * per_block, 4)
    raw = blob[payload:payload + changed * per_block]
    if fmt_code == 1:
        codes = raw.view(torch.int8).reshape(changed, block).to(torch.float32)
    else:
        b = raw.reshape(changed, per_block).to(torch.int16)
        nib = torch.stack([b & 15, b >> 4], dim=2).reshape(changed, -1)[:, :block]
        codes = ((nib ^ 8) - 8).to(torch.float32)
    scales = blob[scales_at:scales_at + 4 * changed].view(torch.float32)
    return (codes * scales[:, None]).reshape(-1)[:numel]


def _within_step(got, src, qmax: int) -> tuple:
    """(max |got - src|, one keyframe step max|src| / qmax) of one leaf."""
    step = float(src.abs().max()) / qmax if src.numel() else 0.0
    err = float((got.float() - src).abs().max()) if src.numel() else 0.0
    return err, step


def _quant_samples(flat: dict) -> list:
    """The leaves held byte for byte against the CPU encode: every norm,
    the embedding and the whole of layer 0."""
    return [k for k in flat if "norm" in k or k == "embed" or k.startswith("layers/0/")]


async def _quant_mode(torch, tst, sdu, client, fmt: str, src, targets, dev, no_cache: bool):
    """One mode at full width: the encode and the decode alone on the card
    (CUDA events), then put, get, a warm reput and reget of the same key,
    and (``no_cache``) a reput and reget with the client's plan cache off."""
    flat, _ = sdu.flatten_state_dict(src)
    tflat, _ = sdu.flatten_state_dict(targets)
    n = sum(t.numel() for t in flat.values())
    qmax = sdu._QMAX[fmt]
    res: dict = {"fmt": fmt}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    # One small leaf through the codec first, so the timed calls pay no
    # first-launch cost of its kernels.
    warm = {"final_norm": flat["final_norm"]}
    warm_blob = sdu.quantize_transfer(warm, fmt, QUANT_BLOCK)[0]["final_norm"]
    sdu._quant_result(await sdu.DeltaDecoder().decode("final_norm", warm_blob),
                      tflat["final_norm"])
    torch.cuda.synchronize()
    start.record()
    blobs, _ = sdu.quantize_transfer(flat, fmt, QUANT_BLOCK)
    end.record()
    end.synchronize()
    wire = sum(b.numel() for b in blobs.values())
    res.update({"wire_bytes": wire, "logical_bytes": 4 * n, "encode_ms": start.elapsed_time(end),
                "encode_bound_ms": (4 * n + wire) / HBM_BYTES_PER_S * 1e3,
                "blobs_on_device": all(b.device.type == dev.type for b in blobs.values())})
    samples = _quant_samples(flat)
    res["sample_tensors"] = len(samples)
    res["sample_mismatched"] = [
        k for k in samples
        if not torch.equal(blobs[k].cpu(),
                           sdu.quantize_transfer({k: flat[k].cpu()}, fmt, QUANT_BLOCK)[0][k])
    ]

    def clear() -> None:
        for t in tflat.values():
            t.zero_()
        torch.cuda.synchronize()

    def check(label: str) -> dict:
        """Every target bit-equal to the plain dequant of its blob in bf16,
        and within one keyframe step of the source."""
        bad, worst, ratio = [], 0.0, 0.0
        for k, t in tflat.items():
            plain = _plain_dequant(torch, blobs[k], t.numel()).reshape(t.shape)
            if not torch.equal(t, plain.to(torch.bfloat16)):
                bad.append(k)
            err, step = _within_step(t, flat[k], qmax)
            worst = max(worst, err)
            ratio = max(ratio, err / step if step else (0.0 if err == 0 else math.inf))
        return {"check": label, "bit_equal_plain": not bad, "mismatched": bad[:5],
                "max_abs_err": worst, "max_err_over_step": ratio}

    # The decode alone: every blob's head in one read, then each key decoded
    # into its target on the card, as a get decodes it.
    clear()
    torch.cuda.synchronize()
    start.record()
    heads = sdu._read_heads(blobs)
    for k, blob in blobs.items():
        st = await sdu.DeltaDecoder().decode(k, blob, head=heads.get(k))
        sdu._quant_result(st, tflat[k])
    end.record()
    end.synchronize()
    res.update({"decode_ms": start.elapsed_time(end),
                "decode_bound_ms": (wire + 2 * n) / HBM_BYTES_PER_S * 1e3})
    checks = [check("decode alone")]

    key = f"q/{fmt}"
    timings, plans, mem = {}, {}, {}

    async def step(name: str, coro) -> None:
        before = await _plan_counts(client)
        allocated = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        await coro
        torch.cuda.synchronize()
        timings[name] = time.perf_counter() - t0
        mem[name] = torch.cuda.memory_allocated(dev) - allocated
        plans[name] = _delta(await _plan_counts(client), before)

    rounds = [("put", "get"), ("reput", "reget")] + ([("reput_nocache", "reget_nocache")]
                                                     if no_cache else [])
    waits = {}
    for put, get in rounds:
        cache = client.plan_cache
        if put != "put":
            # The steady state, as main's: after the volume's warm-ups and
            # the client's page-locking (a training step's gap).
            waits[put] = {"warm_wait_s": await _wait_warm(client),
                          "wait_pinned_s": await client.wait_pinned()}
        if put.endswith("nocache"):
            client.plan_cache = None  # as StoreConfig(plan_cache=False) builds it
        try:
            clear()
            await step(put, tst.put_state_dict(key, src, transfer_quant=fmt, store_name="quant"))
            await step(get, tst.get_state_dict(key, targets, store_name="quant"))
        finally:
            client.plan_cache = cache
        checks.append(check(get))
    await client.delete_prefix(key)
    del blobs
    res.update({
        "checks": checks,
        "seconds": timings,
        "wire_gb_per_s": {k: wire / v / 1e9 for k, v in timings.items()},
        "bf16_equiv_gb_per_s": {k: 2 * n / v / 1e9 for k, v in timings.items()},
        "plans": plans,
        "waits": waits,
        "device_bytes_left": {k: v for k, v in mem.items() if "get" in k},
    })
    res["ok"] = (
        res["blobs_on_device"]
        and not res["sample_mismatched"]
        and all(c["bit_equal_plain"] and c["max_err_over_step"] <= 1.0 for c in checks)
        and all(v <= 0 for v in res["device_bytes_left"].values())
        and _plans_warm(plans, "reput", "reget")
    )
    return res


def plan_delta_layers(torch, dev) -> tuple[int, dict]:
    """Depth of the delta leg: its DELTA_BYTES_PER_PARAM of every parameter,
    and the transients of the largest leaf (about six f32 copies), fit in
    nine tenths of the card's free memory. Widths never change."""
    from torchstore_tpu_torch.workloads import LLAMA3_8B, llama_shapes

    geo = dict(LLAMA3_8B)
    per_layer = sum(math.prod(s) for s in _leaves(llama_shapes(**{**geo, "layers": 1})["layers"]))
    outer = sum(math.prod(s) for s in _leaves({**llama_shapes(**{**geo, "layers": 0}),
                                               "layers": {}}))
    largest = geo["vocab"] * geo["hidden"]
    free, total = torch.cuda.mem_get_info(dev)
    budget = 0.9 * free - 6 * 4 * largest
    layers = int((budget / DELTA_BYTES_PER_PARAM - outer) // per_layer)
    layers = max(1, min(geo["layers"], layers))
    return layers, {"card_free_bytes": free, "card_total_bytes": total,
                    "bytes_per_param": DELTA_BYTES_PER_PARAM,
                    "transient_bytes": 6 * 4 * largest, "budget_bytes": int(budget),
                    "needed_bytes": DELTA_BYTES_PER_PARAM * (outer + layers * per_layer)}


async def _delta_leg(torch, tst, sdu, client, layers: int, dev, geometry=None) -> dict:
    """The delta tier through the store at full width: versions v0..v4 of
    one channel (keyframe every 4): v0 keyframe, v1 an in-place update of
    the even layers, v2 no change (every key an alias: zero bytes), v3 an
    update of the odd layers and the embedding, v4 the cadence keyframe.
    The reader's state stays bit-equal to the encoder's baseline; a fresh
    decoder walks the chain to the same bytes at v3."""
    from torchstore_tpu_torch.workloads import llama_state_dict

    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    src = llama_state_dict(gen, device=dev, dtype=torch.float32, layers=layers,
                           **(geometry or {}))
    flat, _ = sdu.flatten_state_dict(src)
    targets = {k: torch.zeros(v.shape, dtype=torch.bfloat16, device=dev) for k, v in flat.items()}
    enc = sdu.DeltaEncoder("int8_block", QUANT_BLOCK, keyframe_every=DELTA_KEYFRAME)
    dec = sdu.DeltaDecoder()
    channel = "delta"
    versions = []
    fresh_equal = None
    for v in range(DELTA_VERSIONS):
        if v in (1, 3):
            for k, t in flat.items():
                layer = k.split("/")[1] if k.startswith("layers/") else None
                if (v == 1 and layer is not None and int(layer) % 2 == 0) or (
                        v == 3 and (k == "embed" or (layer is not None and int(layer) % 2))):
                    t.add_(0.05)  # the training step, in place
        before = sdu.sync_counters()
        t0 = time.perf_counter()
        await sdu.put_state_dict(client, f"{channel}/v{v}", flat, transfer_quant="int8_block",
                                 delta_ctx={"codec": enc, "version": v, "channel": channel})
        torch.cuda.synchronize()
        put_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        await sdu.get_state_dict(client, f"{channel}/v{v}", targets, delta_state=dec)
        torch.cuda.synchronize()
        get_s = time.perf_counter() - t0
        counts = _delta(sdu.sync_counters(), before)
        marker = await client.get(f"{channel}/v{v}/MAPPING")
        aliases = marker["quant"]["delta"]["aliases"]
        worst = max(err / max(step, 1e-30)
                    for err, step in (_within_step(targets[k], flat[k], 127)
                                      for k in flat))
        versions.append({
            "version": v,
            "wire_bytes": counts["quant_bytes_wire"],
            "keyframes": counts["delta_keyframes"],
            "aliases": len(aliases),
            "served_from_state": counts["delta_unchanged_served"],
            "stored_keys": len(await client.keys(f"{channel}/v{v}")),
            "put_s": put_s,
            "get_s": get_s,
            "state_equals_baseline": all(
                torch.equal(dec.state[k]["blocks"], enc.entries[k]["baseline"]) for k in flat),
            "state_on_device": all(dec.state[k]["blocks"].device.type == dev.type for k in flat),
            "max_err_over_step": worst,
        })
        if v == 3:
            # A joining reader: a fresh decoder walks the chain back to v0
            # for layer 0 (updated at v1: its v3 is an alias of v1's delta),
            # layer 1 (updated at v3: a delta on v0) and the final norm
            # (never updated: an alias of v0).
            part = [k for k in flat
                    if k.startswith(("layers/0/", "layers/1/")) or k == "final_norm"]
            fresh = sdu.DeltaDecoder()
            await sdu.get_state_dict(client, f"{channel}/v{v}",
                                     {k: torch.zeros_like(targets[k]) for k in part},
                                     strict=False, delta_state=fresh)
            fresh_equal = all(torch.equal(fresh.state[k]["blocks"], dec.state[k]["blocks"])
                              for k in part)
            del fresh
    await client.delete_prefix(channel)
    n = sum(t.numel() for t in flat.values())
    out = {"layers": layers, "tensors": len(flat), "params": n, "versions": versions,
           "fresh_reader_equal": fresh_equal, "keyframe_every": DELTA_KEYFRAME}
    keys = len(flat)
    out["ok"] = (
        all(x["state_equals_baseline"] and x["state_on_device"] and x["max_err_over_step"] <= 1.0
            for x in versions)
        and versions[0]["keyframes"] == keys and versions[4]["keyframes"] == keys
        and versions[2]["aliases"] == keys and versions[2]["wire_bytes"] == 0
        and versions[2]["stored_keys"] == 1  # the marker alone
        and versions[2]["served_from_state"] == keys
        and 0 < versions[1]["wire_bytes"] < versions[0]["wire_bytes"]
        and 0 < versions[3]["wire_bytes"] < versions[0]["wire_bytes"]
        and fresh_equal is True
    )
    return out


async def _quant_path(torch, layers: int, dev, geometry=None, delta_layers=None) -> dict:
    import torchstore_tpu_torch as tst
    from torchstore_tpu_torch import state_dict_utils as sdu
    from torchstore_tpu_torch.transport.shared_memory import PREFIX, SHM_DIR
    from torchstore_tpu_torch.workloads import llama_state_dict

    gen = torch.Generator(device=dev)
    gen.manual_seed(2024)
    src = llama_state_dict(gen, device=dev, dtype=torch.float32, layers=layers, **(geometry or {}))
    torch.cuda.reset_peak_memory_stats(dev)

    targets = _bf16_zeros_like(torch, src, dev)
    out: dict = {"layers": layers, "tensors": sum(1 for _ in _leaves(src)),
                 "params": sum(t.numel() for t in _leaves(src)), "block": QUANT_BLOCK}
    await tst.initialize(store_name="quant")
    pids = [p.pid for p in multiprocessing.active_children()]
    client = tst.client("quant")
    try:
        out["modes"] = {}
        for i, fmt in enumerate(QUANT_FMTS):
            out["modes"][fmt] = await _quant_mode(torch, tst, sdu, client, fmt, src, targets, dev,
                                                  no_cache=i == 0)
        out["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
        del src, targets
        torch.cuda.empty_cache()
        if delta_layers is None:
            delta_layers, plan = plan_delta_layers(torch, dev)
            out["delta_plan"] = plan
            if delta_layers < LAYERS:
                emit({"reduced": {"quant_delta_layers": delta_layers, "of": LAYERS}, **plan})
        torch.cuda.reset_peak_memory_stats(dev)
        out["delta"] = await _delta_leg(torch, tst, sdu, client, delta_layers, dev, geometry)
        out["delta"]["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
    finally:
        await tst.shutdown("quant")
    await asyncio.sleep(0.5)
    alive = [p.pid for p in multiprocessing.active_children()]
    own = set(pids) | {os.getpid()}
    leaked = [n for n in os.listdir(SHM_DIR)
              if n.startswith(PREFIX) and int(n[len(PREFIX):].split("_")[0]) in own]
    out.update({"processes_left": alive, "segments_left": leaked[:5]})
    out["ok"] = (all(m["ok"] for m in out["modes"].values()) and out["delta"]["ok"]
                 and not alive and not leaked)
    return out


def phase_quant(torch) -> dict:
    res = asyncio.run(_quant_path(torch, LAYERS, torch.device("cuda", 0)))
    res["phase"] = "quant"
    res["nvidia_smi"] = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    return res


# --------------------------------------------------------------------------
# channel: the versioned weight channel and layer-streamed sync
# --------------------------------------------------------------------------

CHANNEL_VERSIONS = 5  # barrier leg: v0..v4
CHANNEL_KEEP = 2
# The streamed delta leg: v0 keyframe, v1 an update, v2 no change (every
# key an alias, zero bytes), v3 the cadence keyframe. The encoder applies
# the cadence before the unchanged rule (in both packages), so a cadence
# of 2 would keyframe v2; 3 keeps v2 a delta version, and keep >= cadence.
CHANNEL_DELTA_VERSIONS = 4
CHANNEL_DELTA_KEYFRAME = 3
CHANNEL_DELTA_KEEP = 3


def _model_state(torch, cfg, layers: int, gen, dev) -> dict:
    """The port Llama's state dict at ``cfg``'s width and ``layers`` deep
    (Llama-3-8B: 291 tensors at 32 layers; the model's own key names, so
    ``forward_key_order`` orders them), fp32 standard normal on ``dev``
    from ``gen``, as ``workloads.llama_state_dict`` fills its tensors."""
    import dataclasses

    from torchstore_tpu_torch.models.llama import Llama

    model = Llama(dataclasses.replace(cfg, num_layers=layers), torch.device("meta"))
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    return {k: torch.randn(s, generator=gen, device=dev) for k, s in shapes.items()}


def _modules(order: list) -> list:
    """The keys of ``order`` grouped by module (embed, layer_i, final_norm,
    lm_head), in that order: one streamed fragment each."""
    groups: dict = {}
    for key in order:
        groups.setdefault(key.split(".")[0], []).append(key)
    return list(groups.values())


def plan_channel_layers(torch, dev) -> tuple[int, dict]:
    """Depth of the channel's barrier and streamed legs. /dev/shm holds
    keep + 1 bf16 versions (two live, one landing) and the volume's warm
    spare set; the card holds the fp32 source, the bf16 targets and a
    publish's bf16 cast. Widths never change."""
    from torchstore_tpu_torch.config import default_config
    from torchstore_tpu_torch.workloads import LLAMA3_8B, llama_shapes

    geo = dict(LLAMA3_8B)
    per_layer = sum(math.prod(s) for s in _leaves(llama_shapes(**{**geo, "layers": 1})["layers"]))
    outer = sum(math.prod(s) for s in _leaves({**llama_shapes(**{**geo, "layers": 0}),
                                               "layers": {}}))
    shm_budget = 0.8 * min(shm_free_bytes(), mem_available_bytes())
    free, _ = torch.cuda.mem_get_info(dev)
    card_budget = 0.9 * free
    params = lambda n: outer + n * per_layer  # noqa: E731
    shm_need = lambda n: (CHANNEL_KEEP + 2) * 2 * params(n)  # noqa: E731
    card_need = lambda n: (4 + 2 + 2) * params(n)  # noqa: E731
    layers = geo["layers"]
    while layers > 1 and (shm_need(layers) > shm_budget or card_need(layers) > card_budget):
        layers -= 1
    return layers, {"shm_budget_bytes": int(shm_budget), "shm_needed_bytes": shm_need(layers),
                    "shm_versions": CHANNEL_KEEP + 2, "card_budget_bytes": int(card_budget),
                    "card_needed_bytes": card_need(layers),
                    "pool_cap": default_config().shm_pool_max_bytes}


async def _channel_barrier(torch, staging, tst, client, src, targets, dev, gen) -> dict:
    """Versions v0..v4 of one keep=2 channel in bf16, each after a seeded
    in-place step on the card, each acquired in place by one subscriber."""
    from torchstore_tpu_torch.weight_channel import _versions_present

    bf16 = torch.bfloat16
    wire = 2 * sum(t.numel() for t in src.values())
    chunks = len(staging.plan_chunks(list(src.values()), bf16))
    pub = tst.WeightPublisher("chan", store_name="channel", keep=CHANNEL_KEEP)
    sub = tst.WeightSubscriber("chan", store_name="channel")
    rows = []
    for v in range(CHANNEL_VERSIONS):
        if v:
            for t in src.values():  # the training step, in place
                t.add_(torch.randn(t.shape, generator=gen, device=dev), alpha=1e-3)
        # The training step's gap, as main's reput waits it out: the
        # volume's warm-ups settle and the client's page-locking ends.
        warm_wait = await _wait_warm(client)
        pin_pending = client.shm_stats()["pin_pending"]
        pin_wait = await client.wait_pinned()
        for t in targets.values():
            t.zero_()
        torch.cuda.synchronize()
        before = await _pool_counts(client)
        launched, fell_back = staging.cast_kernel.launches, staging.cast_kernel.fallbacks
        t0 = time.perf_counter()
        version = await pub.publish(src, transfer_dtype=bf16)
        torch.cuda.synchronize()
        publish_s = time.perf_counter() - t0
        after_put = await _pool_counts(client)
        t0 = time.perf_counter()
        _, got = await sub.acquire(targets, timeout=600)
        torch.cuda.synchronize()
        acquire_s = time.perf_counter() - t0
        after = await _pool_counts(client)
        bad = [k for k, t in targets.items() if not torch.equal(t, src[k].to(bf16))]
        rows.append({
            "version": version, "acquired": got, "publish_s": publish_s, "acquire_s": acquire_s,
            "publish_gb_per_s": wire / publish_s / 1e9, "acquire_gb_per_s": wire / acquire_s / 1e9,
            "warm_wait_s": warm_wait, "pin_pending": pin_pending, "wait_pinned_s": pin_wait,
            "offers": {k: after_put[k] - before[k] for k in ("spare", "pooled", "miss")},
            "volume_created": after_put["volume_created"] - before["volume_created"],
            "cold_create": after_put["cold_create"] - before["cold_create"],
            "pinned": after["pinned"] - before["pinned"],
            "launches": staging.cast_kernel.launches - launched,
            "cast_fallbacks": staging.cast_kernel.fallbacks - fell_back,
            "versions_present": sorted(_versions_present("chan", await client.keys("chan"))),
            "mismatched": len(bad),
        })
    ok = (
        [r["acquired"] for r in rows] == list(range(CHANNEL_VERSIONS))
        and all(r["version"] == r["acquired"] and r["mismatched"] == 0 for r in rows)
        and all(r["cast_fallbacks"] == 0 for r in rows)
        and (dev.type != "cuda" or all(r["launches"] == chunks for r in rows))
        and all(len(r["versions_present"]) == min(r["version"] + 1, CHANNEL_KEEP) for r in rows)
    )
    return {"versions": rows, "chunks_per_publish": chunks, "wire_bytes": wire, "ok": ok,
            "publisher": pub, "subscriber": sub}


async def _channel_streamed(torch, staging, tst, client, pub, sub, src, targets, dev,
                            gen) -> dict:
    """One streamed publish, a fragment per module in forward order, with
    a streamed acquire beside it; then a barrier put over the streamed key,
    which the next streamed get serves through the barrier path."""
    from torchstore_tpu_torch import stream_sync
    from torchstore_tpu_torch.models.generate import forward_key_order

    bf16 = torch.bfloat16
    order = forward_key_order(list(src))
    fragments = _modules(order)
    chunks = sum(len(staging.plan_chunks([src[k] for k in frag], bf16)) for frag in fragments)
    for t in src.values():
        t.add_(torch.randn(t.shape, generator=gen, device=dev), alpha=1e-3)
    for t in targets.values():
        t.zero_()
    await _wait_warm(client)
    await client.wait_pinned()
    torch.cuda.synchronize()
    served: list = []
    stamps: dict = {}

    def on_layer(fk, value):
        stamps.setdefault("first", time.perf_counter())
        stamps["last"] = time.perf_counter()
        served.append(fk)

    counts0 = stream_sync.stream_counters()
    launched = staging.cast_kernel.launches
    task = asyncio.ensure_future(sub.acquire_streamed(targets, key_order=order,
                                                      on_layer=on_layer, timeout=600))
    await asyncio.sleep(0)
    cs = pub.stream(transfer_dtype=bf16)
    t0 = time.perf_counter()
    for frag in fragments:
        await cs.put({k: src[k] for k in frag})
    stamps["seal_start"] = time.perf_counter()
    version = await cs.seal()
    stamps["sealed"] = time.perf_counter()
    _, got = await task
    torch.cuda.synchronize()
    stamps["done"] = time.perf_counter()
    counts1 = stream_sync.stream_counters()
    bad = [k for k, t in targets.items() if not torch.equal(t, src[k].to(bf16))]
    out = {
        "version": version, "acquired": got, "fragments": len(fragments),
        "first_layer_s": stamps["first"] - t0, "last_layer_s": stamps["last"] - t0,
        "seal_s": stamps["sealed"] - t0, "acquire_done_s": stamps["done"] - t0,
        "overlap_ratio": counts1["overlap_ratio"],
        "launches": staging.cast_kernel.launches - launched, "chunks": chunks,
        "fallbacks": {k: counts1["fallbacks"][k] - counts0["fallbacks"][k]
                      for k in counts1["fallbacks"]},
        "served_in_order": served == order, "mismatched": len(bad),
    }
    # A barrier publish over the streamed key: the stream record stays, the
    # marker is the barrier's; the streamed get falls back to the barrier.
    for t in src.values():
        t.add_(torch.randn(t.shape, generator=gen, device=dev), alpha=1e-3)
    for t in targets.values():
        t.zero_()
    key = f"chan/v{version}"
    t0 = time.perf_counter()
    await tst.put_state_dict(key, src, transfer_dtype=bf16, store_name="channel")
    torch.cuda.synchronize()
    out["republish_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    await tst.get_state_dict_streamed(key, targets, timeout=600, store_name="channel")
    torch.cuda.synchronize()
    out["drift_get_s"] = time.perf_counter() - t0
    counts2 = stream_sync.stream_counters()
    out["drift_fallbacks"] = counts2["fallbacks"]["marker_drift"] - counts1["fallbacks"]["marker_drift"]
    out["drift_mismatched"] = sum(not torch.equal(t, src[k].to(bf16)) for k, t in targets.items())
    out["ok"] = (
        got == version and out["served_in_order"] and out["mismatched"] == 0
        and stamps["first"] < stamps["seal_start"]  # a layer served before the seal
        and not any(out["fallbacks"].values())
        and (dev.type != "cuda" or out["launches"] == chunks)
        and out["drift_fallbacks"] == 1 and out["drift_mismatched"] == 0
    )
    return out


async def _channel_delta(torch, tst, sdu, client, cfg, layers: int, dev, gen) -> dict:
    """The delta tier through a streamed channel at the depth the plan
    allows: int8_block, keyframe every 3, keep 3, v0..v3, v2's source left
    unchanged. The reader's state bit-equal to the encoder's baseline at
    every version; v2 ships nothing and serves every key from the reader's
    state; the targets within one keyframe step."""
    from torchstore_tpu_torch.models.generate import forward_key_order

    src = _model_state(torch, cfg, layers, gen, dev)
    order = forward_key_order(list(src))
    fragments = _modules(order)
    targets = {k: torch.zeros(v.shape, dtype=torch.bfloat16, device=dev) for k, v in src.items()}
    pub = tst.WeightPublisher("delta", store_name="channel", keep=CHANNEL_DELTA_KEEP,
                              transfer_quant="int8_block", delta=True,
                              keyframe_every=CHANNEL_DELTA_KEYFRAME)
    sub = tst.WeightSubscriber("delta", store_name="channel")
    rows = []
    for v in range(CHANNEL_DELTA_VERSIONS):
        if v in (1, 3):
            for k, t in src.items():
                layer = k.split(".")[0]
                odd = layer.startswith("layer_") and int(layer[6:]) % 2
                if (v == 1 and layer.startswith("layer_") and not odd) or (v == 3 and (odd or layer == "embed")):
                    t.add_(0.05)  # the training step, in place
        before = sdu.sync_counters()
        task = asyncio.ensure_future(sub.acquire_streamed(targets, key_order=order, timeout=600))
        await asyncio.sleep(0)
        t0 = time.perf_counter()
        cs = pub.stream()
        for frag in fragments:
            await cs.put({k: src[k] for k in frag})
        version = await cs.seal()
        _, got = await task
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _delta(sdu.sync_counters(), before)
        state = sub._delta_decoder().state
        worst = max(err / max(step, 1e-30)
                    for err, step in (_within_step(targets[k], src[k], 127) for k in src))
        rows.append({
            "version": version, "acquired": got, "seconds": seconds,
            "wire_bytes": counts["quant_bytes_wire"], "keyframes": counts["delta_keyframes"],
            "unchanged": counts["delta_unchanged_keys"],
            "served_from_state": counts["delta_unchanged_served"],
            "stored_keys": len(await client.keys(f"delta/v{version}")),
            "state_equals_baseline": all(torch.equal(state[k]["blocks"],
                                                     pub._codec.entries[k]["baseline"])
                                         for k in src),
            "state_on_device": all(state[k]["blocks"].device.type == dev.type for k in src),
            "max_err_over_step": worst,
        })
    keys = len(src)
    out = {"layers": layers, "tensors": keys, "params": sum(t.numel() for t in src.values()),
           "keyframe_every": CHANNEL_DELTA_KEYFRAME, "keep": CHANNEL_DELTA_KEEP, "versions": rows}
    out["ok"] = (
        [r["acquired"] for r in rows] == list(range(CHANNEL_DELTA_VERSIONS))
        and all(r["state_equals_baseline"] and r["state_on_device"]
                and r["max_err_over_step"] <= 1.0 for r in rows)
        and rows[0]["keyframes"] == keys and rows[3]["keyframes"] == keys
        and rows[2]["wire_bytes"] == 0 and rows[2]["unchanged"] == keys
        and rows[2]["served_from_state"] == keys and rows[2]["stored_keys"] == 1
        and 0 < rows[1]["wire_bytes"] < rows[0]["wire_bytes"]
    )
    return out


async def _channel_path(torch, staging, layers: int, dev, delta_layers=None, cfg=None) -> dict:
    """``cfg``: the model whose width the state dict takes (Llama-3-8B)."""
    import torchstore_tpu_torch as tst
    from torchstore_tpu_torch import state_dict_utils as sdu
    from torchstore_tpu_torch.models.llama import LlamaConfig
    from torchstore_tpu_torch.transport.shared_memory import PREFIX, SHM_DIR

    cfg = cfg or LlamaConfig.llama3_8b()
    gen = torch.Generator(device=dev)
    gen.manual_seed(77)
    src = _model_state(torch, cfg, layers, gen, dev)
    targets = {k: torch.zeros(v.shape, dtype=torch.bfloat16, device=dev) for k, v in src.items()}
    out: dict = {"layers": layers, "tensors": len(src),
                 "params": sum(t.numel() for t in src.values())}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    staging.cast_kernel.launches = 0  # count the channel path's launches only
    staging.cast_kernel.fallbacks = 0
    await tst.initialize(store_name="channel")
    pids = [p.pid for p in multiprocessing.active_children()]
    client = tst.client("channel")
    try:
        barrier = await _channel_barrier(torch, staging, tst, client, src, targets, dev, gen)
        pub, sub = barrier.pop("publisher"), barrier.pop("subscriber")
        out["barrier"] = barrier
        out["streamed"] = await _channel_streamed(torch, staging, tst, client, pub, sub, src,
                                                  targets, dev, gen)
        out["launches"] = staging.cast_kernel.launches
        out["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        del src, targets
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            if delta_layers is None:
                delta_layers, plan = plan_delta_layers(torch, dev)
                out["delta_plan"] = plan
                if delta_layers < LAYERS:
                    emit({"reduced": {"channel_delta_layers": delta_layers, "of": LAYERS},
                          **plan})
        out["delta"] = await _channel_delta(torch, tst, sdu, client, cfg, delta_layers, dev, gen)
    finally:
        await tst.shutdown("channel")
    await asyncio.sleep(0.5)
    alive = [p.pid for p in multiprocessing.active_children() if p.pid in pids]
    own = set(pids) | {os.getpid()}
    leaked = [n for n in os.listdir(SHM_DIR)
              if n.startswith(PREFIX) and int(n[len(PREFIX):].split("_")[0]) in own]
    out.update({"processes_left": alive, "segments_left": leaked[:5]})
    out["ok"] = (out["barrier"]["ok"] and out["streamed"]["ok"] and out["delta"]["ok"]
                 and not alive and not leaked)
    return out


def phase_channel(torch, staging) -> dict:
    dev = torch.device("cuda", 0)
    layers, plan = plan_channel_layers(torch, dev)
    if layers < LAYERS:
        emit({"reduced": {"channel_layers": layers, "of": LAYERS}, **plan})
    res = asyncio.run(_channel_path(torch, staging, layers, dev))
    res["phase"] = "channel"
    res["plan"] = plan
    res["nvidia_smi"] = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    return res


# --------------------------------------------------------------------------
# direct_device: the device rung of direct weight sync
# --------------------------------------------------------------------------

DIGEST_CHUNK = 1 << 24  # 16-bit words per digest chunk
DD_KEY = "dd_policy"


def _digest_weights(torch, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(97)
    return torch.randint(1, 1 << 20, (DIGEST_CHUNK,), generator=gen, device=dev)


def _digest_one(torch, t, weights) -> int:
    """A position-weighted int64 sum of ``t``'s 16-bit words (wrapping):
    one number per tensor, computed alike in every process of the phase."""
    words = t.contiguous().view(-1).view(torch.int16)
    total = torch.zeros((), dtype=torch.int64, device=t.device)
    for n, i in enumerate(range(0, words.numel(), DIGEST_CHUNK)):
        chunk = words[i:i + DIGEST_CHUNK].long()
        total += (chunk * weights[:chunk.numel()]).sum() * (n + 1)
    return int(total)


class DeviceRungGenerator(_Actor):
    """Leg (b)'s generator: a process of its own on the trainer's card. It
    pulls the trainer's device-rung publication of ``key`` into bf16
    targets on the card (the port's entry point; the route is CUDA IPC)
    and digests them."""

    def __init__(self, key: str, shapes: dict, device: str) -> None:
        self.key = key
        self.shapes = shapes
        self.device = device
        self.targets = None

    @_endpoint
    async def pull(self) -> dict:
        import torch

        import torchstore_tpu_torch as tst
        from torchstore_tpu_torch import direct_weight_sync as dws
        from torchstore_tpu_torch.transport import device_transfer as dt

        dev = torch.device(self.device)
        cuda = dev.type == "cuda"
        if self.targets is None:
            self.targets = {k: torch.zeros(s, dtype=torch.bfloat16, device=dev)
                            for k, s in self.shapes.items()}
            if cuda:  # the peak from here on: the targets and what the pulls add
                torch.cuda.reset_peak_memory_stats(dev)
        allocated = (lambda: torch.cuda.memory_allocated(dev)) if cuda else (lambda: 0)
        if cuda:
            torch.cuda.synchronize(dev)
        before = allocated()
        t0 = time.perf_counter()
        await tst.get_state_dict(self.key, self.targets, direct=True)
        if cuda:
            torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        left = allocated() - before
        weights = _digest_weights(torch, dev)
        return {
            "seconds": seconds,
            "digest": {k: _digest_one(torch, t, weights) for k, t in self.targets.items()},
            "ipc_pulls": dws.DEVICE_IPC_PULLS.total(),
            "local_pulls": dws.DEVICE_LOCAL_PULLS.total(),
            "fallbacks": dws.DEVICE_FALLBACKS.total(),
            "ipc_opens": dt.DeviceTransferEngine.get().opens,
            "device_bytes_left": left,
            "peak_device_bytes": torch.cuda.max_memory_allocated(dev) if cuda else 0,
            "pid": os.getpid(),
        }

    async def on_stop(self) -> None:
        """Let go of the targets and the opened staging (the source's
        memory is freed only once every opener released it)."""
        import torchstore_tpu_torch as tst

        self.targets = None
        await tst.shutdown()


def plan_direct_device_layers(torch, dev) -> tuple[int, dict]:
    """Depth of the direct_device phase. The card holds the fp32 source,
    its bf16 staging and one process's bf16 targets (8 bytes a parameter),
    plus a check's bf16 cast of the largest tensor; /dev/shm holds the
    fallback's host copy of the staging and leg (e)'s host-rung staging
    (bf16 each). Widths never change."""
    from torchstore_tpu_torch.workloads import LLAMA3_8B, llama_shapes

    geo = dict(LLAMA3_8B)
    per_layer = sum(math.prod(s) for s in _leaves(llama_shapes(**{**geo, "layers": 1})["layers"]))
    outer = sum(math.prod(s) for s in _leaves({**llama_shapes(**{**geo, "layers": 0}),
                                               "layers": {}}))
    largest = geo["vocab"] * geo["hidden"]
    free, _ = torch.cuda.mem_get_info(dev)
    card_budget = 0.9 * free
    shm_budget = 0.8 * min(shm_free_bytes(), mem_available_bytes())
    params = lambda n: outer + n * per_layer  # noqa: E731
    card_need = lambda n: 8 * params(n) + 2 * largest  # noqa: E731
    shm_need = lambda n: 2 * 2 * params(n)  # noqa: E731
    layers = geo["layers"]
    while layers > 1 and (card_need(layers) > card_budget or shm_need(layers) > shm_budget):
        layers -= 1
    return layers, {"card_budget_bytes": int(card_budget), "card_needed_bytes": card_need(layers),
                    "shm_budget_bytes": int(shm_budget), "shm_needed_bytes": shm_need(layers)}


async def _direct_device_path(torch, staging, layers: int, dev, cfg=None) -> dict:
    """The device rung at Llama-3-8B width (the port Llama's 291 tensors,
    fp32 on the card, bf16 transfer, bf16 targets on the card), five legs
    through the port's entry points: (a) in process, (b) a generator
    process pulling over CUDA IPC, (c) forced fallbacks to the host
    staging, (d) a refresh racing a pull, (e) an ordered host-rung pull."""
    import dataclasses

    import torchstore_tpu_torch as tst
    from torchstore_tpu_torch import direct_weight_sync as dws
    from torchstore_tpu_torch import state_dict_utils as sdu
    from torchstore_tpu_torch.models.generate import forward_key_order
    from torchstore_tpu_torch.runtime import spawn_actors
    from torchstore_tpu_torch.transport.shared_memory import PREFIX, SHM_DIR
    from torchstore_tpu_torch.workloads import llama3_8b_config

    bf16 = torch.bfloat16
    cuda = dev.type == "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(2468)
    src = _model_state(torch, cfg or llama3_8b_config(layers), layers, gen, dev)
    n_params = sum(t.numel() for t in src.values())
    wire = 2 * n_params
    chunks = len(staging.plan_chunks(list(src.values()), bf16))
    weights = _digest_weights(torch, dev)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def allocated() -> int:
        return torch.cuda.memory_allocated(dev) if cuda else 0

    def make_targets() -> dict:
        out = {k: torch.zeros(v.shape, dtype=bf16, device=dev) for k, v in src.items()}
        sync()
        return out

    def check(label, targets) -> dict:
        """Every target bit-equal to its source's bf16 cast (K1's plain
        version, on the card)."""
        bad = [k for k, t in targets.items()
               if not torch.equal(t.view(torch.int16), src[k].to(bf16).view(torch.int16))]
        return {"check": label, "bit_equal": not bad, "mismatched": bad[:5]}

    def counters() -> dict:
        return {"local_pulls": dws.DEVICE_LOCAL_PULLS.total(),
                "ipc_pulls": dws.DEVICE_IPC_PULLS.total(),
                "fallbacks": dws.DEVICE_FALLBACKS.total(),
                "retries": dws.PULL_RETRIES.total(), "k1": staging.cast_kernel.launches}

    def moved(before) -> dict:
        return {k: v - before[k] for k, v in counters().items()}

    def step_row(seconds) -> dict:
        return {"s": seconds, "gb_per_s": wire / seconds / 1e9}

    async def timed(coro) -> float:
        t0 = time.perf_counter()
        await coro
        sync()
        return time.perf_counter() - t0

    def train_step() -> None:
        for t in src.values():  # the training step, in place
            t.add_(torch.randn(t.shape, generator=gen, device=dev), alpha=1e-3)

    async def publish(store="default") -> dict:
        launched = staging.cast_kernel.launches
        row = step_row(await timed(tst.put_state_dict(DD_KEY, src, transfer_dtype=bf16,
                                                      direct=True, store_name=store)))
        return {**row, "k1_launches": staging.cast_kernel.launches - launched}

    async def pull(targets, store="default", **kw) -> dict:
        before = allocated()
        row = step_row(await timed(tst.get_state_dict(DD_KEY, targets, direct=True,
                                                      store_name=store, **kw)))
        return {**row, "device_bytes_left": allocated() - before}

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    staging.cast_kernel.launches = 0  # count this phase's launches only
    staging.cast_kernel.fallbacks = 0
    out: dict = {"layers": layers, "tensors": len(src), "params": n_params, "wire_bytes": wire,
                 "chunks_per_publish": chunks,
                 "alloc_conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF", "")}
    legs: dict = {}
    await tst.initialize(store_name="default")
    pids = [p.pid for p in multiprocessing.active_children()]
    client = tst.client()
    cache = sdu._direct_cache(client)
    try:
        # (a) in process: publish, pull, an in-place step, republish, repull.
        targets = make_targets()
        before = counters()
        leg = {"publish": await publish()}
        source = cache.sources[(DD_KEY, 0)]
        leg["pull"] = await pull(targets)
        checks = [check("pull", targets)]
        train_step()
        leg["republish"] = await publish()
        leg["repull"] = await pull(targets)
        checks.append(check("repull", targets))
        leg.update(checks=checks, counters=moved(before),
                   rung=tst.direct_sync_stats(DD_KEY)["rung"],
                   staging_on_card=str(source._blocks[0].device),
                   staging_blocks=len(source._blocks))
        leg["ok"] = (all(c["bit_equal"] for c in checks) and leg["rung"] == "device"
                     and leg["counters"]["local_pulls"] == 2 and leg["counters"]["fallbacks"] == 0
                     and all(leg[s]["device_bytes_left"] <= 0 for s in ("pull", "repull")))
        legs["a_in_process"] = leg
        emit({"direct_device_leg": "a_in_process", **leg})

        # (c) forced fallback: a dest that cannot see the source's card.
        info = dict(source.device_info)
        info["entries"] = [dataclasses.replace(e, spec=dataclasses.replace(
            e.spec, placement=dataclasses.replace(e.spec.placement, card="GPU-" + "0" * 32)))
            for e in info["entries"]]
        before = counters()
        mats = source.host_materializations
        dest = dws.DirectWeightSyncDest()
        try:
            t = await timed(dest.pull_device([info], targets))
            leg = {"fallback_pull": {**step_row(t), "materializations":
                                     source.host_materializations - mats}}
            checks = [check("fallback pull", targets)]
            train_step()
            leg["republish"] = await publish()
            for v in targets.values():
                v.zero_()
            keys = list(targets)
            halves = [{k: targets[k] for k in keys[0::2]}, {k: targets[k] for k in keys[1::2]}]
            dests = [dws.DirectWeightSyncDest() for _ in halves]
            gen_before, mats = source._read_gen(), source.host_materializations
            t0 = time.perf_counter()
            await asyncio.gather(*(d.pull_device([info], half) for d, half in zip(dests, halves)))
            sync()
            leg["concurrent_pulls"] = {**step_row(time.perf_counter() - t0),
                                       "dests": len(dests),
                                       "materializations": source.host_materializations - mats,
                                       "generation_moved": source._read_gen() - gen_before}
            for d in dests:
                await d.close()
            checks.append(check("two concurrent fallback dests", targets))
        finally:
            await dest.close()
        leg.update(checks=checks, counters=moved(before))
        leg["ok"] = (all(c["bit_equal"] for c in checks) and leg["counters"]["fallbacks"] == 3
                     and leg["fallback_pull"]["materializations"] == 1
                     and leg["concurrent_pulls"]["materializations"] == 1
                     and leg["concurrent_pulls"]["generation_moved"] == 0
                     and leg["counters"]["local_pulls"] == leg["counters"]["ipc_pulls"] == 0)
        legs["c_fallback"] = leg
        emit({"direct_device_leg": "c_fallback", **leg})

        # (d) a refresh issued during a pull: exactly one retry, the result
        # the new content.
        dest = cache.dests[DD_KEY][0]
        calls = {"n": 0}
        real = dest._read_gen

        async def racing_read(host, port):
            calls["n"] += 1
            if calls["n"] == 2:  # the first attempt's re-read: a publish lands first
                train_step()
                await tst.put_state_dict(DD_KEY, src, transfer_dtype=bf16, direct=True)
            return await real(host, port)

        before = counters()
        dest._read_gen = racing_read
        try:
            leg = {"pull": await pull(targets)}
        finally:
            del dest._read_gen
        leg.update(checks=[check("pull raced by a publish", targets)], counters=moved(before),
                   generation_reads=calls["n"])
        leg["ok"] = (leg["checks"][0]["bit_equal"] and leg["counters"]["retries"] == 1
                     and leg["counters"]["local_pulls"] == 1
                     and leg["counters"]["fallbacks"] == 0
                     and (not cuda or leg["counters"]["k1"] == chunks))
        legs["d_race"] = leg
        emit({"direct_device_leg": "d_race", **leg})

        # (e) ordered host-rung pull (a store whose client has the device
        # rung off): key_order = forward_key_order.
        order = forward_key_order(src)
        await tst.initialize(store_name="dd_host", config=tst.StoreConfig(ici_enabled=False))
        pids += [p.pid for p in multiprocessing.active_children() if p.pid not in pids]
        try:
            before = counters()
            for v in targets.values():
                v.zero_()
            leg = {"publish": await publish("dd_host")}
            landed = []
            t0 = time.perf_counter()
            leg["pull"] = await pull(targets, "dd_host", key_order=order,
                                     on_layer=lambda k, v: landed.append(
                                         (k, time.perf_counter() - t0)))
            rung = tst.direct_sync_stats(DD_KEY, store_name="dd_host")["rung"]
        finally:
            await tst.shutdown("dd_host")
        leg.update(checks=[check("ordered pull", targets)], counters=moved(before), rung=rung,
                   in_order=[k for k, _ in landed] == order,
                   first_key_s=landed[0][1], last_key_s=landed[-1][1], keys=len(landed))
        leg["ok"] = (leg["checks"][0]["bit_equal"] and leg["in_order"] and leg["rung"] == "host"
                     and leg["counters"]["fallbacks"] == leg["counters"]["local_pulls"] == 0)
        legs["e_ordered_host"] = leg
        emit({"direct_device_leg": "e_ordered_host", **leg})
        del targets
        if cuda:
            torch.cuda.empty_cache()
        out["source_peak_device_bytes"] = torch.cuda.max_memory_allocated(dev) if cuda else 0

        # (b) a generator process on the same card pulls over CUDA IPC, then
        # again after a republish.
        before = counters()
        mesh = await spawn_actors(1, DeviceRungGenerator, "tst_dd_generator", DD_KEY,
                                  {k: tuple(v.shape) for k, v in src.items()}, str(dev))
        try:
            ref = mesh.refs[0]
            leg = {"pull": await ref.pull.call_one()}
            want = {k: _digest_one(torch, v.to(bf16), weights) for k, v in src.items()}
            checks = [{"check": "ipc pull", "bit_equal": leg["pull"]["digest"] == want}]
            train_step()
            leg["republish"] = await publish()
            leg["repull"] = await ref.pull.call_one()
            want = {k: _digest_one(torch, v.to(bf16), weights) for k, v in src.items()}
            checks.append({"check": "ipc repull", "bit_equal": leg["repull"]["digest"] == want})
        finally:
            await mesh.stop()
        for s in ("pull", "repull"):
            leg[s].pop("digest")
            leg[s]["gb_per_s"] = wire / leg[s]["seconds"] / 1e9
        last = leg["repull"]
        leg.update(checks=checks, counters=moved(before))
        leg["ok"] = (all(c["bit_equal"] for c in checks) and last["ipc_pulls"] == 2
                     and last["fallbacks"] == 0 and last["local_pulls"] == 0
                     and last["ipc_opens"] == 1
                     and all(leg[s]["device_bytes_left"] <= 0 for s in ("pull", "repull")))
        legs["b_cross_process"] = leg
        emit({"direct_device_leg": "b_cross_process", **leg})
    finally:
        await tst.shutdown()
    await asyncio.sleep(0.5)
    alive = [p.pid for p in multiprocessing.active_children()]
    own = set(pids) | {os.getpid()}
    leaked = [n for n in os.listdir(SHM_DIR)
              if n.startswith(PREFIX) and int(n[len(PREFIX):].split("_")[0]) in own]
    publishes = [leg[s]["k1_launches"] for leg in legs.values() for s in ("publish", "republish")
                 if s in leg]
    out.update({"legs": legs, "launches": staging.cast_kernel.launches,
                "launches_per_publish": publishes,
                "cast_fallbacks": staging.cast_kernel.fallbacks,
                "processes_left": alive, "segments_left": leaked[:5]})
    out["ok"] = (all(leg["ok"] for leg in legs.values())
                 and (not cuda or all(n == chunks for n in publishes))
                 and staging.cast_kernel.fallbacks == 0 and not alive and not leaked)
    return out


def phase_direct_device(torch, staging) -> dict:
    dev = torch.device("cuda", 0)
    layers, plan = plan_direct_device_layers(torch, dev)
    if layers < LAYERS:
        emit({"reduced": {"direct_device_layers": layers, "of": LAYERS}, **plan})
    res = asyncio.run(_direct_device_path(torch, staging, layers, dev))
    res["phase"] = "direct_device"
    res["plan"] = plan
    res["nvidia_smi"] = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    return res


# --------------------------------------------------------------------------
# attention: the flash kernel, ring attention, the model
# --------------------------------------------------------------------------

# (label, b, sq, sk, h, hk, d); "8b" is Llama-3-8B attention width. A
# "packed" case slices q, k and v from one (b, s, h + 2 hk, d) projection.
FLASH_CASES = (
    ("8b-1024", 1, 1024, 1024, HEADS, KV_HEADS, HEAD_DIM),
    ("8b-4096", 1, 4096, 4096, HEADS, KV_HEADS, HEAD_DIM),
    ("8b-8192", 1, 8192, 8192, HEADS, KV_HEADS, HEAD_DIM),
    ("8b-1000-b2", 2, 1000, 1000, HEADS, KV_HEADS, HEAD_DIM),
    ("8b-1025", 1, 1025, 1025, HEADS, KV_HEADS, HEAD_DIM),
    ("8b-sq1000-sk1537", 1, 1000, 1537, HEADS, KV_HEADS, HEAD_DIM),
    ("8b-sq2048-sk1025", 1, 2048, 1025, HEADS, KV_HEADS, HEAD_DIM),
    ("mha-d64-1025", 2, 1025, 1025, 16, 16, 64),
    ("mha-d256-sq1024-sk1000", 1, 1024, 1000, 16, 16, 256),
    ("gqa-d256-4096", 1, 4096, 4096, 16, 4, 256),
    ("gqa-d72-300", 1, 300, 300, 4, 2, 72),
    ("8b-sq77-sk40", 1, 77, 40, HEADS, KV_HEADS, HEAD_DIM),
    ("8b-sq8192-sk1", 1, 8192, 1, HEADS, KV_HEADS, HEAD_DIM),
    ("8b-sq1000-sk1537-b4", 4, 1000, 1537, HEADS, KV_HEADS, HEAD_DIM),
    ("packed-8b-2048", 1, 2048, 2048, HEADS, KV_HEADS, HEAD_DIM),
)
FLASH_TOL = {
    "stats": "m, l: |got - want| <= 1e-5 + 1e-4 |want|; acc the same after dividing "
             "got and want by want's l (fp32 and bf16 inputs)",
    "o_fp32": "|got - want| <= 1e-5 + 1e-4 |want|",
    "o_bf16": "|got - want| <= 1e-5 + 2 bf16 ulps of want",
    "sm90_vs_blockwise": "against stats_blockwise_reference (the same arithmetic: bf16 p, "
                         "block_k 128): m, l as 'stats'; acc (on o's scale) within "
                         "1e-5 + 1e-4 |want| + flip, o within 1e-5 + 2 bf16 ulps + flip, "
                         "where flip = 2**-6 max_k |v_kd| / l: the two fp32 p differ in "
                         "their last bits (q.k^T summed in another order) and can round to "
                         "adjacent bf16 values, one bf16 ulp (<= 2**-7 p) per term; flip "
                         "allows two such terms at the row's largest weight (p <= 1). "
                         "'strict_outside' counts acc values outside 1e-5 + 1e-4 |want|",
    "sm90_vs_fp32": "against the fp32 plain version, with SDPA (is_causal, enable_gqa) on "
                    "the same inputs as the yardstick: the kernel's o and acc/l each have "
                    "a worst error <= 2x SDPA's worst error against attention_reference; "
                    "m, l as 'stats' (both sum the fp32 p). bf16 p before P.V, as in "
                    "SDPA's own kernels, is the rounding the fp32 version does not make",
}
SDPA_YARDSTICK = 2.0  # the sm90 kernel's worst error may be this multiple of SDPA's
# The timed shapes: b, s, h, hk, d (bf16).
FLASH_TIMED = (1, 8192, HEADS, KV_HEADS, HEAD_DIM)
FLASH_TIMED_SHORT = 4096  # the ring phase's backward length


def _bf16_ulp(torch, x):
    """One bf16 ulp of each value of ``x`` (8 significant bits)."""
    _, exp = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), exp - 8)


def _within(torch, got, want, rtol=1e-4, atol=1e-5, ulps=None, extra=None) -> dict:
    """Worst error of ``got`` against ``want`` and the count of values
    outside the tolerance: atol + rtol |want|, or ``ulps`` bf16 ulps (plus
    ``atol``), plus the tensor ``extra`` where given."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if ulps is None:
        allowed = atol + rtol * want.abs()
    else:
        allowed = atol + ulps * _bf16_ulp(torch, want)
    if extra is not None:
        allowed = allowed + extra
    bad = int((err > allowed).sum().item()) + int((~torch.isfinite(got)).sum().item())
    return {"max_abs_err": float(err.max().item()) if err.numel() else 0.0, "outside": bad}


def _qkv(torch, gen, dev, b, sq, sk, h, hk, d, dtype, packed=False):
    if packed:  # one projection output, sliced: q, k, v are strided views
        qkv = torch.randn((b, sq, h + 2 * hk, d), generator=gen, device=dev).to(dtype)
        return qkv[:, :, :h], qkv[:, :, h:h + hk], qkv[:, :, h + hk:]
    q = torch.randn((b, sq, h, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, sk, hk, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, sk, hk, d), generator=gen, device=dev).to(dtype)
    return q, k, v


def _sdpa(torch, q, k, v, causal):
    """SDPA on (b, s, h, d) tensors: the yardstick, never called by the port."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=causal,
        enable_gqa=True,
    ).transpose(1, 2)


def _flash_counts(flash) -> dict:
    return {"flash_stats": dict(flash.stats_kernel.launches_by_variant),
            "flash": dict(flash.attention_kernel.launches_by_variant)}


def _reset_flash_counts(flash, counts=None) -> None:
    """Set both modes' launch counts to 0, or back to ``counts``."""
    for name, kernel in (("flash_stats", flash.stats_kernel), ("flash", flash.attention_kernel)):
        by = counts[name] if counts else {v: 0 for v in kernel.launches_by_variant}
        kernel.launches_by_variant = dict(by)
        kernel.launches = sum(by.values())


def _flip_allowance(torch, v, l, h):
    """2**-6 max_k |v_kd| / l per (b, h, sq, d): two bf16 roundings of p
    that went to adjacent values, at a weight p <= 1 (FLASH_TOL)."""
    vmax = v.float().abs().amax(dim=1).repeat_interleave(h // v.shape[2], dim=1)  # (b, h, d)
    return 2.0**-6 * vmax[:, :, None, :] / l[..., None]


def _check_sm90(torch, flash, q, k, v, causal, got, o) -> dict:
    """The two comparisons of an sm90 case: against the blockwise plain
    version, and against the fp32 one with SDPA as the yardstick."""
    h = q.shape[2]
    bw = flash.stats_blockwise_reference(q, k, v, causal, 128)
    n = bw[2][..., None]
    flip = _flip_allowance(torch, v, bw[2], h)
    res = {"bw_acc": _within(torch, got[0] / n, bw[0] / n, extra=flip)}
    res["bw_acc"]["strict_outside"] = _within(torch, got[0] / n, bw[0] / n)["outside"]
    res.update({f"bw_{name}": _within(torch, g, w) for name, g, w in zip("ml", got[1:], bw[1:])})
    bw_o = flash._normalize(bw[0], bw[2], q.dtype)
    res["bw_o"] = _within(torch, o, bw_o, atol=1e-5, ulps=2, extra=flip.transpose(1, 2))
    del bw, bw_o, flip
    want = flash.stats_reference(q, k, v, causal)
    res.update({name: _within(torch, g, w) for name, g, w in zip("ml", got[1:], want[1:])})
    o_ref = want[0] / want[2][..., None]  # fp32 o, (b, h, sq, d)
    o_want = flash._normalize(want[0], want[2], q.dtype)
    sdpa = _sdpa(torch, q, k, v, causal)
    yard = _within(torch, sdpa, o_want, atol=1e-5, ulps=2)
    kernel_o = float((o.float() - o_want.float()).abs().max().item())
    kernel_acc = float((got[0] / got[2][..., None] - o_ref).abs().max().item())
    limit = SDPA_YARDSTICK * yard["max_abs_err"]
    res["vs_fp32"] = {
        "sdpa_max_abs_err": yard["max_abs_err"], "sdpa_outside_2ulps": yard["outside"],
        "o_max_abs_err": kernel_o, "acc_over_l_max_abs_err": kernel_acc,
        "outside": int(kernel_o > limit) + int(kernel_acc > limit),
    }
    return res


def phase_flash_parity(torch, flash) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    cases = []
    worst = {f"{mode}_{variant}": 0.0 for mode in ("stats", "o") for variant in ("sm90", "simt")}
    for label, b, sq, sk, h, hk, d in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _qkv(torch, gen, dev, b, sq, sk, h, hk, d, dtype,
                           packed=label.startswith("packed"))
            # Every case's strides pass TMA's rule, so dtype and d decide.
            variant = "sm90" if dtype == torch.bfloat16 and d in (64, 128) else "simt"
            for causal in (False, True):
                before = _flash_counts(flash)
                got = flash.stats_kernel(q, k, v, causal)
                o = flash.attention_kernel(q, k, v, causal)
                torch.cuda.synchronize()
                after = _flash_counts(flash)
                ran = {mode: [n for n in after[mode] if after[mode][n] != before[mode][n]]
                       for mode in after}
                if variant == "sm90":
                    res = _check_sm90(torch, flash, q, k, v, causal, got, o)
                    err_stats = max(res["bw_acc"]["max_abs_err"], res["m"]["max_abs_err"],
                                    res["l"]["max_abs_err"])
                    err_o = res["vs_fp32"]["o_max_abs_err"]
                else:
                    want = flash.stats_reference(q, k, v, causal)
                    # acc is a sum of sk terms whose magnitudes add up to ~l E|v|, so
                    # it is held on the scale of o = acc / l (want's l for both).
                    l_want = want[2][..., None]
                    res = {"acc": _within(torch, got[0] / l_want, want[0] / l_want)}
                    res["acc"]["raw_max_abs_err"] = float((got[0] - want[0]).abs().max().item())
                    res.update({n: _within(torch, g, w) for n, g, w in zip("ml", got[1:], want[1:])})
                    del want, l_want
                    o_want = flash.attention_reference(q, k, v, causal)
                    if dtype == torch.bfloat16:
                        res["o"] = _within(torch, o, o_want, atol=1e-5, ulps=2)
                    else:
                        res["o"] = _within(torch, o, o_want)
                    del o_want
                    err_stats = max(res["m"]["max_abs_err"], res["l"]["max_abs_err"],
                                    res["acc"]["raw_max_abs_err"])
                    err_o = res["o"]["max_abs_err"]
                del got, o
                ok = all(r["outside"] == 0 for r in res.values()) and ran == {
                    "flash_stats": [variant], "flash": [variant]}
                worst[f"stats_{variant}"] = max(worst[f"stats_{variant}"], err_stats)
                worst[f"o_{variant}"] = max(worst[f"o_{variant}"], err_o)
                cases.append({
                    "case": f"{label} {str(dtype)[6:]} {'causal' if causal else 'full'}",
                    "variant": variant, "launched": ran, "ok": ok, **res,
                })
            del q, k, v
            torch.cuda.empty_cache()
    _reset_flash_counts(flash)  # comparison launches are not path launches
    failed = [c for c in cases if not c["ok"]]
    rows = []
    for c in cases:
        row = {"case": c["case"], "variant": c["variant"]}
        if c["variant"] == "sm90":
            row.update({"bw_acc": c["bw_acc"]["max_abs_err"],
                        "bw_acc_strict_outside": c["bw_acc"]["strict_outside"],
                        "bw_o": c["bw_o"]["max_abs_err"], **c["vs_fp32"]})
            row.pop("outside")
        else:
            row.update({"acc": c["acc"]["max_abs_err"], "o": c["o"]["max_abs_err"]})
        rows.append(row)
    return {
        "phase": "flash_parity",
        "ok": not failed,
        "cases": len(cases),
        "sm90_cases": sum(c["variant"] == "sm90" for c in cases),
        "failed": failed[:10],
        "worst": worst,
        "tolerance": FLASH_TOL,
        "rows": rows,
    }


def flash_bound(b, sq, sk, h, hk, d, causal, in_bytes, stats,
                flop_per_s=BF16_FLOP_PER_S) -> dict:
    """Least time for one call: 4 b h sq sk d operations (halved when
    causal, as benchmarks/flash_kernel_bench.py counts) at the peak of the
    math the kernel does (the bf16 tensor cores for sm90, float32 CUDA
    cores for simt), against each input read once and each output written
    once at the HBM rate; the larger of the two."""
    flop = 4 * b * h * sq * sk * d / (2 if causal else 1)
    nbytes = in_bytes * (b * sq * h * d + 2 * b * sk * hk * d)
    nbytes += 4 * (b * h * sq * d + 2 * b * h * sq) if stats else in_bytes * b * sq * h * d
    ops_ms, bytes_ms = flop / flop_per_s * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {
        "flop": flop, "bytes": nbytes, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
    }


def phase_flash_timing(torch, flash) -> dict:
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    b, s, h, hk, d = FLASH_TIMED
    # Two input sets of 96 MB each: every call reads memory that is not in L2.
    inputs = {n: [_qkv(torch, gen, dev, b, n, n, h, hk, d, torch.bfloat16) for _ in range(2)]
              for n in (s, FLASH_TIMED_SHORT)}
    # The same values in fp32, for SDPA beside the simt kernel's fp32 math.
    inputs32 = [[t.float() for t in qkv] for qkv in inputs[s]]
    before = _flash_counts(flash)

    def stats(causal, variant=None):
        return lambda q, k, v: flash.stats_kernel(q, k, v, causal, _variant=variant)

    def attention(causal, variant=None):
        return lambda q, k, v: flash.attention_kernel(q, k, v, causal, _variant=variant)

    sdpa = lambda causal: lambda q, k, v: _sdpa(torch, q, k, v, causal)  # noqa: E731
    # name: (tokens, causal, stats mode, variant, kernel, plain, library). The
    # simt rows time the kernel and SDPA on fp32 copies of its inputs (the
    # library call doing the kernel's fp32 math); plain is the sm90 row's.
    plan = {
        "flash_stats": (s, False, True, "sm90", stats(False),
                        lambda q, k, v: flash.stats_reference(q, k, v, False), sdpa(False)),
        "flash_stats_causal_diag": (
            s, True, True, "sm90", stats(True),
            lambda q, k, v: flash.stats_reference(q, k, v, True), sdpa(True)),
        "flash_causal": (s, True, False, "sm90", attention(True),
                         lambda q, k, v: flash.attention_reference(q, k, v, True), sdpa(True)),
        "flash_stats_4096": (
            FLASH_TIMED_SHORT, False, True, "sm90", stats(False),
            lambda q, k, v: flash.stats_reference(q, k, v, False), sdpa(False)),
        "flash_stats_simt": (s, False, True, "simt", stats(False, "simt"), None, sdpa(False)),
        "flash_stats_causal_diag_simt": (s, True, True, "simt", stats(True, "simt"), None,
                                         sdpa(True)),
        "flash_causal_simt": (s, True, False, "simt", attention(True, "simt"), None, sdpa(True)),
    }
    rows = {}
    for name, (n, causal, is_stats, variant, kernel, plain, library) in plan.items():
        fns = {"kernel": kernel, "library": library}
        order = ["kernel", "library", "library", "kernel"]
        if plain is not None:
            fns["plain"] = plain
            order = ["kernel", "plain", "library", "library", "plain", "kernel"]
        runs = {x: [] for x in fns}
        mode = flash.stats_kernel if is_stats else flash.attention_kernel
        launched = mode.launches_by_variant[variant]
        for x in order:  # in turns; each reports the better of its two runs
            fp32_library = x == "library" and variant == "simt"
            runs[x].append(_time_ms(torch, lambda qkv: fns[x](*qkv),
                                    inputs32 if fp32_library else inputs[n], iters=5))
        bound = flash_bound(b, n, n, h, hk, d, causal, 2, is_stats,
                            FP32_FLOP_PER_S if variant == "simt" else BF16_FLOP_PER_S)
        ms = min(runs["kernel"])
        twin = name[:-len("_simt")] if variant == "simt" else name
        rows[name] = {
            "shape": {"b": b, "sq": n, "sk": n, "h": h, "hk": hk, "d": d, "dtype": "bfloat16"},
            "causal": causal,
            "variant": variant,
            "ran_on_variant": mode.launches_by_variant[variant] > launched,
            "ms": ms,
            "plain_ms": min(runs["plain"]) if plain is not None else rows[twin]["plain_ms"],
            "library_ms": min(runs["library"]),
            "library": ("SDPA" + (" on fp32 copies of the inputs" if variant == "simt" else "")
                        + ", " + ("causal" if causal else "not causal")
                        + (", computes o, not (acc, m, l)" if is_stats else "")),
            "runs_ms": runs,
            **bound,
            "share_of_bound": bound["bound_ms"] / ms,
            "tflop_per_s": bound["flop"] / ms / 1e9,
        }
        torch.cuda.empty_cache()
    _reset_flash_counts(flash, before)
    ok = all(r["ran_on_variant"] for r in rows.values())
    return {"phase": "flash_timing", "ok": ok, "rows": rows,
            "peaks": {"bf16_flop_per_s": BF16_FLOP_PER_S, "fp32_flop_per_s": FP32_FLOP_PER_S,
                      "hbm_bytes_per_s": HBM_BYTES_PER_S}}


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _ring_path(torch, flash, dev, fwd_seq: int, bwd_seq: int, heads=None) -> dict:
    """Ring attention over a one-rank sp mesh (the caller holds the process
    group), then K3 through ``flash_attention``: a bf16 path, forward at
    ``fwd_seq`` and forward + backward at ``bwd_seq``, causal and not; then
    an fp32 path (a learner computing attention in fp32), forward and K3 at
    half ``bwd_seq``. Each path's per-variant launch counts are set to 0 just
    before it and read right after; the comparisons follow."""
    from torchstore_tpu_torch.ops import flash_attention, ring_attention_sharded
    from torchstore_tpu_torch.parallel import make_mesh

    h, hk, d = heads or (HEADS, KV_HEADS, HEAD_DIM)
    fp32_seq = bwd_seq // 2
    mesh = make_mesh({"sp": 1}, dev.type)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    bf16 = torch.bfloat16
    fwd = _qkv(torch, gen, dev, 1, fwd_seq, fwd_seq, h, hk, d, bf16)
    bwd = _qkv(torch, gen, dev, 1, bwd_seq, bwd_seq, h, hk, d, bf16)
    f32 = _qkv(torch, gen, dev, 1, fp32_seq, fp32_seq, h, hk, d, torch.float32)
    weight = torch.randn((1, bwd_seq, h, d), generator=gen, device=dev)

    def with_grads(fn, causal):
        leaves = [x.detach().clone().requires_grad_() for x in bwd]
        out = fn(*leaves, causal)
        (out.float() * weight).sum().backward()
        return out.detach(), [x.grad for x in leaves]

    ring = lambda impl: lambda q, k, v, causal: ring_attention_sharded(  # noqa: E731
        q, k, v, mesh, "sp", causal=causal, impl=impl)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    _reset_flash_counts(flash)
    t0 = time.perf_counter()
    path, steps_s = {}, {}
    for causal in (False, True):
        for step, fn in (("fwd", lambda: ring("auto")(*fwd, causal)),
                         ("bwd", lambda: with_grads(ring("auto"), causal)),
                         ("k3", lambda: flash_attention(*fwd, causal=causal))):
            t1 = time.perf_counter()
            path[(step, causal)] = fn()
            sync()
            steps_s[f"{step} {'causal' if causal else 'full'}"] = time.perf_counter() - t1
    path_s = time.perf_counter() - t0
    launches = _flash_counts(flash)

    _reset_flash_counts(flash)
    t0 = time.perf_counter()
    for causal in (False, True):
        path[("fp32", causal)] = ring("auto")(*f32, causal)
        path[("fp32_k3", causal)] = flash_attention(*f32, causal=causal)
    sync()
    fp32_path_s = time.perf_counter() - t0
    fp32_launches = _flash_counts(flash)
    _reset_flash_counts(flash)
    ring_calls, k3_calls = 4, 2  # each path's calls: bf16 on sm90, fp32 on simt
    expected = {"flash_stats": {"sm90": ring_calls, "simt": 0}, "flash": {"sm90": k3_calls, "simt": 0}}
    fp32_expected = {"flash_stats": {"sm90": 0, "simt": 2}, "flash": {"sm90": 0, "simt": 2}}

    def yardstick(label, got, want, inputs, causal):
        """``got`` against ``want`` with SDPA on the same inputs as the
        yardstick: got's worst error <= SDPA_YARDSTICK x SDPA's."""
        sdpa = _within(torch, _sdpa(torch, *inputs, causal), want, atol=1e-5, ulps=2)
        res = _within(torch, got, want, atol=1e-5, ulps=2)
        return {"check": label, "max_abs_err": res["max_abs_err"],
                "outside_2ulps": res["outside"], "sdpa_max_abs_err": sdpa["max_abs_err"],
                "outside": int(res["max_abs_err"] > SDPA_YARDSTICK * sdpa["max_abs_err"])}

    checks = []
    for causal in (False, True):
        tag = "causal" if causal else "full"
        got = path[("fwd", causal)]
        checks.append(yardstick(f"fwd {fwd_seq} {tag} vs einsum body", got,
                                ring("einsum")(*fwd, causal), fwd, causal))
        checks.append(yardstick(f"fwd {fwd_seq} {tag} vs plain", got,
                                flash.attention_reference(*fwd, causal), fwd, causal))
        same = bool(torch.equal(path[("k3", causal)], got))
        checks.append({"check": f"K3 {fwd_seq} {tag} vs ring (K2 + normalization)",
                       **_within(torch, path[("k3", causal)], got, atol=1e-5, ulps=2),
                       "bit_equal": same})
        checks[-1]["outside"] += int(not same)
        out, grads = path[("bwd", causal)]
        e_out, e_grads = with_grads(ring("einsum"), causal)
        checks.append(yardstick(f"fwd {bwd_seq} {tag} vs einsum body", out, e_out, bwd, causal))
        # The stats op's backward recomputes through stats_reference, but its
        # cotangents carry the forward's acc and l: D = rowsum(dO o) takes the
        # forward's bf16-p rounding, as in SDPA's own backward. So the grads
        # follow the SDPA yardstick too; the fixed-ulp rule is reported beside it.
        _, s_grads = with_grads(lambda q, k, v, c: _sdpa(torch, q, k, v, c), causal)
        for name, g, w, sg in zip("qkv", grads, e_grads, s_grads):
            scale = float(w.float().abs().max().item())
            res = _within(torch, g, w, atol=1e-5 * scale, ulps=2)
            sdpa_err = _within(torch, sg, w)["max_abs_err"]
            checks.append({"check": f"d{name} {bwd_seq} {tag} vs einsum body",
                           "max_abs_err": res["max_abs_err"], "outside_2ulps": res["outside"],
                           "sdpa_max_abs_err": sdpa_err,
                           "outside": int(res["max_abs_err"] > SDPA_YARDSTICK * sdpa_err)})
        del e_out, e_grads, s_grads
        got = path[("fp32", causal)]
        checks.append({"check": f"fp32 fwd {fp32_seq} {tag} vs einsum body",
                       **_within(torch, got, ring("einsum")(*f32, causal))})
        same = bool(torch.equal(path[("fp32_k3", causal)], got))
        checks.append({"check": f"fp32 K3 {fp32_seq} {tag} vs ring (K2 + normalization)",
                       **_within(torch, path[("fp32_k3", causal)], got), "bit_equal": same})
        checks[-1]["outside"] += int(not same)
    on_card = dev.type == "cuda"
    ok = all(c["outside"] == 0 for c in checks)
    if on_card:
        ok = ok and launches == expected and fp32_launches == fp32_expected
    return {
        "ok": ok,
        "launches": launches,
        "launches_expected": expected,
        "path_seconds": path_s,
        "steps_seconds": steps_s,
        "fp32_launches": fp32_launches,
        "fp32_launches_expected": fp32_expected,
        "fp32_path_seconds": fp32_path_s,
        "checks": checks,
        "tolerance": (
            "bf16 outputs and grads: worst error <= 2x SDPA's (is_causal, enable_gqa; its own "
            "backward for the grads) worst error against the same comparator on the same "
            "inputs (bf16 p before P.V; the backward's D = rowsum(dO o) takes the forward's "
            "rounding); 'outside_2ulps' counts values outside the fixed 1e-5 + 2 bf16 ulps "
            "(outputs) or 2 ulps + 1e-5 max|want| (grads); K3 bit-equal to the ring's K2 + "
            "normalization; fp32 outputs within 1e-5 + 1e-4 |want|"),
        "shapes": {"fwd": [1, fwd_seq, h, hk, d], "bwd": [1, bwd_seq, h, hk, d],
                   "fp32": [1, fp32_seq, h, hk, d], "dtype": "bfloat16 (fp32 path: float32)"},
    }


def phase_ring(torch, flash) -> dict:
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1, rank=0
    )
    try:
        res = _ring_path(torch, flash, dev, fwd_seq=8192, bwd_seq=4096)
    finally:
        dist.destroy_process_group()
    res["phase"] = "ring"
    return res


MODEL_LAYERS = 4  # Llama-3-8B width at 4 layers: 1.92 B params


async def _model_path(torch, staging, cfg, dev, seq: int = 2049, prompt_len: int = 16,
                      new_tokens: int = 32, batch: int = 2) -> dict:
    """The RL loop: a learner (fp32 params, bf16 compute) trains two AdamW
    steps on one batch of ``seq`` tokens and publishes with direct=True; a
    generator (bf16 params) pulls, then decodes greedily beside a decoder
    whose weights were cast locally."""
    import dataclasses

    import torchstore_tpu_torch as tst
    from torchstore_tpu_torch.models.generate import Decoder
    from torchstore_tpu_torch.models.llama import Llama, init_params
    from torchstore_tpu_torch.parallel import make_train_step

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    bf16 = torch.bfloat16
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    learner = init_params(cfg, gen, dev)
    n_params = sum(p.numel() for p in learner.parameters())
    opt = torch.optim.AdamW(learner.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8)
    step = make_train_step(learner, opt)
    tokens = torch.randint(0, cfg.vocab_size, (1, seq), generator=gen, device=dev)
    losses, step_s = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        loss = step(tokens)
        sync()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss.item()))

    state = {k: v.detach() for k, v in learner.state_dict().items()}
    gen_cfg = dataclasses.replace(cfg, param_dtype=bf16)
    generator = Llama(gen_cfg, dev)
    targets = generator.state_dict()
    chunks = len(staging.plan_chunks(list(state.values()), bf16))
    staging.cast_kernel.launches = 0
    await tst.initialize(store_name="rl")
    pids = [p.pid for p in multiprocessing.active_children()]
    try:
        t0 = time.perf_counter()
        await tst.put_state_dict("policy", state, transfer_dtype=bf16, direct=True,
                                 store_name="rl")
        sync()
        publish_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        await tst.get_state_dict("policy", targets, direct=True, store_name="rl")
        sync()
        pull_s = time.perf_counter() - t0
        rung = tst.direct_sync_stats("policy", store_name="rl")["rung"]
    finally:
        await tst.shutdown("rl")
    cast_launches = staging.cast_kernel.launches
    mismatched = [k for k, t in targets.items() if not torch.equal(t, state[k].to(bf16).to(t.dtype))]

    local = Llama(gen_cfg, dev)
    local.load_state_dict({k: v.to(bf16) for k, v in state.items()})
    dec = Decoder(gen_cfg, max_len=prompt_len + new_tokens, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen, device=dev)
    pulled_tokens = dec.generate(generator, prompt, new_tokens)
    local_tokens = dec.generate(local, prompt, new_tokens)
    # Prefill and per-token steps timed apart.
    sync()
    t0 = time.perf_counter()
    logits, cache = dec.prefill(generator, prompt)
    sync()
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(new_tokens - 1):
        logits, cache = dec.step(generator, cache, logits.argmax(-1, keepdim=True))
    sync()
    decode_s = time.perf_counter() - t0
    await asyncio.sleep(0.5)
    alive = [p for p in pids if p in {c.pid for c in multiprocessing.active_children()}]
    out = {
        "layers": cfg.num_layers,
        "params": n_params,
        "tensors": len(state),
        "losses": losses,
        "step_s": step_s,
        "train_tokens": seq - 1,
        "publish_s": publish_s,
        "pull_s": pull_s,
        "rung": rung,
        "cast_launches": cast_launches,
        "cast_chunks": chunks,
        "pulled_mismatched": mismatched[:5],
        "tokens_equal": bool(torch.equal(pulled_tokens, local_tokens)),
        "tokens_shape": list(pulled_tokens.shape),
        "prefill_tokens_per_s": batch * prompt_len / prefill_s,
        "decode_tokens_per_s": batch * (new_tokens - 1) / decode_s,
        "processes_left": alive,
    }
    if dev.type == "cuda":
        out["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["ok"] = (
        all(math.isfinite(x) for x in losses)
        and losses[1] < losses[0]
        and not mismatched
        and out["tokens_equal"]
        and not alive
        and (dev.type != "cuda" or cast_launches == chunks)
    )
    return out


def phase_model(torch, staging) -> dict:
    from torchstore_tpu_torch.workloads import llama3_8b_config

    emit({"reduced": {"model_layers": MODEL_LAYERS, "of": LAYERS}})
    cfg = llama3_8b_config(MODEL_LAYERS)
    res = asyncio.run(_model_path(torch, staging, cfg, torch.device("cuda", 0)))
    res["phase"] = "model"
    res["nvidia_smi"] = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    return res



RL_STEPS = 3
RL_TP = 8  # each generator lays its model out tensor-parallel over 8 ranks


async def _rl_path(torch, cfg, device: str, seq: int = 2049, prompt_len: int = 16,
                   new_tokens: int = 16) -> dict:
    """The RL example (``torchstore_tpu_torch.examples.torchstore_rl``): a
    learner process trains and publishes through the weight channel, two
    generator processes acquire, resharded tensor-parallel into their bf16
    models in place, and decode greedily."""
    from torchstore_tpu_torch.examples import torchstore_rl

    before = {p.pid for p in multiprocessing.active_children()}
    t0 = time.perf_counter()
    records = await torchstore_rl.main(
        cfg, device, steps=RL_STEPS, transfer_dtype=torch.bfloat16, tp=RL_TP, batch=1,
        seq=seq, prompt_len=prompt_len, new_tokens=new_tokens,
    )
    seconds = time.perf_counter() - t0
    await asyncio.sleep(0.5)
    alive = [p.pid for p in multiprocessing.active_children() if p.pid not in before]
    losses = [r["loss"] for r in records]
    steps = [{
        "version": r["version"], "loss": r["loss"], "train_s": r["train_s"],
        "publish_s": r["publish_s"], "acquire_s": [g["acquire_s"] for g in r["generators"]],
        "cast_launches": r["cast_launches"], "cast_chunks": r["cast_chunks"],
        "copies": [g["copies"] for g in r["generators"]],
        "tokens_equal": all(g["tokens"] == r["local_tokens"] for g in r["generators"]),
    } for r in records]
    last = records[-1]
    out = {
        "layers": cfg.num_layers, "steps": steps, "seconds": seconds,
        "tp": RL_TP, "targets_per_generator": last["generators"][0]["targets"],
        "tokens": last["local_tokens"][0],
        "peak_device_bytes": {"learner": last["peak_device_bytes"],
                              **{f"generator_{i}": g["peak_device_bytes"]
                                 for i, g in enumerate(last["generators"])}},
        "processes_left": alive,
    }
    out["ok"] = (
        all(math.isfinite(x) for x in losses)
        and all(b < a for a, b in zip(losses, losses[1:]))
        and [s["version"] for s in steps] == list(range(RL_STEPS))
        and all(s["tokens_equal"] for s in steps)
        and (device == "cpu" or all(s["cast_launches"] == s["cast_chunks"] > 0 for s in steps))
        and not alive
    )
    return out


def phase_rl(torch) -> dict:
    from torchstore_tpu_torch.workloads import llama3_8b_config

    emit({"reduced": {"rl_layers": MODEL_LAYERS, "of": LAYERS}})
    res = asyncio.run(_rl_path(torch, llama3_8b_config(MODEL_LAYERS), "cuda"))
    res["phase"] = "rl"
    res["nvidia_smi"] = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    return res



def phase_kernels(results: dict) -> dict:
    """One entry per ported kernel, and per (mode, variant) of the flash
    kernels. The cast's times are the timing phase's measured publish row
    (cast_group over the 291 tensors of the Llama-3-8B state dict), its
    launches those of the main phase's run (five casting steps). The flash
    kernels' are one call at FLASH_TIMED (flash_timing), their launches
    those of the ring phase's paths (bf16: sm90, fp32: simt)."""
    needed = ("parity", "timing", "main", "flash_parity", "flash_timing", "ring")
    missing = [p for p in needed if p not in results]
    if missing:
        print(f"chip_smoke: the kernels line needs the phases {missing}", file=sys.stderr)
        return {"phase": "kernels", "ok": False, "missing": missing}
    main = results["main"]
    parity = results["parity"]
    (publish,) = [r for r in results["timing"]["rows"] if r["shape"] == "publish"]
    steps = main["launches_by_step"]
    # K1's launches on each path that casts, each path's counts set to 0
    # just before it ran and read just after.
    by_path = {"main": main["launches"]}
    if "reshard" in results:
        by_path["reshard"] = sum(results["reshard"]["launches_by_step"].values())
    if "channel" in results:
        by_path["channel"] = results["channel"]["launches"]
    if "rl" in results:
        by_path["rl"] = sum(s["cast_launches"] for s in results["rl"]["steps"])
    if "direct_device" in results:
        by_path["direct_device"] = results["direct_device"]["launches"]
    entries = [{
        "name": "cast",
        "route": "cuda",
        "source": "torchstore_tpu_torch/csrc/cast.cu",
        "replaces": "torchstore_tpu/ops/staging.py:78",
        "launches": main["launches"],
        "launches_by_path": by_path,
        "max_abs_err": parity["max_abs_err"],
        "parity": "bit-equal" if parity["ok"] else "differs",
        "ms": publish["ms"],
        "plain_ms": publish["plain_ms"],
        "bound_ms": publish["bound_ms"],
        "bound_by": "bytes",
        "library_ms": publish["library_ms"],
        "library": "a Python loop of x.to(torch.bfloat16)",
        "per": f"one publish: cast_group over the {publish['tensors']} fp32 tensors of the "
               f"Llama-3-8B state dict; launches over the main phase's run, per step {steps}"
               + (f"; on reshard (8 FSDP ranks) {results['reshard']['launches_by_step']}"
                  if "reshard" in results else "")
               + ("; on channel: 5 barrier publishes and one streamed publish of a fragment "
                  "per module" if "channel" in results else "")
               + ("; on rl: the learner process's publishes" if "rl" in results else "")
               + ("; on direct_device: the device rung's register and refreshes, and leg (e)'s "
                  "host-rung register, per publish "
                  f"{results['direct_device']['launches_per_publish']}"
                  if "direct_device" in results else ""),
    }]
    fparity, ftiming, ring = results["flash_parity"], results["flash_timing"]["rows"], results["ring"]
    within = "within tolerance" if fparity["ok"] else "differs"
    b, s, h, hk, d = FLASH_TIMED
    per = f"one call, b={b} sq=sk={s} h={h} hk={hk} d={d} bf16"
    sources = {"sm90": "torchstore_tpu_torch/csrc/flash_attention_sm90.cu",
               "simt": "torchstore_tpu_torch/csrc/flash_attention.cu"}
    # launches: the sm90 kernel's on the ring phase's bf16 path, the simt
    # kernel's on its fp32 path.
    path_launches = {"sm90": ring["launches"], "simt": ring["fp32_launches"]}
    for variant in ("sm90", "simt"):
        suffix = "" if variant == "sm90" else "_simt"
        for name, row_key, err in (("flash_stats", "flash_stats", "stats"),
                                   ("flash", "flash_causal", "o")):
            row = ftiming[row_key + suffix]
            entries.append({
                "name": f"{name}_{variant}",
                "route": "cuda",
                "source": sources[variant],
                "replaces": "torchstore_tpu/ops/flash_attention.py:205",
                "launches": path_launches[variant][name][variant],
                "max_abs_err": fparity["worst"][f"{err}_{variant}"],
                "parity": within,
                "ms": row["ms"],
                "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"],
                "library": row["library"],
                "per": per + (", causal" if row["causal"] else ", not causal")
                + ("; launches from the fp32 ring path" if variant == "simt" else ""),
            })
    print(json.dumps({"kernels": entries}), flush=True)
    ok = (parity["ok"] and fparity["ok"] and ring["ok"] and all(e["launches"] for e in entries)
          and all(by_path.values()))
    return {"phase": "kernels", "ok": ok}


if __name__ == "__main__":
    sys.exit(main())
