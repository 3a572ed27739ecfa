"""Smoke run of torchstore_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, as a user would run it
    python3 chip_smoke.py --phases device,build,parity   # a subset

Phases, each printing one JSON line:

1. device       - the card, its power limit, /dev/shm and host memory;
2. build        - nvcc builds csrc/cast.cu and csrc/flash_attention.cu from
                  the checkout, both at once;
3. parity       - the cast kernel against its plain version on the card, bit
                  for bit outside NaN (NaN positions equal), for every
                  covered dtype pair at ragged sizes, Llama-3-8B shapes and
                  misaligned views;
4. timing       - the cast kernel at the shapes the main path casts, beside
                  its memory bound, the plain version and one library call;
5. main         - the weight-sync round trip at Llama-3-8B width through the
                  port's entry points: initialize, a buffered put/get, a
                  direct publish/pull, a refresh after an in-place update,
                  shutdown; the cast kernel's launch count on that path;
6. flash_parity - the flash kernel, stats mode (K2) and normalized mode (K3),
                  against their plain versions on the card: Llama-3-8B
                  attention width, MHA, d = 64 and 256, lengths 1024 to 8192
                  and ragged ones, fp32 and bf16, causal and not;
7. flash_timing - K2 and K3 at b=1, h=32, hk=8, d=128, bf16, 8192 tokens,
                  beside their bound, the plain versions and SDPA;
8. ring         - ring attention over a one-rank NCCL group ({"sp": 1}) at
                  Llama-3-8B attention width, forward at 8192 and forward
                  and backward at 4096, held against the einsum body and the
                  plain version; K2's launches on that path, and K3's from
                  the public ``flash_attention`` entry point;
9. model        - the RL loop at Llama-3-8B width (depth cut): a learner
                  trains two steps and publishes with direct=True, a bf16
                  generator pulls and decodes greedily;
10. kernels     - one line listing every ported kernel.

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

ALL_PHASES = (
    "device", "build", "parity", "timing", "main",
    "flash_parity", "flash_timing", "ring", "model", "kernels",
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
    from torchstore_tpu_torch.ops._nvcc import build_all

    libs = {"cast": staging.cast_kernel.lib, "flash": flash.stats_kernel.lib}
    t0 = time.perf_counter()
    build_all(list(libs.values()))
    out = {"phase": "build", "seconds": time.perf_counter() - t0}
    for name, lib in libs.items():
        ptxas = [
            line.strip()
            for line in lib.build_log.splitlines()
            if "registers" in line or "spill" in line or "Compiling entry" in line
        ]
        out[name] = {"seconds": lib.build_seconds, "ptxas": ptxas[:48]}
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
    return {"phase": "timing", "rows": rows, "hbm_bytes_per_s": HBM_BYTES_PER_S}


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
        elif phase == "flash_parity":
            res = phase_flash_parity(torch, flash)
        elif phase == "flash_timing":
            res = phase_flash_timing(torch, flash)
        elif phase == "ring":
            res = phase_ring(torch, flash)
        elif phase == "model":
            res = phase_model(torch, staging)
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


def _pairs(a, b):
    """Leaf pairs of two trees of the same structure."""
    if isinstance(a, dict):
        for k in a:
            yield from _pairs(a[k], b[k])
    else:
        yield a, b


def plan_layers() -> tuple[int, dict]:
    """Depth that fits host memory: the volume's copy and the direct
    staging copy (bf16 each) live in /dev/shm at once. Widths never change."""
    from torchstore_tpu_torch.workloads import LLAMA3_8B, llama_shapes

    geo = dict(LLAMA3_8B)
    per_layer = sum(math.prod(s) for s in _leaves(llama_shapes(**{**geo, "layers": 1})["layers"]))
    outer = sum(math.prod(s) for s in _leaves({**llama_shapes(**{**geo, "layers": 0}), "layers": {}}))
    budget = 0.8 * min(shm_free_bytes(), mem_available_bytes())
    copies_bytes = lambda n: 2 * 2 * (outer + n * per_layer)  # two bf16 copies
    layers = geo["layers"]
    while layers > 1 and copies_bytes(layers) > budget:
        layers -= 1
    return layers, {"budget_bytes": int(budget), "needed_bytes": copies_bytes(layers)}


async def _main_path(torch, staging, layers: int, dev, geometry=None) -> dict:
    import torchstore_tpu_torch as tst
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

    def zeros_like_tree(tree):
        if isinstance(tree, dict):
            return {k: zeros_like_tree(v) for k, v in tree.items()}
        return torch.zeros(tree.shape, dtype=bf16, device=dev)

    targets = zeros_like_tree(src)

    def check(label: str) -> dict:
        bad = [
            i for i, (t, s) in enumerate(_pairs(targets, src)) if not torch.equal(t, s.to(bf16))
        ]
        return {"check": label, "bit_equal": not bad, "mismatched_tensors": len(bad)}

    def clear_targets() -> None:
        for t in _leaves(targets):
            t.zero_()
        torch.cuda.synchronize()

    out: dict = {"layers": layers, "tensors": n_tensors, "params": n_params,
                 "wire_bytes": wire_bytes, "source_bytes": 4 * n_params}
    checks = []
    timings = {}
    staging.cast_kernel.launches = 0  # count the main path's launches only
    t0 = time.perf_counter()
    await tst.initialize()
    timings["initialize_s"] = time.perf_counter() - t0
    pids = [p.pid for p in multiprocessing.active_children()]  # volume + controller
    try:
        t0 = time.perf_counter()
        await tst.put_state_dict("policy", src, transfer_dtype=bf16)
        torch.cuda.synchronize()
        timings["put_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        await tst.get_state_dict("policy", targets)
        torch.cuda.synchronize()
        timings["get_s"] = time.perf_counter() - t0
        checks.append(check("buffered get"))
        launches_buffered = staging.cast_kernel.launches

        clear_targets()
        t0 = time.perf_counter()
        await tst.put_state_dict("policy_direct", src, transfer_dtype=bf16, direct=True)
        torch.cuda.synchronize()
        timings["publish_s"] = time.perf_counter() - t0
        launches_register = staging.cast_kernel.launches - launches_buffered
        t0 = time.perf_counter()
        await tst.get_state_dict("policy_direct", targets, direct=True)
        torch.cuda.synchronize()
        timings["pull_s"] = time.perf_counter() - t0
        checks.append(check("direct pull"))

        for t in _leaves(src):
            t.add_(1.0)  # the training step, in place
        clear_targets()
        t0 = time.perf_counter()
        await tst.put_state_dict("policy_direct", src, transfer_dtype=bf16, direct=True)
        torch.cuda.synchronize()
        timings["republish_s"] = time.perf_counter() - t0
        launches_refresh = staging.cast_kernel.launches - launches_buffered - launches_register
        t0 = time.perf_counter()
        await tst.get_state_dict("policy_direct", targets, direct=True)
        torch.cuda.synchronize()
        timings["repull_s"] = time.perf_counter() - t0
        checks.append(check("direct pull after refresh"))
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
    out.update(
        {
            "checks": checks,
            "launches": launches,
            "launches_by_step": {
                "buffered": launches_buffered,
                "register": launches_register,
                "refresh": launches_refresh,
            },
            "launches_needed": 2 * n_tensors,
            "timings": timings,
            "gb_per_s": {
                step: wire_bytes / timings[f"{step}_s"] / 1e9
                for step in ("put", "get", "publish", "pull", "republish", "repull")
            },
            "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
            "processes_left": alive,
            "segments_left": leaked[:5],
        }
    )
    out["ok"] = (
        all(c["bit_equal"] for c in checks)
        and launches_register >= n_tensors
        and launches_refresh >= n_tensors
        and launches >= 2 * n_tensors
        and not alive
        and not leaked
    )
    return out


def phase_main(torch, staging) -> dict:
    layers, sizing = plan_layers()
    if layers < LAYERS:
        emit({"reduced": {"layers": layers}, **sizing})
    res = asyncio.run(_main_path(torch, staging, layers, torch.device("cuda", 0)))
    res["phase"] = "main"
    res["sizing"] = sizing
    return res


# --------------------------------------------------------------------------
# attention: the flash kernel, ring attention, the model
# --------------------------------------------------------------------------

# (label, b, sq, sk, h, hk, d); "8b" is Llama-3-8B attention width.
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
)
FLASH_TOL = {
    "stats": "m, l: |got - want| <= 1e-5 + 1e-4 |want|; acc the same after dividing "
             "got and want by want's l (fp32 and bf16 inputs)",
    "o_fp32": "|got - want| <= 1e-5 + 1e-4 |want|",
    "o_bf16": "|got - want| <= 1e-5 + 2 bf16 ulps of want",
}
# The timed shapes: b, s, h, hk, d (bf16).
FLASH_TIMED = (1, 8192, HEADS, KV_HEADS, HEAD_DIM)


def _bf16_ulp(torch, x):
    """One bf16 ulp of each value of ``x`` (8 significant bits)."""
    _, exp = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), exp - 8)


def _within(torch, got, want, rtol=1e-4, atol=1e-5, ulps=None) -> dict:
    """Worst error of ``got`` against ``want`` and the count of values
    outside the tolerance: atol + rtol |want|, or ``ulps`` bf16 ulps (plus
    ``atol``)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if ulps is None:
        allowed = atol + rtol * want.abs()
    else:
        allowed = atol + ulps * _bf16_ulp(torch, want)
    bad = int((err > allowed).sum().item()) + int((~torch.isfinite(got)).sum().item())
    return {"max_abs_err": float(err.max().item()) if err.numel() else 0.0, "outside": bad}


def _qkv(torch, gen, dev, b, sq, sk, h, hk, d, dtype):
    q = torch.randn((b, sq, h, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, sk, hk, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, sk, hk, d), generator=gen, device=dev).to(dtype)
    return q, k, v


def phase_flash_parity(torch, flash) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    cases, worst = [], {"stats": 0.0, "o": 0.0}
    for label, b, sq, sk, h, hk, d in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _qkv(torch, gen, dev, b, sq, sk, h, hk, d, dtype)
            for causal in (False, True):
                got = flash.stats_kernel(q, k, v, causal)
                want = flash.stats_reference(q, k, v, causal)
                torch.cuda.synchronize()
                # acc is a sum of sk terms whose magnitudes add up to ~l E|v|, so
                # it is held on the scale of o = acc / l (want's l for both).
                l_want = want[2][..., None]
                res = {"acc": _within(torch, got[0] / l_want, want[0] / l_want)}
                res["acc"]["raw_max_abs_err"] = float((got[0] - want[0]).abs().max().item())
                res.update({n: _within(torch, g, w) for n, g, w in zip("ml", got[1:], want[1:])})
                del got, want, l_want
                o = flash.attention_kernel(q, k, v, causal)
                o_want = flash.attention_reference(q, k, v, causal)
                torch.cuda.synchronize()
                if dtype == torch.bfloat16:
                    res["o"] = _within(torch, o, o_want, atol=1e-5, ulps=2)
                else:
                    res["o"] = _within(torch, o, o_want)
                del o, o_want
                ok = all(r["outside"] == 0 for r in res.values())
                worst["stats"] = max(worst["stats"], *(res[n]["max_abs_err"] for n in ("m", "l")),
                                     res["acc"]["raw_max_abs_err"])
                worst["o"] = max(worst["o"], res["o"]["max_abs_err"])
                cases.append({
                    "case": f"{label} {str(dtype)[6:]} {'causal' if causal else 'full'}",
                    "ok": ok, **res,
                })
            del q, k, v
            torch.cuda.empty_cache()
    flash.stats_kernel.launches = 0  # comparison launches are not path launches
    flash.attention_kernel.launches = 0
    failed = [c for c in cases if not c["ok"]]
    return {
        "phase": "flash_parity",
        "ok": not failed,
        "cases": len(cases),
        "failed": failed[:10],
        "worst": worst,
        "tolerance": FLASH_TOL,
        "rows": [{"case": c["case"], "acc": c["acc"]["max_abs_err"], "o": c["o"]["max_abs_err"]}
                 for c in cases],
    }


def flash_bound(b, sq, sk, h, hk, d, causal, in_bytes, stats) -> dict:
    """Least time for one call: 4 b h sq sk d operations (halved when
    causal, as benchmarks/flash_kernel_bench.py counts) at the bf16
    tensor-core peak, against each input read once and each output written
    once at the HBM rate; the larger of the two."""
    flop = 4 * b * h * sq * sk * d / (2 if causal else 1)
    nbytes = in_bytes * (b * sq * h * d + 2 * b * sk * hk * d)
    nbytes += 4 * (b * h * sq * d + 2 * b * h * sq) if stats else in_bytes * b * sq * h * d
    ops_ms, bytes_ms = flop / BF16_FLOP_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {
        "flop": flop, "bytes": nbytes, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
    }


def phase_flash_timing(torch, flash) -> dict:
    import torch.nn.functional as F

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    b, s, h, hk, d = FLASH_TIMED
    # Two input sets of 96 MB each: every call reads memory that is not in L2.
    inputs = [_qkv(torch, gen, dev, b, s, s, h, hk, d, torch.bfloat16) for _ in range(2)]
    before = (flash.stats_kernel.launches, flash.attention_kernel.launches)

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
            enable_gqa=True,
        )

    plan = {
        "flash_stats": (False, True, lambda q, k, v: flash.stats_kernel(q, k, v, False),
                        lambda q, k, v: flash.stats_reference(q, k, v, False), None),
        "flash_stats_causal_diag": (
            True, True, lambda q, k, v: flash.stats_kernel(q, k, v, True),
            lambda q, k, v: flash.stats_reference(q, k, v, True), None),
        "flash_causal": (True, False, lambda q, k, v: flash.attention_kernel(q, k, v, True),
                         lambda q, k, v: flash.attention_reference(q, k, v, True), sdpa),
    }
    rows = {}
    for name, (causal, stats, kernel, plain, library) in plan.items():
        fns = {"kernel": kernel, "plain": plain}
        order = ["kernel", "plain", "plain", "kernel"]
        if library is not None:
            fns["library"] = library
            order = ["kernel", "plain", "library", "library", "plain", "kernel"]
        runs = {n: [] for n in fns}
        for n in order:  # in turns; each reports the better of its two runs
            runs[n].append(_time_ms(torch, lambda qkv: fns[n](*qkv), inputs, iters=5))
        bound = flash_bound(b, s, s, h, hk, d, causal, 2, stats)
        ms = min(runs["kernel"])
        rows[name] = {
            "shape": {"b": b, "sq": s, "sk": s, "h": h, "hk": hk, "d": d, "dtype": "bfloat16"},
            "causal": causal,
            "ms": ms,
            "plain_ms": min(runs["plain"]),
            "library_ms": min(runs["library"]) if library is not None else None,
            "runs_ms": runs,
            **bound,
            "share_of_bound": bound["bound_ms"] / ms,
            "tflop_per_s": bound["flop"] / ms / 1e9,
        }
        torch.cuda.empty_cache()
    flash.stats_kernel.launches, flash.attention_kernel.launches = before
    return {"phase": "flash_timing", "rows": rows,
            "peaks": {"bf16_flop_per_s": BF16_FLOP_PER_S, "hbm_bytes_per_s": HBM_BYTES_PER_S}}


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _ring_path(torch, flash, dev, fwd_seq: int, bwd_seq: int, heads=None) -> dict:
    """Ring attention over a one-rank sp mesh (the caller holds the process
    group), then K3 through ``flash_attention``: forward at ``fwd_seq`` and
    forward + backward at ``bwd_seq``, causal and not. The launch counts are
    read right after the path; the comparisons follow."""
    from torchstore_tpu_torch.ops import flash_attention, ring_attention_sharded
    from torchstore_tpu_torch.parallel import make_mesh

    h, hk, d = heads or (HEADS, KV_HEADS, HEAD_DIM)
    mesh = make_mesh({"sp": 1}, dev.type)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    bf16 = torch.bfloat16
    fwd = _qkv(torch, gen, dev, 1, fwd_seq, fwd_seq, h, hk, d, bf16)
    bwd = _qkv(torch, gen, dev, 1, bwd_seq, bwd_seq, h, hk, d, bf16)
    weight = torch.randn((1, bwd_seq, h, d), generator=gen, device=dev)

    def with_grads(fn, causal):
        leaves = [x.detach().clone().requires_grad_() for x in bwd]
        out = fn(*leaves, causal)
        (out.float() * weight).sum().backward()
        return out.detach(), [x.grad for x in leaves]

    ring = lambda impl: lambda q, k, v, causal: ring_attention_sharded(  # noqa: E731
        q, k, v, mesh, "sp", causal=causal, impl=impl)

    flash.stats_kernel.launches = 0
    flash.attention_kernel.launches = 0
    t0 = time.perf_counter()
    path = {}
    for causal in (False, True):
        path[("fwd", causal)] = ring("auto")(*fwd, causal)
        path[("bwd", causal)] = with_grads(ring("auto"), causal)
        path[("k3", causal)] = flash_attention(*fwd, causal=causal)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    path_s = time.perf_counter() - t0
    launches = {"flash_stats": flash.stats_kernel.launches,
                "flash": flash.attention_kernel.launches}
    ring_calls, k3_calls = 4, 2

    checks = []
    for causal in (False, True):
        tag = "causal" if causal else "full"
        got = path[("fwd", causal)]
        checks.append({"check": f"fwd {fwd_seq} {tag} vs einsum body",
                       **_within(torch, got, ring("einsum")(*fwd, causal), atol=1e-5, ulps=2)})
        checks.append({"check": f"fwd {fwd_seq} {tag} vs plain",
                       **_within(torch, got, flash.attention_reference(*fwd, causal),
                                 atol=1e-5, ulps=2)})
        checks.append({"check": f"K3 {fwd_seq} {tag} vs ring (K2 + normalization)",
                       **_within(torch, path[("k3", causal)], got, atol=1e-5, ulps=2),
                       "bit_equal": bool(torch.equal(path[("k3", causal)], got))})
        out, grads = path[("bwd", causal)]
        e_out, e_grads = with_grads(ring("einsum"), causal)
        checks.append({"check": f"fwd {bwd_seq} {tag} vs einsum body",
                       **_within(torch, out, e_out, atol=1e-5, ulps=2)})
        for name, g, w in zip("qkv", grads, e_grads):
            scale = float(w.float().abs().max().item())
            checks.append({"check": f"d{name} {bwd_seq} {tag} vs einsum body",
                           **_within(torch, g, w, atol=1e-5 * scale, ulps=2)})
        del e_out, e_grads
    on_card = dev.type == "cuda"
    ok = all(c["outside"] == 0 for c in checks)
    if on_card:
        ok = ok and launches == {"flash_stats": ring_calls, "flash": k3_calls}
    return {
        "ok": ok,
        "launches": launches,
        "launches_expected": {"flash_stats": ring_calls, "flash": k3_calls},
        "path_seconds": path_s,
        "checks": checks,
        "tolerance": "outputs within 1e-5 + 2 bf16 ulps; grads within 2 bf16 ulps + 1e-5 max|want|",
        "shapes": {"fwd": [1, fwd_seq, h, hk, d], "bwd": [1, bwd_seq, h, hk, d], "dtype": "bfloat16"},
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
        "cast_launches": cast_launches,
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
        and (dev.type != "cuda" or cast_launches == len(state))
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



def phase_kernels(results: dict) -> dict:
    """One entry per ported kernel. The cast's times are for one publish of
    the main phase's state dict: the per-shape times of the timing phase,
    weighted by how many tensors of each shape the path casts. The flash
    kernel's are one call at FLASH_TIMED (flash_timing), its launches those
    of the ring phase's path."""
    needed = ("parity", "timing", "main", "flash_parity", "flash_timing", "ring")
    missing = [p for p in needed if p not in results]
    if missing:
        print(f"chip_smoke: the kernels line needs the phases {missing}", file=sys.stderr)
        return {"phase": "kernels", "ok": False, "missing": missing}
    timing = results["timing"]["rows"]
    main = results["main"]
    parity = results["parity"]
    layers = main.get("layers", LAYERS)
    counts = {
        "embed/lm_head": 2,
        "gate/up": 2 * layers,
        "down": layers,
        "q/o": 2 * layers,
        "k/v": 2 * layers,
        "norm": 2 * layers + 1,
    }
    rows = {r["shape"]: r for r in timing if r["pair"] == "float32->bfloat16"}
    total = {}
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        total[key] = (
            sum(rows[s][key] * c for s, c in counts.items()) if set(counts) <= set(rows) else None
        )
    entries = [{
        "name": "cast",
        "route": "cuda",
        "source": "torchstore_tpu_torch/csrc/cast.cu",
        "replaces": "torchstore_tpu/ops/staging.py:78",
        "launches": main.get("launches"),
        "max_abs_err": parity["max_abs_err"],
        "parity": "bit-equal" if parity["ok"] else "differs",
        "ms": total["ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": "bytes",
        "library_ms": total["library_ms"],
        "per": f"one publish: fp32->bf16 of all {sum(counts.values())} tensors",
    }]
    fparity, ftiming, ring = results["flash_parity"], results["flash_timing"]["rows"], results["ring"]
    within = "within tolerance" if fparity["ok"] else "differs"
    b, s, h, hk, d = FLASH_TIMED
    per = f"one call, b={b} sq=sk={s} h={h} hk={hk} d={d} bf16"
    for name, row_key, launches, err in (
        ("flash_stats", "flash_stats", ring["launches"]["flash_stats"], fparity["worst"]["stats"]),
        ("flash", "flash_causal", ring["launches"]["flash"], fparity["worst"]["o"]),
    ):
        row = ftiming[row_key]
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "torchstore_tpu_torch/csrc/flash_attention.cu",
            "replaces": "torchstore_tpu/ops/flash_attention.py:205",
            "launches": launches,
            "max_abs_err": err,
            "parity": within,
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "per": per + (", causal" if row["causal"] else ", not causal"),
        })
    print(json.dumps({"kernels": entries}), flush=True)
    ok = parity["ok"] and main["launches"] is not None and fparity["ok"] and ring["ok"]
    return {"phase": "kernels", "ok": ok}


if __name__ == "__main__":
    sys.exit(main())
