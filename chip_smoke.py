"""Smoke run of torchstore_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, as a user would run it
    python3 chip_smoke.py --phases device,build,parity   # a subset

Phases, each printing one JSON line:

1. device  - the card, its power limit, /dev/shm and host memory;
2. build   - nvcc builds csrc/cast.cu from the checkout;
3. parity  - the cast kernel against its plain version on the card, bit for
             bit outside NaN (NaN positions equal), for every covered dtype
             pair at ragged sizes, Llama-3-8B shapes and misaligned views;
4. timing  - the cast kernel at the shapes the main path casts, beside its
             memory bound, the plain version and one library call;
5. main    - the weight-sync round trip at Llama-3-8B width through the
             port's entry points: initialize, a buffered put/get, a direct
             publish/pull, a refresh after an in-place update, shutdown; the
             kernel's launch count on that path;
6. kernels - one line listing every ported kernel.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device,
or without the package beside this file, it exits non-zero and prints no
result. Every phase that fails ends the run with a non-zero exit code.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import math
import multiprocessing
import os
import subprocess
import sys
import time

ALL_PHASES = ("device", "build", "parity", "timing", "main", "kernels")

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
# H100 SXM peak HBM rate (NVIDIA data sheet); the bound of a memory-bound op.
HBM_BYTES_PER_S = 3.35e12
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


def phase_build(staging) -> dict:
    staging.cast_kernel.build()
    ptxas = [
        line
        for line in staging.cast_kernel.build_log.splitlines()
        if "registers" in line or "spill" in line
    ]
    return {
        "phase": "build",
        "seconds": staging.cast_kernel.build_seconds,
        "ptxas": ptxas[:16],
    }


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

    results = {}
    for phase in phases:
        t0 = time.perf_counter()
        if phase == "device":
            res = phase_device(torch)
        elif phase == "build":
            res = phase_build(staging)
        elif phase == "parity":
            res = phase_parity(torch, staging)
        elif phase == "timing":
            res = phase_timing(torch, staging)
        elif phase == "main":
            res = phase_main(torch, staging)
        else:
            res = phase_kernels(results)
        res["seconds"] = time.perf_counter() - t0
        emit(res)
        results[phase] = res
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


def phase_kernels(results: dict) -> dict:
    """One entry per ported kernel. Times are for one publish of this run's
    state dict: the per-shape times of the timing phase, weighted by how
    many tensors of each shape the path casts."""
    missing = [p for p in ("parity", "timing", "main") if p not in results]
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
    entry = {
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
    }
    print(json.dumps({"kernels": [entry]}), flush=True)
    return {"phase": "kernels", "ok": parity["ok"] and main["launches"] is not None}


if __name__ == "__main__":
    sys.exit(main())
