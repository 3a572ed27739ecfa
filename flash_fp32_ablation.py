"""Where the sm90_fp32 flash kernel's time goes, by ablation, on the card.

Copies ``torchstore_tpu_torch`` into a scratch directory once per variant,
removes one piece of work from ``csrc/flash_attention_sm90_fp32.cu`` in each
copy (the results of a cut variant are wrong; only its time is read), builds
every copy at once, then times K2 non-causal and K3 causal in fp32 at
Llama-3-8B attention width (b=1, 8192 tokens, h=32, hk=8, d=128: the d = 128
instance) and at Gemma-7B's (h=hk=16, d=256: the d = 256 instance) in one
process per variant, the unchanged kernel first and last. From the
repository's root:

    python3 flash_fp32_ablation.py [--out DIR]

Variants: ``base``; ``no_q_split`` (raw q bits as both TF32 halves: no
per-tile split of q); ``no_transform`` (the producer warpgroup splits and
transposes nothing); ``s_one_pass`` (S as q_hi k_hi^T only);
``pv_one_pass`` (P.V as p_hi v_hi only). Each prints one JSON line with the
card's name and power limit. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL = Path("torchstore_tpu_torch/csrc/flash_attention_sm90_fp32.cu")

# name: (old, new) replacements in the kernel source.
CUTS = {
    "base": [],
    "no_q_split": [(
        """      split(lds(q_rows + (kk / 4) * (BQ * kRowBytes) + (r & 1) * 8 * kRowBytes +
                ((chunk ^ group) * 16) + quad * 4),
            hi[4 * j + r], lo[4 * j + r]);""",
        """      hi[4 * j + r] = __float_as_uint(lds(q_rows + (kk / 4) * (BQ * kRowBytes) +
                                          (r & 1) * 8 * kRowBytes +
                                          ((chunk ^ group) * 16) + quad * 4));
      lo[4 * j + r] = hi[4 * j + r];""")],
    "no_transform": [(f"void transform_{x}(uint32_t stage, int tid) {{\n",
                      f"void transform_{x}(uint32_t stage, int tid) {{\n  return;\n")
                     for x in "kv"],
    "s_one_pass": [
        ("""    wgmma_rs<N, off>(s_lo, lo + 4 * J, d_kh, K0 + J > 0);
    wgmma_rs<N, off>(s, hi + 4 * J, d_kh, K0 + J > 0);
    wgmma_rs<N, off>(s_lo, hi + 4 * J, d_kl);""",
         "    wgmma_rs<N, off>(s, hi + 4 * J, d_kh, K0 + J > 0);"),
        ("for (int i = 0; i < kBK / 2; ++i) s[i] += s_lo[i];", ""),
    ],
    "pv_one_pass": [("""      rs_steps<D, L::kVtBox, 0, kBK / 8>(o, pl, d_vth);
      rs_steps<D, L::kVtBox, 0, kBK / 8>(o, ph, d_vtl);
""", "")],
}

TIMER = """
import importlib, json, subprocess, sys
sys.path.insert(0, sys.argv[1])
import torch
fa = importlib.import_module("torchstore_tpu_torch.ops.flash_attention")
assert fa.__file__.startswith(sys.argv[1]), fa.__file__
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev)
gen.manual_seed(3)
widths = {"llama": (32, 8, 128), "gemma": (16, 16, 256)}

def ms(fn, sets, iters=5):
    for i in range(3):
        fn(*sets[i % 2])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*sets[i % 2])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters

smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip()
for width, (h, hk, d) in widths.items():
    shapes = ((1, 8192, h, d), (1, 8192, hk, d), (1, 8192, hk, d))
    sets = [[torch.randn(s, generator=gen, device=dev) for s in shapes] for _ in range(2)]
    assert fa.flash_variant(*sets[0]) == "sm90_fp32"
    k2 = min(ms(lambda q, k, v: fa.stats_kernel(q, k, v, False), sets) for _ in range(2))
    k3 = min(ms(lambda q, k, v: fa.attention_kernel(q, k, v, True), sets) for _ in range(2))
    print(json.dumps({"variant": sys.argv[2], "width": width, "d": d, "card": smi,
                      "k2_ms": k2, "k3_causal_ms": k3}), flush=True)
    del sets
"""


def copy_variant(out: Path, name: str) -> Path:
    root = out / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(ROOT / "torchstore_tpu_torch", root / "torchstore_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = (root / KERNEL).read_text()
    for old, new in CUTS[name]:
        if old not in src:
            raise SystemExit(f"{name}: the kernel no longer holds the text this cut removes")
        src = src.replace(old, new)
    (root / KERNEL).write_text(src)
    return root


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None, help="scratch directory (default: a temp dir)")
    args = parser.parse_args()
    out = Path(args.out or tempfile.mkdtemp(prefix="flash_fp32_ablation_"))
    roots = {name: copy_variant(out, name) for name in CUTS}
    build = ("import importlib, sys; sys.path.insert(0, sys.argv[1]); "
             "fa = importlib.import_module('torchstore_tpu_torch.ops.flash_attention'); "
             "fa._LIBS['sm90_fp32'].build()")
    procs = [subprocess.Popen([sys.executable, "-c", build, str(r)]) for r in roots.values()]
    if any([p.wait() for p in procs]):  # every build waited for
        return 1
    for name in [*CUTS, "base"]:
        rc = subprocess.run([sys.executable, "-c", TIMER, str(roots[name]), name]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
