"""Smoke run of torchstore_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, as a user would run it
    python3 chip_smoke.py --phases device,build,parity   # a subset

Phases, each printing one JSON line. Widths are always full; so the whole
run stays well inside its 1200 s limit on a slow machine, reshard, quant,
channel, tiering, runtime (legs b and d), bulk, healing (legs a-e) and
spmd run at 6 of the 32 layers (``TIME_CAP_LAYERS``, each listed under
``reduced``), where earlier slices ran them at 12 or at full depth; main
and direct_device keep full depth:

1. device       - the card, its power limit, /dev/shm and host memory;
2. build        - nvcc builds csrc/cast.cu, csrc/flash_attention.cu (the
                  simt flash kernel), csrc/flash_attention_sm90.cu (the
                  Hopper flash kernel) and csrc/flash_attention_sm90_fp32.cu
                  (its fp32 twin on the TF32 tensor cores, 3xTF32) from the
                  checkout, all at once, and prints each library's ptxas
                  registers and spills, and each tensor-core instance's
                  (sm90: bf16 and fp16, d 64, 128 and 256; sm90_fp32: d 64,
                  128 and 256; both modes); fails if an instance spills, one
                  is missing, ptxas ignored a setmaxnreg, or it serialized
                  an sm90_fp32 instance's wgmmas (C7512);
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
                  port's entry points, on the default config (the
                  automatic prewarm hint off unless
                  TORCHSTORE_TORCH_PREWARM_AUTO=1 turns it on; its state
                  is printed): initialize, a buffered put/get, a
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
5a. provision   - cold-start provisioning (after main, whose tmpfs is free
                  then): on a fresh store with prewarm_auto off, at full
                  depth, (a) tst.prewarm of the 291 fp32 tensors on the card
                  with transfer_dtype=bf16 (ok, no error, the provisioned
                  bytes the put's 16.06 GB bf16 or the clamp reported, the
                  twin set as large; its seconds, the page-locking's apart),
                  (b) the first put_state_dict in bf16 (no segment created
                  by the volume, no miss, no cold segment, K1 launches = the
                  planner's chunks; its GB/s beside main's first put), (c)
                  the first get into bf16 targets on the card, bit-equal to
                  the cast source, then after the training step's gap a
                  reput of the updated source on the twins (no segment
                  created, no miss, no cold segment, K1 = chunks) and its
                  get bit-equal; prewarm + put + reput beside main's put +
                  reput; at TIME_CAP_LAYERS, (d) WeightPublisher.register
                  then the first publish with no cold segment, acquired
                  bit-equal, (e) on a store with the automatic hint on the
                  first put fires one automatic prewarm and a second put of
                  the same signature none and makes no cold segment; no
                  segment or process is left;
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
                  attention width, MHA, d = 8, 40, 64, 72, 96, 136, 200 and
                  256, lengths 1 to 8192 and ragged ones, batch up to 4,
                  packed qkv projection views, q, k, v cut from rows of
                  d + 2 (strides TMA refuses), fp32 and bf16, causal and
                  not, and fp16 on d 64, 72, 96, 136 and 256, a ragged case,
                  the packed views and a case TMA refuses. Each case names
                  the variant ``flash_variant`` picked (bf16 and fp16 on
                  sm90, fp32 on sm90_fp32, at every head dim: d 64, 128 and
                  256 on their own instances, others zero-padded to the
                  next; the cases TMA refuses on simt); the sm90 cases are
                  held against the blockwise plain version at the k-tile of
                  the instance they run on and against the fp32 one with
                  SDPA's error as the yardstick, the sm90_fp32 and simt
                  cases against the fp32 plain version (sm90_fp32's error
                  against its 3xTF32 twin printed beside it); on a few fp32
                  cases at d = 128 and 256
                  the errors of sm90_fp32, simt (forced) and the fp32 plain
                  version against attention computed in fp64, printed and
                  not gated;
10. flash_timing - K2 and K3 at b=1, h=32, hk=8, d=128, bf16, 8192 tokens
                  (and K2 at 4096, and K2 in fp16) on the sm90 kernel, and
                  the same calls in fp32 on the sm90_fp32 kernel and on the
                  simt kernel forced, beside their bound (the bf16
                  tensor-core rate for sm90, three passes at the TF32 rate
                  for sm90_fp32, the fp32 CUDA-core rate for simt), the
                  plain versions and SDPA on the same inputs; then at Gemma-7B
                  attention width (h=16, hk=16, d=256, 8192 tokens) K2, K2
                  causal-diagonal and K3 causal in bf16 on the sm90 kernel,
                  and in fp32 on the sm90_fp32 kernel and on the simt kernel
                  forced (the route fp32 at d = 256 took before), each beside
                  its bound, the plain version and SDPA on the same inputs;
                  then at Phi-3-mini attention width (h=hk=32, d=96, 2048
                  tokens) K2 and K3 causal on the d = 128 instances
                  zero-padded, in bf16 on sm90 and in fp32 on sm90_fp32,
                  each beside the simt kernel forced on the same inputs
                  (the route before padding); and K2 and K3 causal on the
                  simt kernel where the rules send calls to it (the same
                  width in bf16, q, k, v cut from rows of d + 2);
11. ring         - ring attention over a one-rank NCCL group ({"sp": 1}) at
                  Llama-3-8B attention width and again at Gemma-7B's: a bf16
                  path (forward at 8192, forward and backward at 4096) and
                  an fp32 forward path at 2048, held against the einsum body
                  and the plain version; K2's and K3's launches per variant
                  on each path (bf16: sm90 only, at both widths; fp32:
                  sm90_fp32 only, at both widths); then the same paths at
                  Phi-3-mini's attention width (h=hk=32, d=96, zero-padded
                  on the d = 128 instances; bf16 at 2048 tokens, fp32 at
                  1024), and its forward once more in fp16 (sm90 only);
                  then the simt path: the same width with q, k, v cut from
                  rows of d + 2 (strides TMA refuses), bf16 at 2048 and
                  fp32 at 1024, through ring attention's per-rank body and
                  flash_attention (simt only);
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
15. tiering     - version retention and the disk tier at Llama-3-8B
                  width, 6 layers (the port Llama's tensors, fp32 on the card,
                  bf16 on the wire, bf16 targets on the card), after a
                  printed plan (free /dev/shm, card memory, and the free
                  disk and filesystem type, from /proc/mounts, of the tier
                  and storage directories, placed on a disk filesystem when
                  the machine has one; depth cut only as the plan forces,
                  under ``reduced``); a store with the spill tier on, no
                  background sweeper, a budget of two versions' bytes and
                  a 1 GiB segment pool: (a) WeightPublisher(keep=2)
                  publishes v0..v3, each after a seeded in-place step,
                  cohort "eval" leasing v0 before v1: GC reaps v1 and
                  keeps v0, v2, v3; a raw delete_prefix of v0 leaves its
                  keys and counts them blocked; (b) tier_sweep spills v2
                  (the coldest unpinned version) and leaves v0 and v3
                  resident, s and GB/s of the spill; (c) acquire(version=0)
                  into the targets with no fault-in; (d) acquire(version=2)
                  faults v2 in from disk (s, GB/s, ts_fault_ins_total),
                  then again warm; (e) the lease released, v4 published:
                  GC reaps v0 (and v2), and acquire(version=0) raises
                  KeyError; (f) a durable store (initialize(storage_dir=))
                  takes a put, stops without the teardown, and
                  initialize(recover=True) serves it again
                  (rebuild_index's count and s, the first get's GB/s).
                  Gates: every target bit-equal to the bf16 cast of the
                  regenerated source at its version, K1 launches per
                  publish and put = the planner's chunks with no cast
                  outside the kernel, no segment, process, tier or
                  storage file left, and ts_quarantines_total 0 in every
                  store (the supervisor at its defaults: the spill and
                  durable writes run off the volume's event loop);
16. healing     - replication, repair and the health supervisor at full
                  Llama-3-8B width (the port Llama's tensors, fp32 on the
                  card, bf16 on the wire, bf16 targets on the card), at
                  the depth a printed plan of host and card memory allows,
                  at most TIME_CAP_LAYERS:
                  3 volumes at replication 2, 1 GiB segment pools, the
                  supervisor at 0.5 s and 3 misses: (a) put_state_dict,
                  K1 launches = the planner's chunks, every key on exactly
                  2 volumes; (b) a get; (c) SIGKILL of the volume holding
                  the most bytes, then a get (its seconds and the
                  diagnosis it met) and another, which asks no diagnosis;
                  (d) the supervisor's quarantine (seconds from the kill,
                  volume_health) and auto-repair back to 2 healthy copies
                  of every key (bytes, seconds, GB/s, the rung pull_from
                  took: bulk), no other volume quarantined; (e) repair():
                  the victim replaced, nothing lost or failed, its keys
                  copied back, a get after it, none of the dead process's
                  segments left in /dev/shm; (f) at 2 layers, a SIGSTOPped
                  volume: check_volumes reads wedged, repair() lists it and
                  replaces nothing, and after SIGCONT a get; (g) at 2
                  layers, replication 1: the killed volume's keys raise
                  ActorDiedError carrying the controller's diagnosis
                  (dead), and repair() reports them lost; (h) at 4 layers,
                  a fresh store of 3 volumes at replication 2 and a
                  trainer that re-puts from the card every 2.5 s with a
                  new fill each round, from before a SIGKILL of volume 0
                  until auto-repair reports done, its pull held open by an
                  8 s volume.get delay on the surviving source: no error
                  reaches the trainer, one quarantine, the pull ran, and
                  once the loop stopped and the healthy volumes' reclaims
                  drained every healthy copy of every key, read through a
                  reader pinned to its volume, is bit-equal to the last
                  put (skipped_moved, the pull's seconds and the re-puts
                  made during it printed). Gates: every target bit-equal
                  to the bf16 cast of its source, no cast outside K1, no
                  process and no segment left;
17. runtime     - the runtime's foundations, in four legs: (a) start-up:
                  initialize + shutdown twice under the forkserver (the
                  default) and twice under TORCHSTORE_TORCH_MP_CONTEXT=spawn,
                  seconds each, and a forked actor child that allocates on
                  the card and casts with K1, bit-equal to this process's
                  cast; (b) a colocated store (initialize(colocated=True),
                  with an auth secret) at Llama-3-8B width: put, get, reput,
                  reget, reput2, reget2 of the 291 fp32 tensors on the card
                  into bf16 targets on the card, GB/s per step; gates: every
                  target bit-equal, K1 launches per casting step = planned
                  chunks, no fallback, no connection of the client's pool to
                  its own volume, a CPU tensor, a dict and a CUDA tensor put
                  and then changed read back unchanged, a raw connection
                  without the MAC closed by the volume's and the controller's
                  servers, no segment or process left; then 2000 put+get of a
                  4 KiB CPU tensor, p50 / p99 us per op, colocated and against
                  a spawned volume; (c) faults on a spawned volume (2 of 32
                  layers: the demoted put moves the bytes in RPC frames; the
                  store's bulk rung off, so the ladder is shm -> rpc): a
                  put whose first landing raises lands on the rpc rung, a get
                  whose first fetch raises is retried once, a notify delayed
                  200 ms; gates: bit-equal, put_retries{transport=rpc},
                  fetch_retries and failovers{op=put}, {op=get} 1 each, the
                  delayed put >= 0.2 s, nothing armed after; (d) this script
                  started again as a user's process with
                  TORCHSTORE_TORCH_TRACE set: a spawned volume's put / get /
                  reput / reget / reput2 / reget2 at main's depth, then the
                  device rung in process (register, pull, republish,
                  repull); after shutdown the merged trace: each put_batch's
                  trace id in the controller's and the volume's rpc spans,
                  each get_batch's in the volume's, every rpc span of those
                  traces parented by a client span; printed: span counts and
                  total ms per warm step, and the repull's open / land /
                  generation split;
18. bulk        - a cross-host store on one box over the bulk TCP rung, at
                  the depth a printed plan of card and host memory allows:
                  one volume spawned with a TORCHSTORE_TORCH_HOSTNAME of its
                  own (``initialize(volume_env_fn=...)``), every listener on
                  127.0.0.2, auth on; put, get, reput, reget, reput2, reget2
                  of the Llama-3-8B state dict (fp32 on the card) into the
                  same bf16 targets on the card; per step s, GB/s, rung,
                  dials (main + stripe), striped payloads and the split of
                  the card path (receive vs waits for the copies to the
                  card on gets, waits for the copies from the card vs send
                  on puts); gates: the ladder picks bulk unforced for the
                  other host and every step is on it, every target
                  bit-equal to its source's bf16 cast, K1 launches per put =
                  the planner's chunks with no fallback, the warm steps dial
                  nothing, a striped payload each way, native calls in the
                  volume's process, no card memory left by a get, every
                  listener on 127.0.0.2, no tst_shm_ segment and no process
                  left; then a fault leg at 2 layers: the client's first
                  bulk frame raises (bulk.send_frame), the batch lands on
                  rpc with ts_client_put_retries_total{transport=rpc} and
                  failovers{op=put} at 1, and after clearing it a get over
                  bulk reads it back bit-equal;
19. landing     - host-to-host landings at main's sizes (the Llama-3-8B
                  state dict in bf16, pageable host tensors on both ends,
                  depth from a printed plan of host memory): the landing
                  pool's Tensor.copy_ row blocks (the native library off)
                  against one native copy_batch submission of the same row
                  blocks with the same threads, in the order pool, native,
                  native, pool; s and GB/s each; gates: every destination
                  bit-equal to its source after each landing, native calls
                  only in the native runs;
20. spmd        - four processes launched with torchrun's variables (RANK,
                  WORLD_SIZE=4, LOCAL_RANK, LOCAL_WORLD_SIZE=2,
                  MASTER_ADDR=127.0.0.1, an ephemeral MASTER_PORT), an auth
                  secret and two emulated hosts (ranks 0-1 the trainer host,
                  2-3 the generator host), LocalRankStrategy, all on the one
                  card, at the depth a printed memory plan allows, at most
                  TIME_CAP_LAYERS: each
                  rank times initialize_spmd; the trainer ranks put their
                  Shard(0) half of the fp32 state dict (bf16 on the wire),
                  barrier, the generator ranks get their tensor-parallel
                  bf16 half on the card from the other host's volumes; then
                  a reput / reget after an in-place step, and the two-phase
                  shutdown; gates: every target bit-equal, every generator
                  read on the bulk rung (the trainers' puts on shm, their
                  own host), K1 launches = the planner's chunks on every
                  trainer put, no card memory left by a get, every rank
                  exits 0, no process left;
21. kernels     - one line listing every ported kernel.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device,
or without the package beside this file, it exits non-zero and prints no
result. Every phase that fails ends the run with a non-zero exit code.
"""

from __future__ import annotations

import argparse
import asyncio
import gc
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
    "device", "build", "parity", "timing", "main", "provision", "reshard", "quant", "channel",
    "flash_parity", "flash_timing", "ring", "model", "rl", "direct_device", "tiering", "healing",
    "runtime", "bulk", "landing", "spmd", "kernels",
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
TF32_FLOP_PER_S = 495e12  # dense TF32 tensor-core rate (the sm90_fp32 kernel's, 3 passes)
L2_BYTES = 50 * 2**20


# Depth of the phases that measure the paths of earlier slices again
# (reshard, quant, channel, tiering, runtime, bulk, healing, spmd): each
# still drives its path and holds K1 against the plain version, at this
# many layers, so the whole script stays inside its 1200 s limit with main
# and direct_device at full depth. At 12 layers (spmd at 32) every phase
# read 1165 s on a slow H100 host. Widths never change.
TIME_CAP_LAYERS = 6


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def time_capped(name: str, layers: int) -> int:
    """``layers``, or TIME_CAP_LAYERS when that is fewer (listed under
    ``reduced``)."""
    if layers <= TIME_CAP_LAYERS:
        return layers
    emit({"reduced": {name: TIME_CAP_LAYERS, "of": LAYERS,
                      "why": "the script's 1200 s limit; this path ran at 12 layers or at "
                             "full depth in earlier slices"}})
    return TIME_CAP_LAYERS


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
    # Every (type, head_dim, mode) instance of both tensor-core libraries:
    # no spill, setmaxnreg honoured; the sm90_fp32 kernel's wgmmas not
    # serialized either (C7512; printed for sm90).
    ok = True
    for variant, want in (("sm90", len(flash.SM90_DTYPES) * len(flash.SM90_HEAD_DIMS) * 2),
                          ("sm90_fp32", len(flash.SM90_FP32_HEAD_DIMS) * 2)):
        lib = out[f"flash_{variant}"]
        instances = _ptxas_instances(flash.stats_kernel.libs[variant].build_log.splitlines())
        lib["instances"] = instances
        lib["setmaxnreg_ignored"] = any(i["setmaxnreg_ignored"] for i in instances.values())
        lib["wgmma_serialized"] = sorted(n for n, i in instances.items() if i["wgmma_serialized"])
        ok = ok and (lib["spill_bytes"] == 0 and not lib["setmaxnreg_ignored"]
                     and len(instances) == want
                     and all(i["spill_bytes"] == 0 for i in instances.values()))
        if variant == "sm90_fp32":
            ok = ok and not lib["wgmma_serialized"]
    out["ok"] = ok
    return out


def _ptxas_instances(log: list) -> dict:
    """Per entry function of a tensor-core flash library's ``ptxas -v``
    log, named ``<type>_d<head_dim>_<stats|o>``: its registers at entry, its
    spill bytes, whether ptxas ignored a setmaxnreg in it (C7508) and
    whether it serialized its wgmmas (C7512, a line that names the
    function before its entry)."""
    import re

    def label(name):
        dtype = ("bf16" if "__nv_bfloat16" in name else "fp16" if "__half" in name
                 else "fp32" if "fp32" in name else "?")
        d = re.search(r"Li(\d+)E", name)
        stats = re.search(r"Lb([01])E", name)
        return (f"{dtype}_d{d.group(1) if d else '?'}_"
                f"{'stats' if stats and stats.group(1) == '1' else 'o'}")

    serialized = {label(m) for line in log if "C7512" in line
                  for m in re.findall(r"function '([^']+)'", line)}
    out, cur = {}, None
    for line in log:
        found = re.search(r"Compiling entry function '([^']+)'", line)
        if found:
            name = label(found.group(1))
            cur = out.setdefault(name, {"registers": None, "spill_bytes": 0,
                                        "setmaxnreg_ignored": False,
                                        "wgmma_serialized": name in serialized})
            continue
        if cur is None:
            continue
        cur["spill_bytes"] += sum(int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)",
                                                             line))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            cur["registers"] = int(used.group(1))
        if "C7508" in line or "setmaxnreg ignored" in line:
            cur["setmaxnreg_ignored"] = True
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


def _stop_children(grace_s: float = 5.0) -> list:
    """Stop what the run started and left running: the forkserver helper
    the store's actors start from, which would leave only after this
    process exits, and any other child of this process still alive but
    the resource tracker, which the interpreter stops at its exit. Returns
    the pids it stopped."""
    import signal
    from multiprocessing import resource_tracker

    tracker = getattr(resource_tracker._resource_tracker, "_pid", None)
    me, left = os.getpid(), []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
        except OSError:
            continue
        if int(ppid) == me and int(name) != tracker:
            left.append(int(name))
            if state != "Z":
                os.kill(int(name), signal.SIGTERM)
    deadline = time.monotonic() + grace_s
    for pid in left:
        while True:
            try:
                done, _ = os.waitpid(pid, os.WNOHANG)
            except ChildProcessError:
                break  # not ours to reap, or reaped already
            if done or time.monotonic() > deadline:
                if not done:
                    os.kill(pid, signal.SIGKILL)
                    os.waitpid(pid, 0)
                break
            time.sleep(0.05)
    return left


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=",".join(ALL_PHASES))
    parser.add_argument("--trace-leg", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.trace_leg is not None:  # the runtime phase's traced process
        return trace_leg_main(args.trace_leg)
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
        elif phase == "provision":
            res = phase_provision(torch, staging, results)
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
        elif phase == "runtime":
            res = phase_runtime(torch, staging)
        elif phase == "bulk":
            res = phase_bulk(torch, staging)
        elif phase == "landing":
            res = phase_landing(torch)
        elif phase == "spmd":
            res = phase_spmd(torch, staging)
        elif phase == "tiering":
            res = phase_tiering(torch, staging)
        elif phase == "healing":
            res = phase_healing(torch, staging)
        else:
            res = phase_kernels(results)
        res["seconds"] = time.perf_counter() - t0
        res.setdefault("device", torch.cuda.get_device_name(0))
        res["mem_available_bytes"] = mem_available_bytes()
        emit(res)
        results[phase] = res
        torch.cuda.empty_cache()
        # Mappings of unlinked segments held by a phase's cycles go now, not
        # under the next phase's memory plan.
        gc.collect()
        if res.get("ok") is False:
            print(f"chip_smoke: phase {phase} failed", file=sys.stderr)
            return 1
    emit({"children_stopped": _stop_children()})
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
    config = tst.StoreConfig(ici_enabled=False)
    out["prewarm_auto"] = config.prewarm_auto
    await tst.initialize(config=config)
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
# provision: cold-start provisioning ahead of the first sync
# --------------------------------------------------------------------------


def plan_provision_layers() -> tuple[int, dict]:
    """Depth whose two bf16 sets, the provisioned one and its twins (the
    rotation the reput draws), fit in /dev/shm and host memory as main's
    copies do. Widths never change."""
    from torchstore_tpu_torch.workloads import LLAMA3_8B, llama_shapes

    geo = dict(LLAMA3_8B)
    per_layer = sum(math.prod(s) for s in _leaves(llama_shapes(**{**geo, "layers": 1})["layers"]))
    outer = sum(math.prod(s) for s in _leaves({**llama_shapes(**{**geo, "layers": 0}),
                                               "layers": {}}))
    budget = 0.8 * min(shm_free_bytes(), mem_available_bytes())
    need = lambda n: 2 * 2 * (outer + n * per_layer)  # noqa: E731 - two bf16 sets
    layers = geo["layers"]
    while layers > 1 and need(layers) > budget:
        layers -= 1
    return layers, {"budget_bytes": int(budget), "needed_bytes": need(layers)}


async def _provision_leg_full(torch, staging, tst, layers: int, dev, geometry) -> dict:
    """Legs (a)-(c) on a fresh store with the automatic hint off."""
    from torchstore_tpu_torch.workloads import llama_state_dict

    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(2323)
    src = llama_state_dict(gen, device=dev, dtype=torch.float32, layers=layers,
                           **(geometry or {}))
    wire = 2 * sum(t.numel() for t in _leaves(src))
    chunks = len(staging.plan_chunks(list(_leaves(src)), bf16))
    targets = _bf16_zeros_like(torch, src, dev)
    out: dict = {"layers": layers, "tensors": sum(1 for _ in _leaves(src)), "wire_bytes": wire,
                 "chunks": chunks}
    await tst.initialize(store_name="provision", config=tst.StoreConfig(prewarm_auto=False))
    client = tst.client("provision")
    try:
        pinned = client.shm_stats()["pin_seconds"]
        launched = staging.cast_kernel.launches
        t0 = time.perf_counter()
        report = await tst.prewarm(src, store_name="provision", transfer_dtype=bf16)
        out["prewarm_s"] = time.perf_counter() - t0
        out["prewarm_pin_s"] = client.shm_stats()["pin_seconds"] - pinned
        out["prewarm_launches"] = staging.cast_kernel.launches - launched
        out["report"] = {**report, "transports": sorted(set(report.get("transports",
                                                                       {}).values()))}
        before = await _pool_counts(client)
        launched = staging.cast_kernel.launches
        t0 = time.perf_counter()
        await tst.put_state_dict("policy", src, transfer_dtype=bf16, store_name="provision")
        torch.cuda.synchronize()
        out["put_s"] = time.perf_counter() - t0
        after = await _pool_counts(client)
        out["put_launches"] = staging.cast_kernel.launches - launched
        out["put_pool"] = {k: after[k] - before[k] for k in after if k != "warming"}
        t0 = time.perf_counter()
        await tst.get_state_dict("policy", targets, store_name="provision")
        torch.cuda.synchronize()
        out["get_s"] = time.perf_counter() - t0
        bad = [i for i, (t, s) in enumerate(_pairs(targets, src)) if not torch.equal(t, s.to(bf16))]
        out["get_mismatched"] = len(bad)
        # The training step's gap, as main's reputs take it: the volume's
        # twins populated, the client's attachments of them made and locked.
        out["reput_warm_wait_s"] = await _wait_warm(client)
        out["reput_pin_wait_s"] = await client.wait_pinned()
        for t in _leaves(src):
            t.add_(1.0)  # the training step, in place
        before = await _pool_counts(client)
        launched = staging.cast_kernel.launches
        t0 = time.perf_counter()
        await tst.put_state_dict("policy", src, transfer_dtype=bf16, store_name="provision")
        torch.cuda.synchronize()
        out["reput_s"] = time.perf_counter() - t0
        after = await _pool_counts(client)
        out["reput_launches"] = staging.cast_kernel.launches - launched
        out["reput_pool"] = {k: after[k] - before[k] for k in after if k != "warming"}
        t0 = time.perf_counter()
        await tst.get_state_dict("policy", targets, store_name="provision")
        torch.cuda.synchronize()
        out["reget_s"] = time.perf_counter() - t0
        rebad = [i for i, (t, s) in enumerate(_pairs(targets, src))
                 if not torch.equal(t, s.to(bf16))]
        out["reget_mismatched"] = len(rebad)
    finally:
        await tst.shutdown("provision")
    out["gb_per_s"] = {step: wire / out[f"{step}_s"] / 1e9
                       for step in ("put", "get", "reput", "reget")}
    out["prewarm_put_reput_s"] = out["prewarm_s"] + out["put_s"] + out["reput_s"]
    pool, repool = out["put_pool"], out["reput_pool"]
    out["ok"] = (
        report["ok"] and report["errors"] == {}
        and report["bytes"] + report["clamped_bytes"] == wire
        and report["rotation_bytes"] == report["bytes"]
        and out["prewarm_launches"] == 0
        and pool["volume_created"] == 0 and pool["miss"] == 0 and pool["cold_create"] == 0
        and repool["volume_created"] == 0 and repool["miss"] == 0
        and repool["cold_create"] == 0
        and (dev.type != "cuda" or out["put_launches"] == out["reput_launches"] == chunks)
        and not bad and not rebad
    )
    return out


async def _provision_leg_channel(torch, staging, tst, layers: int, dev, geometry) -> dict:
    """Leg (d): register, then the first publish of a channel, with no cold
    segment; acquired bit-equal."""
    from torchstore_tpu_torch.workloads import llama_state_dict

    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(2324)
    src = llama_state_dict(gen, device=dev, dtype=torch.float32, layers=layers,
                           **(geometry or {}))
    targets = _bf16_zeros_like(torch, src, dev)
    out: dict = {"layers": layers, "chunks": len(staging.plan_chunks(list(_leaves(src)), bf16))}
    await tst.initialize(store_name="provision_chan",
                         config=tst.StoreConfig(prewarm_auto=False))
    client = tst.client("provision_chan")
    try:
        pub = tst.WeightPublisher("policy", store_name="provision_chan")
        sub = tst.WeightSubscriber("policy", store_name="provision_chan")
        t0 = time.perf_counter()
        report = await pub.register(src, transfer_dtype=bf16)
        out["register_s"] = time.perf_counter() - t0
        out["register"] = {k: report[k] for k in ("ok", "segments", "bytes", "clamped_bytes",
                                                  "pre_attached", "errors")}
        before = await _pool_counts(client)
        launched = staging.cast_kernel.launches
        t0 = time.perf_counter()
        version = await pub.publish(src, transfer_dtype=bf16)
        torch.cuda.synchronize()
        out["publish_s"] = time.perf_counter() - t0
        out["publish_launches"] = staging.cast_kernel.launches - launched
        after = await _pool_counts(client)
        out["publish_pool"] = {k: after[k] - before[k] for k in after if k != "warming"}
        _, got = await sub.acquire(targets, timeout=600)
        torch.cuda.synchronize()
        bad = [i for i, (t, s) in enumerate(_pairs(targets, src)) if not torch.equal(t, s.to(bf16))]
        out.update({"version": version, "acquired": got, "mismatched": len(bad)})
    finally:
        await tst.shutdown("provision_chan")
    pool = out["publish_pool"]
    out["ok"] = (report["ok"] and report["segments"] > 0 and got == version and not bad
                 and pool["volume_created"] == 0 and pool["miss"] == 0
                 and pool["cold_create"] == 0
                 and (dev.type != "cuda" or out["publish_launches"] == out["chunks"]))
    return out


async def _provision_leg_auto(torch, staging, tst, layers: int, dev, geometry) -> dict:
    """Leg (e): on a store with the automatic hint on, the first put fires
    one automatic prewarm and a second put of the same signature none, on
    the twins the first announced."""
    from torchstore_tpu_torch.provision import executors
    from torchstore_tpu_torch.workloads import llama_state_dict

    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(2325)
    src = llama_state_dict(gen, device=dev, dtype=torch.float32, layers=layers,
                           **(geometry or {}))
    targets = _bf16_zeros_like(torch, src, dev)
    wire = 2 * sum(t.numel() for t in _leaves(src))
    out: dict = {"layers": layers}
    await tst.initialize(store_name="provision_auto", config=tst.StoreConfig(prewarm_auto=True))
    client = tst.client("provision_auto")
    launched = staging.cast_kernel.launches
    try:
        runs = []
        for step in ("put", "put2"):
            if step == "put2":
                for t in _leaves(src):
                    t.add_(1.0)  # the training step, in place
                out["warm_wait_s"] = await _wait_warm(client)
                out["pin_wait_s"] = await client.wait_pinned()
            before, n = await _pool_counts(client), executors.RUNS.total()
            t0 = time.perf_counter()
            await tst.put_state_dict("policy", src, transfer_dtype=bf16,
                                     store_name="provision_auto")
            torch.cuda.synchronize()
            out[f"{step}_s"] = time.perf_counter() - t0
            after = await _pool_counts(client)
            out[f"{step}_pool"] = {k: after[k] - before[k] for k in after if k != "warming"}
            runs.append(executors.RUNS.total() - n)
        await tst.get_state_dict("policy", targets, store_name="provision_auto")
        torch.cuda.synchronize()
        bad = [i for i, (t, s) in enumerate(_pairs(targets, src)) if not torch.equal(t, s.to(bf16))]
    finally:
        await tst.shutdown("provision_auto")
    out.update({"auto_runs": runs, "mismatched": len(bad),
                "launches": staging.cast_kernel.launches - launched,
                "gb_per_s": {s: wire / out[f"{s}_s"] / 1e9 for s in ("put", "put2")}})
    put2 = out["put2_pool"]
    out["ok"] = (runs == [1, 0] and out["put_pool"]["miss"] == 0 and not bad
                 and put2["miss"] == 0 and put2["cold_create"] == 0
                 and put2["volume_created"] == 0)
    return out


async def _provision_path(torch, staging, layers: int, capped: int, dev,
                          geometry=None) -> dict:
    import torchstore_tpu_torch as tst
    from torchstore_tpu_torch.transport.shared_memory import PREFIX, SHM_DIR

    staging.cast_kernel.launches = 0  # count this path's launches only
    staging.cast_kernel.fallbacks = 0
    known = {p.pid for p in multiprocessing.active_children()}
    pids = set()
    legs = {}
    for name, leg, depth in (("full", _provision_leg_full, layers),
                             ("channel", _provision_leg_channel, capped),
                             ("auto", _provision_leg_auto, capped)):
        legs[name] = await leg(torch, staging, tst, depth, dev, geometry)
        pids |= {p.pid for p in multiprocessing.active_children()} - known
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    await asyncio.sleep(0.5)
    alive = [p.pid for p in multiprocessing.active_children() if p.pid not in known]
    own = pids | {os.getpid()}
    leaked = [n for n in os.listdir(SHM_DIR)
              if n.startswith(PREFIX) and int(n[len(PREFIX):].split("_")[0]) in own]
    launches_by_leg = {"full": legs["full"]["put_launches"] + legs["full"]["reput_launches"],
                       "channel": legs["channel"]["publish_launches"],
                       "auto": legs["auto"]["launches"]}
    return {**legs, "launches": staging.cast_kernel.launches,
            "launches_by_leg": launches_by_leg, "cast_fallbacks": staging.cast_kernel.fallbacks,
            "processes_left": alive, "segments_left": leaked[:5],
            "ok": (all(leg["ok"] for leg in legs.values()) and not alive and not leaked
                   and staging.cast_kernel.fallbacks == 0)}


def phase_provision(torch, staging, results: dict) -> dict:
    layers, plan = plan_provision_layers()
    if layers < LAYERS:
        emit({"reduced": {"provision_layers": layers, "of": LAYERS}, **plan})
    capped = time_capped("provision_legs_d_e", LAYERS)
    res = asyncio.run(_provision_path(torch, staging, layers, capped, torch.device("cuda", 0)))
    res["phase"] = "provision"
    res["plan"] = plan
    if "main" in results:  # main's first put and reput, from the same run
        main = results["main"]
        res["main_put_gb_per_s"] = main["gb_per_s"]["put"]
        res["main_put_reput_s"] = main["timings"]["put_s"] + main["timings"]["reput_s"]
        res["main_prewarm_auto"] = main["prewarm_auto"]
    res["nvidia_smi"] = sh(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"])
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
    layers = time_capped("reshard_layers", layers)
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
    layers = time_capped("quant_layers", LAYERS)
    res = asyncio.run(_quant_path(torch, layers, torch.device("cuda", 0)))
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


def _model_shapes(torch, cfg, layers: int) -> dict:
    """The port Llama's state-dict shapes at ``cfg``'s width and ``layers``
    deep (Llama-3-8B: 291 tensors at 32 layers; the model's own key names,
    so ``forward_key_order`` orders them)."""
    import dataclasses

    from torchstore_tpu_torch.models.llama import Llama

    model = Llama(dataclasses.replace(cfg, num_layers=layers), torch.device("meta"))
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def _model_state(torch, cfg, layers: int, gen, dev) -> dict:
    """``_model_shapes``' tensors, fp32 standard normal on ``dev`` from
    ``gen``, as ``workloads.llama_state_dict`` fills its tensors."""
    return {k: torch.randn(s, generator=gen, device=dev)
            for k, s in _model_shapes(torch, cfg, layers).items()}


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
    layers = time_capped("channel_layers", layers)
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
    ("gemma-sq1000-sk1537", 1, 1000, 1537, 16, 16, 256),
    ("gqa-d72-300", 1, 300, 300, 4, 2, 72),
    ("8b-sq77-sk40", 1, 77, 40, HEADS, KV_HEADS, HEAD_DIM),
    ("8b-sq8192-sk1", 1, 8192, 1, HEADS, KV_HEADS, HEAD_DIM),
    ("8b-sq1000-sk1537-b4", 4, 1000, 1537, HEADS, KV_HEADS, HEAD_DIM),
    ("packed-8b-2048", 1, 2048, 2048, HEADS, KV_HEADS, HEAD_DIM),
    # Head dims between the tensor-core instances (64, 128, 256), zero-padded
    # to the next one up: d 8 and 40 on the d = 64 instance, 96 (Phi-3-mini's
    # attention width: h = hk = 32) on 128, 136 and 200 on 256.
    ("gqa-d8-257", 1, 257, 257, 4, 2, 8),
    ("gqa-d40-sq300-sk1000", 1, 300, 1000, 8, 2, 40),
    ("phi3-sq1000-sk1537", 1, 1000, 1537, 32, 32, 96),
    ("packed-phi3-2048", 1, 2048, 2048, 32, 32, 96),
    ("gqa-d136-sq300-sk777", 1, 300, 777, 8, 2, 136),
    ("mha-d200-513", 1, 513, 513, 4, 4, 200),
    # q, k, v each cut from rows of d + 2 elements: strides TMA refuses, so
    # every type runs on the simt kernel.
    ("rowpad-phi3-1024", 1, 1024, 1024, 32, 32, 96),
    ("rowpad-gqa-d72-300", 1, 300, 300, 4, 2, 72),
)
# The cases that run in fp16 too (beside fp32 and bf16): d 64, 72, 96, 136
# and 256, one ragged Llama-3-8B case, the packed views and a case with
# strides TMA refuses.
FLASH_FP16_CASES = ("mha-d64-1025", "mha-d256-sq1024-sk1000", "gqa-d256-4096", "gqa-d72-300",
                    "8b-sq1000-sk1537", "packed-8b-2048", "phi3-sq1000-sk1537",
                    "packed-phi3-2048", "gqa-d136-sq300-sk777", "rowpad-phi3-1024")
# The layouts a case's label may start with (``_qkv``); others are contiguous.
FLASH_LAYOUTS = ("packed", "rowpad")
FLASH_TOL = {
    "stats": "m, l: |got - want| <= 1e-5 + 1e-4 |want|; acc the same after dividing "
             "got and want by want's l (fp32, bf16 and fp16 inputs)",
    "o_fp32": "|got - want| <= 1e-5 + 1e-4 |want|",
    "o_bf16": "|got - want| <= 1e-5 + 2 bf16 ulps of want",
    "o_fp16": "|got - want| <= 1e-5 + 2 fp16 ulps of want (11 significant bits)",
    "sm90_vs_blockwise": "against stats_blockwise_reference (the same arithmetic: p rounded "
                         "to the input type, block_k = the k-tile of the instance the call "
                         "runs on, padded_head_dim(d): 128 at 64 and 128, 64 at 256): m, l "
                         "as 'stats'; acc (on o's scale) "
                         "within 1e-5 + 1e-4 |want| + flip, o within 1e-5 + 2 ulps of the "
                         "input type + flip, where flip = 2 u max_k |v_kd| / l with u = 2**-7 "
                         "(bf16) or 2**-10 (fp16): the two fp32 p differ in their last bits "
                         "(q.k^T summed in another order) and can round to adjacent values, "
                         "one ulp (<= u p) per term; flip allows two such terms at the row's "
                         "largest weight (p <= 1). 'strict_outside' counts acc values outside "
                         "1e-5 + 1e-4 |want|",
    "sm90_fp32": "fp32 inputs whose strides TMA takes (the sm90_fp32 kernel, 3xTF32): held "
                 "to 'stats' and 'o_fp32' against the fp32 plain version; beside it, reported "
                 "and not gated, the worst errors of acc (on o's scale), m, l and o against "
                 "its twin stats_blockwise_reference(split='tf32x3', _round_p=False) at the "
                 "k-tile SM90_FP32_BLOCK_K[padded_head_dim(d)] (the same TF32 roundings; the "
                 "fp32 sums, of up to 8192 terms, in another order)",
    "sm90_vs_fp32": "against the fp32 plain version, with SDPA (is_causal, enable_gqa) on "
                    "the same inputs (of the same type) as the yardstick: the kernel's o and "
                    "acc/l each have a worst error <= 2x SDPA's worst error against "
                    "attention_reference; m, l as 'stats' (both sum the fp32 p). p rounded to "
                    "the input type before P.V, as in SDPA's own kernels, is the rounding the "
                    "fp32 version does not make",
    "fp64": "on FLASH_FP64_CASES in fp32: the worst |o - o64| of the sm90_fp32 kernel, the "
            "simt kernel (forced) and the fp32 plain version, o64 computed in fp64 from the "
            "same fp32 inputs; reported, not gated",
}
# fp32 cases whose o is also held against fp64 (reported): d = 128 and 256.
FLASH_FP64_CASES = ("8b-1025", "mha-d256-sq1024-sk1000", "gemma-sq1000-sk1537")
SDPA_YARDSTICK = 2.0  # the sm90 kernel's worst error may be this multiple of SDPA's
# The timed shapes: b, s, h, hk, d (bf16): Llama-3-8B attention width, and
# Gemma-7B's (h = hk = 16, d = 256: torchstore_tpu_torch/models/llama.py).
FLASH_TIMED = (1, 8192, HEADS, KV_HEADS, HEAD_DIM)
FLASH_TIMED_SHORT = 4096  # the ring phase's backward length
GEMMA_HEADS = (16, 16, 256)
FLASH_TIMED_GEMMA = (1, 8192, *GEMMA_HEADS)
# A head dim between the tensor-core instances: Phi-3-mini's attention
# (hidden 3072, 32 heads of 96, as many kv heads; its published config),
# on the d = 128 instances zero-padded, at the ring phase's short length.
PHI3_HEADS = (32, 32, 96)
FLASH_TIMED_PHI3 = (1, 2048, *PHI3_HEADS)
# Significant bits of each 16-bit type: one ulp of x is 2**(e - bits) for
# x = f 2**e, 0.5 <= |f| < 1, so at most 2**(1 - bits) |x|.
SIG_BITS = {"bfloat16": 8, "float16": 11}


def _ulp(torch, x, dtype):
    """One ulp of ``dtype`` (bf16 or fp16) at each value of ``x``."""
    _, exp = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), exp - SIG_BITS[str(dtype)[6:]])


def _within(torch, got, want, rtol=1e-4, atol=1e-5, ulps=None, extra=None) -> dict:
    """Worst error of ``got`` against ``want`` and the count of values
    outside the tolerance: atol + rtol |want|, or ``ulps`` ulps of got's
    16-bit type (plus ``atol``), plus the tensor ``extra`` where given."""
    dtype = got.dtype
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if ulps is None:
        allowed = atol + rtol * want.abs()
    else:
        allowed = atol + ulps * _ulp(torch, want, dtype)
    if extra is not None:
        allowed = allowed + extra
    bad = int((err > allowed).sum().item()) + int((~torch.isfinite(got)).sum().item())
    return {"max_abs_err": float(err.max().item()) if err.numel() else 0.0, "outside": bad}


def _qkv(torch, gen, dev, b, sq, sk, h, hk, d, dtype, layout=None):
    """Seeded q, k, v. ``layout`` "packed": strided views of one (b, s,
    h + 2 hk, d) projection output (TMA takes them); "rowpad": each cut from
    rows of d + 2 elements, so every stride but d's is 2 mod 8 elements and
    TMA refuses them (the simt kernel's calls); None: contiguous."""
    if layout == "packed":
        qkv = torch.randn((b, sq, h + 2 * hk, d), generator=gen, device=dev).to(dtype)
        return qkv[:, :, :h], qkv[:, :, h:h + hk], qkv[:, :, h + hk:]
    pad = 2 if layout == "rowpad" else 0
    q = torch.randn((b, sq, h, d + pad), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, sk, hk, d + pad), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, sk, hk, d + pad), generator=gen, device=dev).to(dtype)
    return (q[..., :d], k[..., :d], v[..., :d]) if pad else (q, k, v)


def _case_layout(label: str):
    """The ``_qkv`` layout a FLASH_CASES label names, or None."""
    first = label.split("-")[0]
    return first if first in FLASH_LAYOUTS else None


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
    """2 u max_k |v_kd| / l per (b, h, sq, d), u = 2**(1 - bits) of v's
    type: two roundings of p to adjacent values, at a weight p <= 1
    (FLASH_TOL)."""
    u = 2.0 ** (1 - SIG_BITS[str(v.dtype)[6:]])
    vmax = v.float().abs().amax(dim=1).repeat_interleave(h // v.shape[2], dim=1)  # (b, h, d)
    return 2 * u * vmax[:, :, None, :] / l[..., None]


def _check_sm90(torch, flash, q, k, v, causal, got, o) -> dict:
    """The two comparisons of an sm90 case: against the blockwise plain
    version at the kernel's own k-tile, and against the fp32 one with SDPA
    as the yardstick."""
    h = q.shape[2]
    block_k = flash.SM90_BLOCK_K[flash.padded_head_dim(q.shape[3])]
    bw = flash.stats_blockwise_reference(q, k, v, causal, block_k)
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


def _check_tf32x3_twin(torch, flash, q, k, v, causal, got, o) -> dict:
    """An sm90_fp32 case against its 3xTF32 twin at the kernel's k-tile:
    the worst error of acc (on o's scale), m, l and o."""
    tw = flash.stats_blockwise_reference(q, k, v, causal, _round_p=False, split="tf32x3")
    n = tw[2][..., None]
    res = {"acc": _within(torch, got[0] / n, tw[0] / n)["max_abs_err"]}
    res.update({name: _within(torch, g, w)["max_abs_err"]
                for name, g, w in zip("ml", got[1:], tw[1:])})
    res["o"] = _within(torch, o, flash._normalize(tw[0], tw[2], q.dtype))["max_abs_err"]
    return res


def _fp64_errors(torch, flash, q, k, v, causal, o) -> dict:
    """The worst |o - o64| of the kernel's o, the simt kernel's (forced)
    and the fp32 plain version's, o64 being attention computed in fp64 from
    the same fp32 inputs (FLASH_TOL "fp64"; reported, not gated)."""
    g = q.shape[2] // k.shape[2]
    qd, kd, vd = (x.transpose(1, 2).double() for x in (q, k, v))
    kd, vd = kd.repeat_interleave(g, dim=1), vd.repeat_interleave(g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qd, kd) / math.sqrt(q.shape[3])
    if causal:
        rows = torch.arange(s.shape[2], device=q.device)[:, None]
        cols = torch.arange(s.shape[3], device=q.device)[None, :]
        s = torch.where(rows >= cols, s, -math.inf)
    o64 = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), vd).transpose(1, 2)
    del s, qd, kd, vd
    outs = {"kernel": o, "simt": flash.attention_kernel(q, k, v, causal, _variant="simt"),
            "fp32_plain": flash.attention_reference(q, k, v, causal)}
    return {name: float((x.double() - o64).abs().max().item()) for name, x in outs.items()}


def phase_flash_parity(torch, flash) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    cases = []
    worst = {f"{mode}_{variant}": 0.0 for mode in ("stats", "o")
             for variant in ("sm90", "sm90_fp32", "simt")}
    worst.update({f"{mode}_{key}": 0.0 for mode in ("stats", "o")
                  for key in ("sm90_d256", "sm90_fp16", "sm90_fp32_d256", "sm90_pad",
                              "sm90_fp32_pad")})
    fp16_s = 0.0
    for label, b, sq, sk, h, hk, d in FLASH_CASES:
        dtypes = [torch.float32, torch.bfloat16]
        if label in FLASH_FP16_CASES:
            dtypes.append(torch.float16)
        for dtype in dtypes:
            t_case = time.perf_counter()
            layout = _case_layout(label)
            q, k, v = _qkv(torch, gen, dev, b, sq, sk, h, hk, d, dtype, layout=layout)
            variant = flash.flash_variant(q, k, v)
            # Every case's d is a multiple of 8 up to 256, so the strides and
            # the type decide: the "rowpad" cases' strides TMA refuses.
            if layout == "rowpad":
                rule = "simt"
            else:
                rule = "sm90" if dtype != torch.float32 else "sm90_fp32"
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
                    if dtype == torch.float32:
                        res["o"] = _within(torch, o, o_want)
                    else:
                        res["o"] = _within(torch, o, o_want, atol=1e-5, ulps=2)
                    del o_want
                    err_stats = max(res["m"]["max_abs_err"], res["l"]["max_abs_err"],
                                    res["acc"]["raw_max_abs_err"])
                    err_o = res["o"]["max_abs_err"]
                twin = fp64 = None
                if variant == "sm90_fp32":
                    twin = _check_tf32x3_twin(torch, flash, q, k, v, causal, got, o)
                    if label in FLASH_FP64_CASES:
                        fp64 = _fp64_errors(torch, flash, q, k, v, causal, o)
                del got, o
                ok = all(r["outside"] == 0 for r in res.values()) and ran == {
                    "flash_stats": [variant], "flash": [variant]} and variant == rule
                keys = [variant]
                if variant == "sm90" and d == 256:
                    keys.append("sm90_d256")
                if variant == "sm90" and dtype == torch.float16:
                    keys.append("sm90_fp16")
                if variant == "sm90_fp32" and d == 256:
                    keys.append("sm90_fp32_d256")
                if variant != "simt" and d not in flash.SM90_HEAD_DIMS:
                    keys.append(f"{variant}_pad")
                for key in keys:
                    worst[f"stats_{key}"] = max(worst[f"stats_{key}"], err_stats)
                    worst[f"o_{key}"] = max(worst[f"o_{key}"], err_o)
                cases.append({
                    "case": f"{label} {str(dtype)[6:]} {'causal' if causal else 'full'}",
                    "variant": variant, "launched": ran, "ok": ok,
                    "padded": variant != "simt" and d not in flash.SM90_HEAD_DIMS, **res,
                    **({"twin": twin} if twin else {}),
                    **({"fp64_o_max_abs_err": fp64} if fp64 else {}),
                })
            del q, k, v
            torch.cuda.empty_cache()
            if dtype == torch.float16:
                fp16_s += time.perf_counter() - t_case
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
        if c["variant"] == "sm90_fp32":
            row["twin_max_abs_err"] = c["twin"]
        if "fp64_o_max_abs_err" in c:
            row["fp64_o_max_abs_err"] = c["fp64_o_max_abs_err"]
        rows.append(row)
    return {
        "phase": "flash_parity",
        "ok": not failed,
        "cases": len(cases),
        "sm90_cases": sum(c["variant"] == "sm90" for c in cases),
        "sm90_fp32_cases": sum(c["variant"] == "sm90_fp32" for c in cases),
        "simt_cases": sum(c["variant"] == "simt" for c in cases),
        "padded_cases": sum(c["padded"] for c in cases),
        "fp16_cases": sum(" float16 " in c["case"] for c in cases),
        "fp16_seconds": fp16_s,
        "failed": failed[:10],
        "worst": worst,
        "tolerance": FLASH_TOL,
        "rows": rows,
    }


def flash_bound(b, sq, sk, h, hk, d, causal, in_bytes, stats,
                flop_per_s=BF16_FLOP_PER_S, passes=1) -> dict:
    """Least time for one call: 4 b h sq sk d operations (halved when
    causal, as benchmarks/flash_kernel_bench.py counts), ``passes`` times
    over (3 for the sm90_fp32 kernel's 3xTF32 split), at the peak of the
    math the kernel does (the bf16 tensor cores for sm90, the TF32 ones for
    sm90_fp32, float32 CUDA cores for simt), against each input read once
    and each output written once at the HBM rate; the larger of the two."""
    flop = 4 * b * h * sq * sk * d / (2 if causal else 1)
    nbytes = in_bytes * (b * sq * h * d + 2 * b * sk * hk * d)
    nbytes += 4 * (b * h * sq * d + 2 * b * h * sq) if stats else in_bytes * b * sq * h * d
    ops_ms, bytes_ms = passes * flop / flop_per_s * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {
        "flop": flop, "passes": passes, "bytes": nbytes, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
    }


def phase_flash_timing(torch, flash) -> dict:
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    b, s, h, hk, d = FLASH_TIMED
    bf16, fp16 = torch.bfloat16, torch.float16
    # (tokens, h, hk, d, dtype) of each input set. Two sets of each, 96 MB a
    # set at Llama-3-8B width and 192 MB at Gemma-7B's: every call reads
    # memory that is not in L2.
    # "d96_rowpad": Phi-3-mini width with q, k, v cut from rows of d + 2
    # (strides TMA refuses: the simt kernel's calls by the rules).
    shapes = {"8b": (s, h, hk, d, bf16), "8b_4096": (FLASH_TIMED_SHORT, h, hk, d, bf16),
              "8b_fp16": (s, h, hk, d, fp16), "gemma": (FLASH_TIMED_GEMMA[1], *GEMMA_HEADS, bf16),
              "d96": (FLASH_TIMED_PHI3[1], *PHI3_HEADS, bf16),
              "d96_rowpad": (FLASH_TIMED_PHI3[1], *PHI3_HEADS, bf16)}
    inputs = {key: [_qkv(torch, gen, dev, b, n, n, hh, kh, dd, dt,
                         layout="rowpad" if key.endswith("rowpad") else None)
                    for _ in range(2)]
              for key, (n, hh, kh, dd, dt) in shapes.items()}
    # The same values in fp32: the fp32 calls' inputs (sm90_fp32, the simt
    # route forced, SDPA and the plain version beside them).
    for key in ("8b", "gemma", "d96"):
        shapes[f"{key}_fp32"] = (*shapes[key][:4], torch.float32)
        inputs[f"{key}_fp32"] = [[t.float() for t in qkv] for qkv in inputs[key]]
    before = _flash_counts(flash)

    def stats(causal, variant=None):
        return lambda q, k, v: flash.stats_kernel(q, k, v, causal, _variant=variant)

    def attention(causal, variant=None):
        return lambda q, k, v: flash.attention_kernel(q, k, v, causal, _variant=variant)

    def stats_plain(causal):
        return lambda q, k, v: flash.stats_reference(q, k, v, causal)

    def attention_plain(causal):
        return lambda q, k, v: flash.attention_reference(q, k, v, causal)

    sdpa = lambda causal: lambda q, k, v: _sdpa(torch, q, k, v, causal)  # noqa: E731
    # name: (input set, causal, stats mode, variant, kernel, plain, library).
    # The fp32 rows, at every width, time the sm90_fp32 kernel against the
    # 3xTF32 bound (three TF32 passes) and the simt route forced on the same
    # fp32 inputs against the fp32 CUDA-core bound, SDPA on those inputs
    # beside both. A simt row without a plain version reports its
    # tensor-core twin's (the row of the same inputs and mode). The d96 rows
    # time the d = 128 instances zero-padded at d = 96, the simt kernel
    # forced beside them (the route before padding); the rowpad rows time
    # simt where the rules send calls to it.
    plan = {
        "flash_stats": ("8b", False, True, "sm90", stats(False), stats_plain(False), sdpa(False)),
        "flash_stats_causal_diag": ("8b", True, True, "sm90", stats(True), stats_plain(True),
                                    sdpa(True)),
        "flash_causal": ("8b", True, False, "sm90", attention(True), attention_plain(True),
                         sdpa(True)),
        "flash_stats_4096": ("8b_4096", False, True, "sm90", stats(False), stats_plain(False),
                             sdpa(False)),
        "flash_stats_fp32": ("8b_fp32", False, True, "sm90_fp32", stats(False),
                             stats_plain(False), sdpa(False)),
        "flash_stats_causal_diag_fp32": ("8b_fp32", True, True, "sm90_fp32", stats(True),
                                         stats_plain(True), sdpa(True)),
        "flash_causal_fp32": ("8b_fp32", True, False, "sm90_fp32", attention(True),
                              attention_plain(True), sdpa(True)),
        "flash_stats_simt": ("8b_fp32", False, True, "simt", stats(False, "simt"), None,
                             sdpa(False)),
        "flash_stats_causal_diag_simt": ("8b_fp32", True, True, "simt", stats(True, "simt"),
                                         None, sdpa(True)),
        "flash_causal_simt": ("8b_fp32", True, False, "simt", attention(True, "simt"), None,
                              sdpa(True)),
        "flash_stats_fp16": ("8b_fp16", False, True, "sm90", stats(False), stats_plain(False),
                             sdpa(False)),
        "gemma_flash_stats": ("gemma", False, True, "sm90", stats(False), stats_plain(False),
                              sdpa(False)),
        "gemma_flash_stats_causal_diag": ("gemma", True, True, "sm90", stats(True),
                                          stats_plain(True), sdpa(True)),
        "gemma_flash_causal": ("gemma", True, False, "sm90", attention(True),
                               attention_plain(True), sdpa(True)),
        "gemma_flash_stats_fp32": ("gemma_fp32", False, True, "sm90_fp32", stats(False),
                                   stats_plain(False), sdpa(False)),
        "gemma_flash_stats_causal_diag_fp32": ("gemma_fp32", True, True, "sm90_fp32",
                                               stats(True), stats_plain(True), sdpa(True)),
        "gemma_flash_causal_fp32": ("gemma_fp32", True, False, "sm90_fp32", attention(True),
                                    attention_plain(True), sdpa(True)),
        "gemma_flash_stats_simt": ("gemma_fp32", False, True, "simt", stats(False, "simt"), None,
                                   sdpa(False)),
        "gemma_flash_stats_causal_diag_simt": ("gemma_fp32", True, True, "simt",
                                               stats(True, "simt"), None, sdpa(True)),
        "gemma_flash_causal_simt": ("gemma_fp32", True, False, "simt", attention(True, "simt"),
                                    None, sdpa(True)),
        "d96_flash_stats": ("d96", False, True, "sm90", stats(False), stats_plain(False),
                            sdpa(False)),
        "d96_flash_causal": ("d96", True, False, "sm90", attention(True), attention_plain(True),
                             sdpa(True)),
        "d96_flash_stats_simt": ("d96", False, True, "simt", stats(False, "simt"), None,
                                 sdpa(False)),
        "d96_flash_causal_simt": ("d96", True, False, "simt", attention(True, "simt"), None,
                                  sdpa(True)),
        "d96_flash_stats_fp32": ("d96_fp32", False, True, "sm90_fp32", stats(False),
                                 stats_plain(False), sdpa(False)),
        "d96_flash_causal_fp32": ("d96_fp32", True, False, "sm90_fp32", attention(True),
                                  attention_plain(True), sdpa(True)),
        "d96_flash_stats_fp32_simt": ("d96_fp32", False, True, "simt", stats(False, "simt"),
                                      None, sdpa(False)),
        "d96_flash_causal_fp32_simt": ("d96_fp32", True, False, "simt",
                                       attention(True, "simt"), None, sdpa(True)),
        "rowpad_flash_stats": ("d96_rowpad", False, True, "simt", stats(False),
                               stats_plain(False), sdpa(False)),
        "rowpad_flash_causal": ("d96_rowpad", True, False, "simt", attention(True),
                                attention_plain(True), sdpa(True)),
    }
    rows = {}
    gemma_s = 0.0
    for name, (key, causal, is_stats, variant, kernel, plain, library) in plan.items():
        t_row = time.perf_counter()
        n, rh, rhk, rd, dtype = shapes[key]
        fns = {"kernel": kernel, "library": library}
        order = ["kernel", "library", "library", "kernel"]
        if plain is not None:
            fns["plain"] = plain
            order = ["kernel", "plain", "library", "library", "plain", "kernel"]
        runs = {x: [] for x in fns}
        mode = flash.stats_kernel if is_stats else flash.attention_kernel
        launched = mode.launches_by_variant[variant]
        for x in order:  # in turns; each reports the better of its two runs
            runs[x].append(_time_ms(torch, lambda qkv: fns[x](*qkv), inputs[key], iters=5))
        if variant == "sm90_fp32":
            rate, passes, bound_rate = TF32_FLOP_PER_S, 3, "TF32 tensor cores, 3 passes (3xTF32)"
        elif dtype == torch.float32:
            rate, passes, bound_rate = FP32_FLOP_PER_S, 1, "fp32 CUDA cores"
        else:
            rate, passes, bound_rate = BF16_FLOP_PER_S, 1, "16-bit tensor cores"
        bound = flash_bound(b, n, n, rh, rhk, rd, causal, dtype.itemsize, is_stats, rate, passes)
        ms = min(runs["kernel"])
        # The tensor-core row of the same inputs and mode (an earlier row).
        twin = next((other for other, row in plan.items()
                     if row[:3] == (key, causal, is_stats) and row[3] != "simt"), None)
        rows[name] = {
            "shape": {"b": b, "sq": n, "sk": n, "h": rh, "hk": rhk, "d": rd,
                      "dtype": str(dtype)[6:]},
            "causal": causal,
            "variant": variant,
            "ran_on_variant": mode.launches_by_variant[variant] > launched,
            "ms": ms,
            "plain_ms": min(runs["plain"]) if plain is not None else rows[twin]["plain_ms"],
            **({"layout": "rows of d + 2 (strides TMA refuses)"} if key.endswith("rowpad")
               else {}),
            "library_ms": min(runs["library"]),
            "library": ("SDPA" + (" on the same fp32 inputs" if dtype == torch.float32 else "")
                        + ", " + ("causal" if causal else "not causal")
                        + (", computes o, not (acc, m, l)" if is_stats else "")),
            "runs_ms": runs,
            **bound,
            "bound_rate": bound_rate,
            "share_of_bound": bound["bound_ms"] / ms,
            "tflop_per_s": bound["flop"] / ms / 1e9,
        }
        if variant == "simt" and twin is not None:
            # How much faster the tensor-core route is on the same inputs.
            rows[name]["tensor_core_speedup"] = ms / rows[twin]["ms"]
        if variant == "sm90_fp32":
            rows[name]["library_over_kernel"] = rows[name]["library_ms"] / ms
        torch.cuda.empty_cache()
        if key.startswith("gemma"):
            gemma_s += time.perf_counter() - t_row
    _reset_flash_counts(flash, before)
    ok = all(r["ran_on_variant"] for r in rows.values())
    return {"phase": "flash_timing", "ok": ok, "rows": rows, "gemma_seconds": gemma_s,
            "peaks": {"bf16_flop_per_s": BF16_FLOP_PER_S, "tf32_flop_per_s": TF32_FLOP_PER_S,
                      "fp32_flop_per_s": FP32_FLOP_PER_S, "hbm_bytes_per_s": HBM_BYTES_PER_S}}


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _ring_path(torch, flash, dev, fwd_seq: int, bwd_seq: int, heads=None, fp16=False) -> dict:
    """Ring attention over a one-rank sp mesh (the caller holds the process
    group), then K3 through ``flash_attention``: a bf16 path, forward at
    ``fwd_seq`` and forward + backward at ``bwd_seq``, causal and not; then
    an fp32 path (a learner computing attention in fp32), forward and K3 at
    half ``bwd_seq``; with ``fp16``, the forward at ``fwd_seq`` once more in
    fp16. The bf16 and fp16 paths must launch sm90 only, the fp32 path
    sm90_fp32 only, at every head dim (d 64, 128 and 256 on their own
    instances, others zero-padded). Each path's per-variant launch counts
    are set to 0 just before it and read right after; the comparisons
    follow."""
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
    if fp16:
        f16 = _qkv(torch, gen, dev, 1, fwd_seq, fwd_seq, h, hk, d, torch.float16)
        t0 = time.perf_counter()
        for causal in (False, True):
            path[("fp16", causal)] = ring("auto")(*f16, causal)
        sync()
        fp16_path_s = time.perf_counter() - t0
        fp16_launches = _flash_counts(flash)
        _reset_flash_counts(flash)
    # Each path's calls, all on the tensor-core kernel of its type.
    ring_calls, k3_calls = 4, 2
    none = {name: 0 for name in flash.stats_kernel.launches_by_variant}
    expected = {"flash_stats": {**none, "sm90": ring_calls}, "flash": {**none, "sm90": k3_calls}}
    fp32_expected = {"flash_stats": {**none, "sm90_fp32": 2}, "flash": {**none, "sm90_fp32": 2}}
    fp16_expected = {"flash_stats": {**none, "sm90": 2}, "flash": dict(none)}

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
        if fp16:
            got = path[("fp16", causal)]
            checks.append(yardstick(f"fp16 fwd {fwd_seq} {tag} vs einsum body", got,
                                    ring("einsum")(*f16, causal), f16, causal))
            # FLASH_TOL "sm90_vs_blockwise" against the arithmetic the path
            # ran: o within 1e-5 + 2 fp16 ulps ("o_fp16") plus the flip
            # allowance of the sm90 kernel's twin (p rounded to fp16) on the
            # card; the plain version on the CPU.
            stats = (flash.stats_blockwise_reference if dev.type == "cuda"
                     else flash.stats_reference)
            acc, _, l = stats(*f16, causal)
            flip = _flip_allowance(torch, f16[2], l, h).transpose(1, 2)
            checks.append({"check": f"fp16 fwd {fwd_seq} {tag} vs its twin (sm90_vs_blockwise)",
                           **_within(torch, got, flash._normalize(acc, l, torch.float16),
                                     atol=1e-5, ulps=2, extra=flip),
                           "outside_without_flip": _within(
                               torch, got, flash._normalize(acc, l, torch.float16), atol=1e-5,
                               ulps=2)["outside"]})
            del acc, l, flip
    on_card = dev.type == "cuda"
    ok = all(c["outside"] == 0 for c in checks)
    if on_card:
        ok = ok and launches == expected and fp32_launches == fp32_expected
        if fp16:
            ok = ok and fp16_launches == fp16_expected
    fp16_res = {}
    if fp16:
        fp16_res = {"fp16_launches": fp16_launches, "fp16_launches_expected": fp16_expected,
                    "fp16_path_seconds": fp16_path_s}
    return {
        "ok": ok,
        "launches": launches,
        "launches_expected": expected,
        "path_seconds": path_s,
        "steps_seconds": steps_s,
        "fp32_launches": fp32_launches,
        "fp32_launches_expected": fp32_expected,
        "fp32_path_seconds": fp32_path_s,
        **fp16_res,
        "checks": checks,
        "tolerance": (
            "bf16 outputs and grads: worst error <= 2x SDPA's (is_causal, enable_gqa; its own "
            "backward for the grads) worst error against the same comparator on the same "
            "inputs (bf16 p before P.V; the backward's D = rowsum(dO o) takes the forward's "
            "rounding); 'outside_2ulps' counts values outside the fixed 1e-5 + 2 bf16 ulps "
            "(outputs) or 2 ulps + 1e-5 max|want| (grads); K3 bit-equal to the ring's K2 + "
            "normalization; fp32 outputs within 1e-5 + 1e-4 |want|; fp16 outputs: the SDPA "
            "yardstick against the einsum body, and FLASH_TOL 'sm90_vs_blockwise' (1e-5 + 2 "
            "fp16 ulps plus the flip allowance) against the sm90 kernel's twin, p rounded to "
            "fp16"),
        "shapes": {"fwd": [1, fwd_seq, h, hk, d], "bwd": [1, bwd_seq, h, hk, d],
                   "fp32": [1, fp32_seq, h, hk, d],
                   "dtype": "bfloat16 (fp32 path: float32" + ("; fp16 path: float16, fwd"
                                                              if fp16 else "") + ")"},
    }


def _simt_path(torch, flash, dev, seq: int, heads) -> dict:
    """The simt kernel's path: q, k, v each cut from rows of d + 2 elements
    (``_qkv``'s "rowpad": strides TMA refuses, so the rules send every call
    to simt), bf16 at ``seq`` tokens and fp32 at half of it, through ring
    attention's per-rank body ``ring_attention(q, k, v, group)`` over a
    one-rank sp group (the caller holds the process group; the body hands
    the kernel the caller's strides, where ``ring_attention_sharded`` would
    make them contiguous), causal and not, then K3 through
    ``flash_attention``. The per-variant launch counts are set to 0 just
    before the path and read right after; each output is held against the
    einsum body and the plain version, and K3 bit-equal to the ring's K2 +
    normalization."""
    from torchstore_tpu_torch.ops import flash_attention
    from torchstore_tpu_torch.ops.ring_attention import ring_attention
    from torchstore_tpu_torch.parallel import make_mesh

    h, hk, d = heads
    group = make_mesh({"sp": 1}, dev.type).get_group("sp")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    sets = {"bf16": _qkv(torch, gen, dev, 1, seq, seq, h, hk, d, torch.bfloat16, "rowpad"),
            "fp32": _qkv(torch, gen, dev, 1, seq // 2, seq // 2, h, hk, d, torch.float32,
                         "rowpad")}
    routes = {name: flash.flash_variant(*qkv) for name, qkv in sets.items()}
    _reset_flash_counts(flash)
    t0 = time.perf_counter()
    out = {}
    for name, qkv in sets.items():
        for causal in (False, True):
            out[(name, causal)] = ring_attention(*qkv, group, causal=causal)
            out[(name, "k3", causal)] = flash_attention(*qkv, causal=causal)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    path_s = time.perf_counter() - t0
    launches = _flash_counts(flash)
    _reset_flash_counts(flash)
    none = {name: 0 for name in flash.stats_kernel.launches_by_variant}
    expected = {"flash_stats": {**none, "simt": 4}, "flash": {**none, "simt": 4}}
    checks = []
    for name, qkv in sets.items():
        tol = {} if name == "fp32" else {"atol": 1e-5, "ulps": 2}
        for causal in (False, True):
            tag = "causal" if causal else "full"
            got = out[(name, causal)]
            einsum = ring_attention(*qkv, group, causal=causal, impl="einsum")
            checks.append({"check": f"{name} fwd {tag} vs einsum body",
                           **_within(torch, got, einsum, **tol)})
            checks.append({"check": f"{name} fwd {tag} vs plain",
                           **_within(torch, got, flash.attention_reference(*qkv, causal), **tol)})
            k3 = out[(name, "k3", causal)]
            same = bool(torch.equal(k3, got))
            checks.append({"check": f"{name} K3 {tag} vs ring (K2 + normalization)",
                           **_within(torch, k3, got, **tol), "bit_equal": same})
            checks[-1]["outside"] += int(not same)
    ok = all(c["outside"] == 0 for c in checks)
    if dev.type == "cuda":
        ok = ok and launches == expected and set(routes.values()) == {"simt"}
    return {
        "ok": ok,
        "routes": routes,
        "launches": launches,
        "launches_expected": expected,
        "path_seconds": path_s,
        "checks": checks,
        "tolerance": "bf16 outputs within 1e-5 + 2 bf16 ulps, fp32 within 1e-5 + 1e-4 |want|, "
                     "of the einsum body and the plain version; K3 bit-equal to the ring's K2 "
                     "+ normalization",
        "shapes": {"bf16": [1, seq, h, hk, d], "fp32": [1, seq // 2, h, hk, d],
                   "layout": "q, k, v each cut from rows of d + 2 elements"},
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
        # Gemma-7B attention width: its bf16 calls run on the sm90 kernel's
        # d = 256 instance, its fp32 calls on the sm90_fp32 kernel's.
        t0 = time.perf_counter()
        gemma = _ring_path(torch, flash, dev, fwd_seq=8192, bwd_seq=4096, heads=GEMMA_HEADS)
        gemma["seconds"] = time.perf_counter() - t0
        # Phi-3-mini attention width (d = 96): every call on the d = 128
        # instances zero-padded; its forward once more in fp16.
        t0 = time.perf_counter()
        n = FLASH_TIMED_PHI3[1]
        phi3 = _ring_path(torch, flash, dev, fwd_seq=n, bwd_seq=n, heads=PHI3_HEADS, fp16=True)
        phi3["seconds"] = time.perf_counter() - t0
        # The same width with strides TMA refuses: the simt kernel's path.
        t0 = time.perf_counter()
        simt = _simt_path(torch, flash, dev, n, PHI3_HEADS)
        simt["seconds"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    res["gemma"] = gemma
    res["phi3"] = phi3
    res["simt"] = simt
    res["ok"] = res["ok"] and gemma["ok"] and phi3["ok"] and simt["ok"]
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



# --------------------------------------------------------------------------
# runtime: start-up, colocated volumes, auth, faults and the trace
# --------------------------------------------------------------------------

RUNTIME_SECRET = "chip-smoke-runtime-secret"
FAULT_LAYERS = 2  # the fault leg's depth: its demoted put moves the bytes in RPC frames
SMALL_OPS = 2000  # put+get pairs of the small-op leg
SMALL_BYTES = 4096
# The cast a forked actor child makes on the card: one per kind of the
# attention and MLP projections and a norm.
CHILD_CAST_SHAPES = (CAST_SHAPES["q/o"], CAST_SHAPES["k/v"], CAST_SHAPES["gate/up"],
                     CAST_SHAPES["norm"])


class RuntimeCastActor(_Actor):
    """Leg (a)'s forked child: it allocates on the card and casts with K1."""

    @_endpoint
    async def cast(self, seed: int, shapes: list, device: str) -> dict:
        import torch

        from torchstore_tpu_torch.ops import staging

        state = {"cuda_initialized_at_start": torch.cuda.is_initialized(),
                 "start_method": multiprocessing.get_start_method(allow_none=True)}
        dev = torch.device(device)
        xs = _seeded(torch, seed, shapes, dev)
        staging.cast_kernel.launches = 0
        outs = staging.cast_group(xs, torch.bfloat16)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return {**state, "launches": staging.cast_kernel.launches,
                "outs": [o.view(torch.int16).cpu() for o in outs]}


def _seeded(torch, seed: int, shapes, dev) -> list:
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return [torch.randn(tuple(s), generator=gen, device=dev) for s in shapes]


def _own_segments(pids) -> list:
    """The tst_shm_ segments whose creator is one of ``pids``."""
    from torchstore_tpu_torch.transport.shared_memory import PREFIX, SHM_DIR

    pids = set(pids)
    return [n for n in os.listdir(SHM_DIR)
            if n.startswith(PREFIX) and int(n[len(PREFIX):].split("_")[0]) in pids]


def _quantiles_us(samples: list) -> dict:
    ordered = sorted(samples)
    pick = lambda q: ordered[min(len(ordered) - 1, int(q * len(ordered)))] * 1e6  # noqa: E731
    return {"p50_us": pick(0.50), "p99_us": pick(0.99), "n": len(ordered)}


async def _small_ops(torch, tst, store_name: str, n: int = SMALL_OPS) -> dict:
    """``n`` put+get pairs of one 4 KiB CPU tensor: per-op latency."""
    x = torch.arange(SMALL_BYTES // 4, dtype=torch.float32)
    puts, gets = [], []
    for i in range(n):
        x[0] = float(i)
        t0 = time.perf_counter()
        await tst.put("small", x, store_name=store_name)
        t1 = time.perf_counter()
        got = await tst.get("small", store_name=store_name)
        gets.append(time.perf_counter() - t1)
        puts.append(t1 - t0)
        if got[0] != float(i):
            return {"ok": False, "wrong_value_at": i}
    return {"ok": True, "put": _quantiles_us(puts), "get": _quantiles_us(gets)}


async def _rogue_closed(host: str, port: int) -> bool:
    """A raw connection that skips the MAC (it sends a would-be frame where
    the MAC belongs) is closed before the server parses anything."""
    reader, writer = await asyncio.open_connection(host, port)
    try:
        hello = await asyncio.wait_for(reader.readexactly(20), 10)
        writer.write(b"\x00" * 64)
        await writer.drain()
        rest = await asyncio.wait_for(reader.read(16), 10)
        return hello[:4] == b"TSAU" and rest == b""
    except asyncio.TimeoutError:  # no challenge, or the frame was served
        return False
    except (ConnectionError, OSError):  # reset instead of closed: refused as well
        return True
    finally:
        writer.close()


async def _startup_leg(torch, dev) -> dict:
    """(a) initialize + shutdown twice under the forkserver and twice under
    spawn, then a forked actor child casting on the card with K1."""
    import torchstore_tpu_torch as tst
    from torchstore_tpu_torch.config import ENV_MP_CONTEXT
    from torchstore_tpu_torch.ops import staging
    from torchstore_tpu_torch.runtime import spawn_actors

    rows: dict = {}
    for method in ("forkserver", "spawn"):
        os.environ[ENV_MP_CONTEXT] = method
        for i in range(2):
            t0 = time.perf_counter()
            await tst.initialize(store_name="startup")
            t1 = time.perf_counter()
            await tst.shutdown("startup")
            rows[f"{method}_{i}"] = {"initialize_s": t1 - t0,
                                     "shutdown_s": time.perf_counter() - t1}
    os.environ.pop(ENV_MP_CONTEXT)
    shapes = [list(s) for s in CHILD_CAST_SHAPES]
    t0 = time.perf_counter()
    mesh = await spawn_actors(1, RuntimeCastActor, "tst_cast_child")
    rows["child_spawn_s"] = time.perf_counter() - t0
    try:
        child = await mesh.refs[0].cast.call_one(9753, shapes, str(dev))
    finally:
        await mesh.stop()
    mine = staging.cast_group(_seeded(torch, 9753, shapes, dev), torch.bfloat16)
    equal = all(torch.equal(c, m.view(torch.int16).cpu()) for c, m in zip(child["outs"], mine))
    planned = len(staging.plan_chunks(_seeded(torch, 9753, shapes, dev), torch.bfloat16))
    cuda = dev.type == "cuda"
    out = {"startup": rows,
           "child": {k: v for k, v in child.items() if k != "outs"} | {
               "bit_equal": equal, "planned_chunks": planned, "shapes": shapes}}
    out["ok"] = (equal and child["start_method"] == "forkserver"
                 and not child["cuda_initialized_at_start"]
                 and (not cuda or child["launches"] == planned))
    return out


async def _colocated_leg(torch, staging, layers: int, dev, geometry=None) -> dict:
    """(b) the Llama-3-8B round trip on a colocated, authenticated store:
    put, get and the steady state, value semantics, no connection to the
    store's own volume, rogue connections refused; then the small-op leg,
    colocated and against a spawned volume."""
    import torchstore_tpu_torch as tst
    from torchstore_tpu_torch.runtime import actors
    from torchstore_tpu_torch.workloads import llama_state_dict

    bf16 = torch.bfloat16
    cuda = dev.type == "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(1357)
    src = llama_state_dict(gen, device=dev, dtype=torch.float32, layers=layers,
                           **(geometry or {}))
    wire = 2 * sum(t.numel() for t in _leaves(src))
    targets = _bf16_zeros_like(torch, src, dev)
    chunks = len(staging.plan_chunks(list(_leaves(src)), bf16))

    def sync() -> None:
        if cuda:
            torch.cuda.synchronize(dev)

    def check(label: str) -> dict:
        bad = sum(1 for t, s in _pairs(targets, src) if not torch.equal(t, s.to(bf16)))
        return {"check": label, "bit_equal": not bad, "mismatched_tensors": bad}

    config = tst.StoreConfig(auth_secret=RUNTIME_SECRET, ici_enabled=False)
    staging.cast_kernel.launches = 0  # count this leg's launches only
    staging.cast_kernel.fallbacks = 0
    t0 = time.perf_counter()
    await tst.initialize(store_name="colo", colocated=True, config=config)
    out: dict = {"layers": layers, "wire_bytes": wire, "chunks": chunks,
                 "initialize_s": time.perf_counter() - t0}
    pids = [p.pid for p in multiprocessing.active_children()] + [os.getpid()]
    client = tst.client("colo")
    timings, launches, fallbacks, checks, pool = {}, {}, {}, [], {}

    async def step(name: str, coro, cast: bool) -> None:
        launched, fell_back = staging.cast_kernel.launches, staging.cast_kernel.fallbacks
        before = await _pool_counts(client)
        t0 = time.perf_counter()
        await coro
        sync()
        timings[name] = time.perf_counter() - t0
        after = await _pool_counts(client)
        pool[name] = {k: after[k] - before[k] for k in after if k != "warming"}
        if cast:
            launches[name] = staging.cast_kernel.launches - launched
            fallbacks[name] = staging.cast_kernel.fallbacks - fell_back

    try:
        await step("put", tst.put_state_dict("policy", src, transfer_dtype=bf16,
                                             store_name="colo"), True)
        await step("get", tst.get_state_dict("policy", targets, store_name="colo"), False)
        checks.append(check("get"))
        waited = {}
        for n, (put, get) in enumerate((("reput", "reget"), ("reput2", "reget2"))):
            for t in _leaves(src):
                t.add_(1.0)  # the training step, in place
            waited[put] = {"warm_s": await _wait_warm(client),
                           "pinned_s": await client.wait_pinned()}
            for t in _leaves(targets):
                t.zero_()
            sync()
            await step(put, tst.put_state_dict("policy", src, transfer_dtype=bf16,
                                               store_name="colo"), True)
            await step(get, tst.get_state_dict("policy", targets, store_name="colo"), False)
            checks.append(check(get))
        (volume,) = client._volume_refs.values()
        own_conns = [k for k in actors._conn_pools if k[1:] == (volume.actor.host,
                                                                 volume.actor.port)]
        # Value semantics: a CPU tensor and a dict, changed after their put.
        x = torch.arange(1 << 16, dtype=torch.float32)
        obj = {"step": 7, "lrs": [0.1, 0.2]}
        await tst.put("x_cpu", x, store_name="colo")
        await tst.put("obj", obj, store_name="colo")
        x.mul_(-1.0)
        obj["lrs"].append(9.9)
        values_kept = (
            torch.equal(await tst.get("x_cpu", store_name="colo"),
                        torch.arange(1 << 16, dtype=torch.float32))
            and await tst.get("obj", store_name="colo") == {"step": 7, "lrs": [0.1, 0.2]})
        if cuda:
            xc = torch.randn(1 << 20, device=dev, generator=gen)
            want = xc.clone()
            await tst.put("x_cuda", xc, store_name="colo")
            xc.zero_()
            values_kept = values_kept and torch.equal(
                (await tst.get("x_cuda", store_name="colo")).to(dev), want)
        controller = client.controller
        rogue = {"volume": await _rogue_closed(volume.actor.host, volume.actor.port),
                 "controller": await _rogue_closed(controller.host, controller.port)}
        # Small ops on the store that holds the model (its pool and the
        # client's attachments full), a few hundred: beside the fresh ones.
        small_loaded = await _small_ops(torch, tst, "colo", n=300)
    finally:
        await tst.shutdown("colo")
    await asyncio.sleep(0.5)
    alive = [p.pid for p in multiprocessing.active_children() if p.pid in pids]
    leaked = _own_segments(pids)
    # The small ops on fresh stores, colocated and with a spawned volume (the
    # same secret: auth on in both).
    small = {}
    for name, colocated in (("colocated", True), ("spawned", False)):
        await tst.initialize(store_name="small", colocated=colocated, config=config)
        small_pids = [p.pid for p in multiprocessing.active_children()] + [os.getpid()]
        try:
            small[name] = await _small_ops(torch, tst, "small")
        finally:
            await tst.shutdown("small")
        await asyncio.sleep(0.5)
        leaked += _own_segments(small_pids)
    small["colocated_holding_the_model"] = small_loaded
    out.update({
        "timings": timings,
        "gb_per_s": {k: wire / v / 1e9 for k, v in timings.items()},
        "waited": waited, "pool": pool, "checks": checks, "launches_by_step": launches,
        "cast_fallbacks": fallbacks, "launches": staging.cast_kernel.launches,
        "own_volume_connections": len(own_conns), "values_kept": values_kept,
        "rogue_closed": rogue,
        "small_ops": small,
        "processes_left": alive, "segments_left": leaked[:5],
    })
    out["ok"] = (all(c["bit_equal"] for c in checks)
                 and (not cuda or all(n == chunks for n in launches.values()))
                 and not any(fallbacks.values()) and not own_conns and values_kept
                 and all(rogue.values()) and all(r["ok"] for r in small.values())
                 and not alive and not leaked)
    return out


async def _fault_leg(torch, staging, layers: int, dev, geometry=None) -> dict:
    """(c) a spawned volume under injected faults: a put that lands on the
    demoted rung, a get retried once, a delayed notify; counters under the
    reference's names, nothing armed after."""
    import torchstore_tpu_torch as tst
    from torchstore_tpu_torch import faults
    from torchstore_tpu_torch.observability import metrics
    from torchstore_tpu_torch.workloads import llama_state_dict

    bf16 = torch.bfloat16
    cuda = dev.type == "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(8642)
    src = llama_state_dict(gen, device=dev, dtype=torch.float32, layers=layers,
                           **(geometry or {}))
    targets = _bf16_zeros_like(torch, src, dev)
    wire = 2 * sum(t.numel() for t in _leaves(src))
    chunks = len(staging.plan_chunks(list(_leaves(src)), bf16))

    def counters() -> dict:
        c = metrics.counter
        return {"put_retries_rpc": c("ts_client_put_retries_total").value(transport="rpc"),
                "put_retries": c("ts_client_put_retries_total").total(),
                "fetch_retries": c("ts_client_fetch_retries_total").total(),
                "failovers_put": c("ts_client_failovers_total").value(op="put"),
                "failovers_get": c("ts_client_failovers_total").value(op="get"),
                "k1": staging.cast_kernel.launches,
                "fallbacks": staging.cast_kernel.fallbacks}

    def check(label: str) -> dict:
        bad = sum(1 for t, s in _pairs(targets, src) if not torch.equal(t, s.to(bf16)))
        return {"check": label, "bit_equal": not bad, "mismatched_tensors": bad}

    async def timed(coro) -> float:
        t0 = time.perf_counter()
        await coro
        if cuda:
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    staging.cast_kernel.launches = 0
    staging.cast_kernel.fallbacks = 0
    # The demoted put stays on the rpc rung that earlier records measured
    # (shm -> rpc): the bulk rung's own demotion is the bulk phase's.
    await tst.initialize(store_name="faults", config=tst.StoreConfig(bulk_tcp_enabled=False))
    pids = [p.pid for p in multiprocessing.active_children()] + [os.getpid()]
    client = tst.client("faults")
    rows, checks = {}, []
    try:
        before = counters()
        await tst.inject_fault("volume.put", "raise", count=1, store_name="faults")
        rows["demoted_put_s"] = await timed(tst.put_state_dict(
            "policy", src, transfer_dtype=bf16, store_name="faults"))
        put_moved = _delta(counters(), before)
        before = counters()
        await tst.inject_fault("volume.get", "raise", count=1, store_name="faults")
        rows["retried_get_s"] = await timed(tst.get_state_dict("policy", targets,
                                                               store_name="faults"))
        get_moved = _delta(counters(), before)
        checks.append(check("retried get"))
        for t in _leaves(src):
            t.add_(1.0)
        await tst.inject_fault("controller.notify", "delay", delay_ms=200, scope="controller",
                               store_name="faults")
        rows["delayed_put_s"] = await timed(tst.put_state_dict(
            "policy", src, transfer_dtype=bf16, store_name="faults"))
        cleared = await tst.clear_faults(store_name="faults")
        rows["get_after_clear_s"] = await timed(tst.get_state_dict("policy", targets,
                                                                   store_name="faults"))
        checks.append(check("get after the delayed put"))
        (volume,) = client._volume_refs.values()
        armed = {"client": faults.armed(),
                 "controller": await client.controller.list_faults.call_one(),
                 "volume": await volume.actor.list_faults.call_one()}
    finally:
        await tst.shutdown("faults")
    await asyncio.sleep(0.5)
    alive = [p.pid for p in multiprocessing.active_children() if p.pid in pids]
    leaked = _own_segments(pids)
    out = {"layers": layers, "wire_bytes": wire, "chunks": chunks, "seconds": rows,
           "gb_per_s": {"demoted_put": wire / rows["demoted_put_s"] / 1e9},
           "put_counters": put_moved, "get_counters": get_moved, "checks": checks,
           "cleared": cleared, "armed_after": armed, "launches": staging.cast_kernel.launches,
           "processes_left": alive, "segments_left": leaked[:5]}
    out["ok"] = (all(c["bit_equal"] for c in checks)
                 and put_moved["put_retries_rpc"] == 1 and put_moved["put_retries"] == 1
                 and put_moved["failovers_put"] == 1
                 and get_moved["fetch_retries"] == 1 and get_moved["failovers_get"] == 1
                 and (not cuda or put_moved["k1"] == chunks)
                 and put_moved["fallbacks"] == 0
                 and rows["delayed_put_s"] >= 0.2
                 and not any(armed.values()) and not alive and not leaked)
    return out


TRACE_WARM = ("reput", "reget", "reput2", "reget2", "republish", "repull")


async def _trace_leg(torch, staging, layers: int, dev, geometry=None) -> dict:
    """(d), in a process started with TORCHSTORE_TORCH_TRACE set: a spawned
    volume's put / get / reput / reget / reput2 / reget2, then the device
    rung in process (register, pull, republish, repull); after shutdown
    the merged trace, its cross-process links, and the spans per warm
    step."""
    import torchstore_tpu_torch as tst
    from torchstore_tpu_torch.observability import tracing
    from torchstore_tpu_torch.workloads import llama_state_dict

    bf16 = torch.bfloat16
    cuda = dev.type == "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    src = llama_state_dict(gen, device=dev, dtype=torch.float32, layers=layers,
                           **(geometry or {}))
    targets = _bf16_zeros_like(torch, src, dev)
    wire = 2 * sum(t.numel() for t in _leaves(src))
    chunks = len(staging.plan_chunks(list(_leaves(src)), bf16))
    windows, launches, checks = {}, {}, []

    def sync() -> None:
        if cuda:
            torch.cuda.synchronize(dev)

    def check(label: str) -> dict:
        bad = sum(1 for t, s in _pairs(targets, src) if not torch.equal(t, s.to(bf16)))
        return {"check": label, "bit_equal": not bad, "mismatched_tensors": bad}

    async def step(name: str, coro) -> None:
        launched = staging.cast_kernel.launches
        t0 = time.perf_counter()
        await coro
        sync()
        windows[name] = (t0, time.perf_counter())
        launches[name] = staging.cast_kernel.launches - launched

    def clear_targets() -> None:
        for t in _leaves(targets):
            t.zero_()
        sync()

    staging.cast_kernel.launches = 0
    staging.cast_kernel.fallbacks = 0
    await tst.initialize(store_name="traced")
    client = tst.client("traced")
    try:
        await step("put", tst.put_state_dict("policy", src, transfer_dtype=bf16,
                                             store_name="traced"))
        await step("get", tst.get_state_dict("policy", targets, store_name="traced"))
        checks.append(check("get"))
        for put, get in (("reput", "reget"), ("reput2", "reget2")):
            for t in _leaves(src):
                t.add_(1.0)
            await _wait_warm(client)
            await client.wait_pinned()
            clear_targets()
            await step(put, tst.put_state_dict("policy", src, transfer_dtype=bf16,
                                               store_name="traced"))
            await step(get, tst.get_state_dict("policy", targets, store_name="traced"))
            checks.append(check(get))
        clear_targets()
        await step("register", tst.put_state_dict(DD_KEY, src, transfer_dtype=bf16,
                                                  direct=True, store_name="traced"))
        await step("pull", tst.get_state_dict(DD_KEY, targets, direct=True,
                                              store_name="traced"))
        checks.append(check("pull"))
        for t in _leaves(src):
            t.add_(1.0)
        clear_targets()
        await step("republish", tst.put_state_dict(DD_KEY, src, transfer_dtype=bf16,
                                                   direct=True, store_name="traced"))
        await step("repull", tst.get_state_dict(DD_KEY, targets, direct=True,
                                                store_name="traced"))
        checks.append(check("repull"))
        rung = tst.direct_sync_stats(DD_KEY, store_name="traced")["rung"]
    finally:
        await tst.shutdown("traced")
    merged = tracing.collect_trace()
    with open(merged["path"]) as f:
        events = json.load(f)
    me = os.getpid()
    spans = [e for e in events if e.get("ph") == "X"]
    labels = {e["pid"]: e["args"]["name"] for e in events if e.get("ph") == "M"}
    client_ids = {e["args"]["span_id"] for e in spans
                  if e["pid"] == me and "span_id" in e.get("args", {})}
    rpcs = [e for e in spans if e["pid"] != me and e["name"].startswith("rpc/")]
    by_role: dict = {"controller": set(), "volume": set()}
    for e in rpcs:
        role = "controller" if "controller" in labels.get(e["pid"], "") else "volume"
        by_role[role].add(e["args"].get("trace_id"))
    ops = [e for e in spans if e["pid"] == me and e["name"] in ("put_batch", "get_batch")]
    unlinked = {
        "put_batch": sum(1 for e in ops if e["name"] == "put_batch"
                         and not all(e["args"]["trace_id"] in by_role[r] for r in by_role)),
        "get_batch": sum(1 for e in ops if e["name"] == "get_batch"
                         and e["args"]["trace_id"] not in by_role["volume"]),
    }
    ours = {e["args"]["trace_id"] for e in ops}
    orphans = sum(1 for e in rpcs if e["args"].get("trace_id") in ours
                  and e["args"].get("parent_id") not in client_ids)
    per_step: dict = {}
    for name in TRACE_WARM:
        lo, hi = windows[name]
        rows: dict = {}
        for e in spans:
            if lo * 1e6 <= e["ts"] <= hi * 1e6:
                row = rows.setdefault(e["name"], [0, 0.0])
                row[0] += 1
                row[1] += e["dur"] / 1e3
        per_step[name] = {k: {"count": n, "total_ms": ms} for k, (n, ms) in sorted(rows.items())}
    repull = per_step["repull"]
    out = {
        "layers": layers, "wire_bytes": wire, "chunks": chunks, "rung": rung,
        "seconds": {k: hi - lo for k, (lo, hi) in windows.items()},
        "launches_by_step": launches, "checks": checks,
        "trace": {"files": len(merged["files"]), "events": merged["events"],
                  "trace_ids": len(merged["trace_ids"]), "client_ops": len(ops),
                  "controller_rpc_traces": len(by_role["controller"]),
                  "volume_rpc_traces": len(by_role["volume"]),
                  "unlinked": unlinked, "rpc_spans_without_client_parent": orphans},
        "warm_steps": per_step,
        "repull_split_ms": {k.split("/", 1)[1]: v["total_ms"] for k, v in repull.items()
                            if k.startswith("direct_pull_device/")},
    }
    casting = ("put", "reput", "reput2", "register", "republish")
    out["ok"] = (all(c["bit_equal"] for c in checks) and bool(ops)
                 and not any(unlinked.values())
                 and orphans == 0 and merged["events"] > 0
                 and (not cuda or (rung == "device"
                                   and all(launches[s] == chunks for s in casting)
                                   and set(out["repull_split_ms"]) == {"open", "land",
                                                                       "generation"})))
    return out


def _run_trace_child(spec: dict) -> dict:
    """Start this script as a traced user process (``--trace-leg``) and
    read its result; the trace files live under ``spec["dir"]``."""
    env = dict(os.environ)
    env["TORCHSTORE_TORCH_TRACE"] = os.path.join(spec["dir"], "trace.json")
    env.pop("TORCHSTORE_TORCH_TRACE_RUN", None)
    out_path = os.path.join(spec["dir"], "result.json")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--trace-leg",
                           json.dumps({**spec, "out": out_path})],
                          env=env, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0 or not os.path.exists(out_path):
        return {"ok": False, "rc": proc.returncode, "stderr": proc.stderr[-3000:]}
    with open(out_path) as f:
        return json.load(f)


def trace_leg_main(spec_json: str) -> int:
    """The traced process of the runtime phase's leg (d)."""
    import torch

    from torchstore_tpu_torch.ops import staging

    spec = json.loads(spec_json)
    dev = torch.device(spec["device"])
    res = asyncio.run(_trace_leg(torch, staging, spec["layers"], dev, spec.get("geometry")))
    with open(spec["out"], "w") as f:
        json.dump(res, f)
    return 0 if res["ok"] else 1


async def _runtime_path(torch, staging, layers: int, trace_layers: int, dev,
                        geometry=None, trace_dir=None) -> dict:
    """The four legs of the runtime phase; see the module docstring."""
    from torchstore_tpu_torch import config as config_mod
    from torchstore_tpu_torch.config import ENV_AUTH_SECRET

    legs: dict = {}
    legs["a_startup"] = await _startup_leg(torch, dev)
    try:
        legs["b_colocated"] = await _colocated_leg(torch, staging, layers, dev, geometry)
    finally:  # auth is per process: the phases after run without it
        os.environ.pop(ENV_AUTH_SECRET, None)
        config_mod._default_config = None
    legs["c_faults"] = await _fault_leg(torch, staging, min(FAULT_LAYERS, layers), dev, geometry)
    if dev.type == "cuda":
        torch.cuda.empty_cache()  # the traced process needs the card's memory
    legs["d_trace"] = _run_trace_child({"device": str(dev), "layers": trace_layers,
                                        "geometry": geometry, "dir": trace_dir})
    launches = sum(legs[k]["launches"] for k in ("b_colocated", "c_faults"))
    launches += sum(legs["d_trace"].get("launches_by_step", {}).values())
    return {"legs": legs, "launches": launches, "ok": all(leg.get("ok") for leg in legs.values())}


def phase_runtime(torch, staging) -> dict:
    import tempfile

    dev = torch.device("cuda", 0)
    layers, sizing = plan_layers()
    trace_layers = min(layers, plan_direct_device_layers(torch, dev)[0])
    if layers < LAYERS or trace_layers < LAYERS:
        emit({"reduced": {"runtime_layers": layers, "trace_layers": trace_layers}, **sizing})
    layers = time_capped("runtime_layers", layers)
    trace_layers = time_capped("trace_layers", trace_layers)
    emit({"reduced": {"fault_layers": FAULT_LAYERS, "of": LAYERS,
                      "why": "the demoted put moves the bytes in RPC frames"}})
    with tempfile.TemporaryDirectory() as tdir:
        res = asyncio.run(_runtime_path(torch, staging, layers, trace_layers, dev,
                                        trace_dir=tdir))
    res["phase"] = "runtime"
    res["nvidia_smi"] = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    return res


# --------------------------------------------------------------------------
# bulk: a cross-host store on one box, over the bulk TCP rung
# --------------------------------------------------------------------------

BULK_SECRET = "chip-smoke-bulk-secret"
BULK_BIND = "127.0.0.2"  # every listener of the phase: nothing on 127.0.0.1
BULK_VOLUME_HOST = "tst-bulk-volume-host"  # the volume's emulated host
BULK_STEPS = (("put", "get"), ("reput", "reget"), ("reput2", "reget2"))
BULK_WARM = ("reput", "reget", "reput2", "reget2")
BULK_RUNGS = ("shm", "bulk", "rpc")


def _tcp_listeners(pids) -> set:
    """(ip, port) of every listening IPv4 TCP socket the processes hold."""
    inodes = set()
    for pid in pids:
        try:
            for fd in os.listdir(f"/proc/{pid}/fd"):
                try:
                    link = os.readlink(f"/proc/{pid}/fd/{fd}")
                except OSError:
                    continue
                if link.startswith("socket:["):
                    inodes.add(link[8:-1])
        except OSError:
            continue
    out = set()
    with open("/proc/net/tcp") as f:
        next(f)
        for line in f:
            parts = line.split()
            if parts[3] != "0A" or parts[9] not in inodes:  # 0A: LISTEN
                continue
            ip_hex, port_hex = parts[1].split(":")
            out.add((".".join(str(int(ip_hex[i:i + 2], 16)) for i in (6, 4, 2, 0)),
                     int(port_hex, 16)))
    return out


def _rung_ops() -> dict:
    """This process's transfers so far, by (rung, op)."""
    from torchstore_tpu_torch.observability import metrics

    c = metrics.counter("ts_transport_ops_total")
    return {f"{r}_{op}": c.value(transport=r, op=op) for r in BULK_RUNGS for op in ("put", "get")}


def _rungs_of(moved: dict, op: str) -> list:
    return sorted(r for r in BULK_RUNGS if moved[f"{r}_{op}"])


def _striped_counts() -> dict:
    from torchstore_tpu_torch.observability import metrics

    c = metrics.counter("ts_bulk_striped_transfers_total")
    return {"put": c.value(direction="put"), "get": c.value(direction="get")}


def _series_total(snapshot: dict, name: str) -> float:
    return sum(s["value"] for s in snapshot.get(name, {}).get("series", []))


def _llama_params(layers: int) -> int:
    from torchstore_tpu_torch.workloads import LLAMA3_8B, llama_shapes

    return sum(math.prod(s) for s in _leaves(llama_shapes(**{**LLAMA3_8B, "layers": layers})))


def plan_bulk_layers(torch, dev) -> tuple[int, dict]:
    """Depth that fits: on the card the fp32 source, its bf16 cast during a
    put and the bf16 targets (8 bytes a parameter), beside what the card
    holds already; on the host the volume's entries and the fresh buffers
    a reput lands in before they replace them (4 bytes a parameter)."""
    free, total = torch.cuda.mem_get_info(dev)
    card_budget = 0.9 * free
    host_budget = 0.8 * mem_available_bytes()
    layers = LAYERS
    while layers > 1 and (8 * _llama_params(layers) > card_budget
                          or 4 * _llama_params(layers) > host_budget):
        layers -= 1
    return layers, {"card_budget_bytes": int(card_budget), "card_needed_bytes":
                    8 * _llama_params(layers), "host_budget_bytes": int(host_budget),
                    "host_needed_bytes": 4 * _llama_params(layers)}


async def _bulk_path(torch, staging, layers: int, dev, geometry=None,
                     fault_layers: int = FAULT_LAYERS) -> dict:
    """The Llama-3-8B state dict (fp32 on the card) put, got, reput, regot
    twice into the same bf16 targets on the card through a volume that
    reports another host (its own TORCHSTORE_TORCH_HOSTNAME), every
    listener on 127.0.0.2, auth on: the ladder picks the bulk rung unforced.
    Then the fault leg: a put whose first bulk frame raises lands on rpc."""
    import torchstore_tpu_torch as tst
    from torchstore_tpu_torch import config as config_mod
    from torchstore_tpu_torch.config import ENV_AUTH_SECRET, ENV_BIND_HOST, ENV_HOSTNAME
    from torchstore_tpu_torch.observability import metrics
    from torchstore_tpu_torch.transport.factory import auto_select, demotion_ladder
    from torchstore_tpu_torch.workloads import llama_state_dict

    bf16 = torch.bfloat16
    cuda = dev.type == "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(2468)
    src = llama_state_dict(gen, device=dev, dtype=torch.float32, layers=layers,
                           **(geometry or {}))
    targets = _bf16_zeros_like(torch, src, dev)
    n_params = sum(t.numel() for t in _leaves(src))
    wire = 2 * n_params
    chunks = len(staging.plan_chunks(list(_leaves(src)), bf16))

    def check(label: str, tgt=None, source=None) -> dict:
        bad = sum(1 for t, s in _pairs(targets if tgt is None else tgt,
                                       src if source is None else source)
                  if not torch.equal(t.view(torch.int16), s.to(bf16).view(torch.int16)))
        return {"check": label, "bit_equal": not bad, "mismatched_tensors": bad}

    def sync() -> None:
        if cuda:
            torch.cuda.synchronize(dev)

    staging.cast_kernel.launches = 0  # count the bulk path's launches only
    staging.cast_kernel.fallbacks = 0
    children0 = {p.pid for p in multiprocessing.active_children()}
    mine0 = _tcp_listeners([os.getpid()])
    os.environ[ENV_BIND_HOST] = BULK_BIND
    t0 = time.perf_counter()
    await tst.initialize(store_name="bulk", config=tst.StoreConfig(auth_secret=BULK_SECRET),
                         volume_env_fn=lambda rank: {ENV_HOSTNAME: BULK_VOLUME_HOST})
    out: dict = {"layers": layers, "tensors": sum(1 for _ in _leaves(src)), "params": n_params,
                 "wire_bytes": wire, "chunks": chunks, "initialize_s": time.perf_counter() - t0}
    pids = [p.pid for p in multiprocessing.active_children() if p.pid not in children0]
    client = tst.client("bulk")
    steps: dict = {}
    checks = []
    try:
        await client._ensure_setup()
        (volume,) = client._volume_refs.values()
        out["choice"] = {"auto": auto_select(volume, client.config).value,
                         "ladder": [r.value for r in demotion_ladder(volume, client.config)],
                         "forced": volume.transport_type, "volume_host": volume.hostname,
                         "same_host": volume.is_same_host()}
        out["listeners"] = sorted(_tcp_listeners(pids)
                                  | (_tcp_listeners([os.getpid()]) - mine0))
        for n, (put, get) in enumerate(BULK_STEPS):
            if n:
                for t in _leaves(src):
                    t.add_(1.0)  # the training step, in place
            for name, coro_fn, cast in ((put, lambda: tst.put_state_dict(
                    "policy", src, transfer_dtype=bf16, store_name="bulk"), True),
                    (get, lambda: tst.get_state_dict("policy", targets, store_name="bulk"),
                     False)):
                if not cast:
                    for t in _leaves(targets):
                        t.zero_()
                sync()
                ops0, stripes0, bulk0 = _rung_ops(), _striped_counts(), client.bulk_stats()
                k1 = staging.cast_kernel.launches, staging.cast_kernel.fallbacks
                mem0 = torch.cuda.memory_allocated(dev) if cuda else 0
                t0 = time.perf_counter()
                await coro_fn()
                sync()
                seconds = time.perf_counter() - t0
                moved = _delta(_rung_ops(), ops0)
                bulk1 = client.bulk_stats()
                steps[name] = {
                    "s": seconds, "gb_per_s": wire / seconds / 1e9,
                    "rung": _rungs_of(moved, "put" if cast else "get"),
                    "ops": {k: v for k, v in moved.items() if v},
                    "dials": bulk1["dials"] - bulk0["dials"],
                    "striped": _delta(_striped_counts(), stripes0),
                    "split": {k: bulk1[k] - bulk0[k] for k in (
                        "recv_s", "h2d_wait_s", "card_sync_s", "d2h_wait_s", "send_s",
                        "recv_bytes", "sent_bytes")},
                }
                if cast:
                    steps[name]["launches"] = staging.cast_kernel.launches - k1[0]
                    steps[name]["fallbacks"] = staging.cast_kernel.fallbacks - k1[1]
                else:
                    steps[name]["card_bytes_left"] = (
                        torch.cuda.memory_allocated(dev) - mem0 if cuda else 0)
                    checks.append(check(f"buffered {name}"))
        # The fault leg: the client's first bulk frame raises, so the put
        # demotes one rung (rpc); cleared, the get reads it back over bulk.
        fgen = torch.Generator(device=dev)
        fgen.manual_seed(1357)
        fsrc = llama_state_dict(fgen, device=dev, dtype=torch.float32, layers=fault_layers,
                                **(geometry or {}))
        ftargets = _bf16_zeros_like(torch, fsrc, dev)
        retries = metrics.counter("ts_client_put_retries_total")
        before = {"rpc": retries.value(transport="rpc"), "bulk": retries.value(transport="bulk"),
                  "failovers": metrics.counter("ts_client_failovers_total").value(op="put"),
                  **_rung_ops()}
        await tst.inject_fault("bulk.send_frame", "raise", count=1, scope="client",
                               store_name="bulk")
        t0 = time.perf_counter()
        await tst.put_state_dict("fault", fsrc, transfer_dtype=bf16, store_name="bulk")
        sync()
        fault = {"demoted_put_s": time.perf_counter() - t0, "layers": fault_layers,
                 "retries_rpc": retries.value(transport="rpc") - before["rpc"],
                 "retries_bulk": retries.value(transport="bulk") - before["bulk"],
                 "failovers_put": metrics.counter("ts_client_failovers_total").value(op="put")
                 - before["failovers"]}
        # The batch lands on rpc; its commit marker, put after, on bulk.
        fault["put_ops"] = {k: v for k, v in _delta(_rung_ops(), {
            k: before[k] for k in _rung_ops()}).items() if v}
        fault["cleared"] = await tst.clear_faults(store_name="bulk")
        ops0 = _rung_ops()
        await tst.get_state_dict("fault", ftargets, store_name="bulk")
        sync()
        fault["get_rungs"] = _rungs_of(_delta(_rung_ops(), ops0), "get")
        fault["check"] = check("after the fault", ftargets, fsrc)
        del fsrc, ftargets
        vstats = await volume.actor.stats.call_one()
        out["volume_bulk"] = vstats.get("bulk", {})
        out["volume_native_calls"] = _series_total(vstats["metrics"], "ts_native_calls_total")
        out["client_bulk"] = client.bulk_stats()
    finally:
        await tst.shutdown("bulk")
        os.environ.pop(ENV_BIND_HOST, None)
        os.environ.pop(ENV_AUTH_SECRET, None)  # auth is per process: later phases run without
        config_mod._default_config = None
    await asyncio.sleep(0.5)
    alive = [p.pid for p in multiprocessing.active_children() if p.pid in pids]
    leaked = _own_segments(pids + [os.getpid()])
    launches = sum(s.get("launches", 0) for s in steps.values())
    warm = {k: steps[k] for k in BULK_WARM}
    out.update({
        "steps": steps, "checks": checks, "fault": fault, "launches": launches,
        "warm_get_split": steps["reget2"]["split"],
        "peak_device_bytes": torch.cuda.max_memory_allocated(dev) if cuda else 0,
        "processes_left": alive, "segments_left": leaked[:5],
    })
    stripes = {d: sum(s["striped"][d] for s in steps.values()) for d in ("put", "get")}
    out["striped"] = stripes
    out["ok"] = bool(
        out["choice"]["auto"] == "bulk" and out["choice"]["forced"] is None
        and not out["choice"]["same_host"]
        and all(s["rung"] == ["bulk"] for s in steps.values())
        and all(c["bit_equal"] for c in checks)
        and all(steps[p]["fallbacks"] == 0 for p, _ in BULK_STEPS)
        and (not cuda or all(steps[p]["launches"] == chunks for p, _ in BULK_STEPS))
        and all(s["dials"] == 0 for s in warm.values())
        and stripes["put"] >= 1 and stripes["get"] >= 1
        and out["volume_native_calls"] > 0
        and all(steps[g]["card_bytes_left"] <= 0 for _, g in BULK_STEPS)
        and {ip for ip, _ in out["listeners"]} == {BULK_BIND}
        and fault["retries_rpc"] == 1 and fault["failovers_put"] == 1
        and fault["put_ops"].get("rpc_put") == 1 and fault["get_rungs"] == ["bulk"]
        and fault["check"]["bit_equal"]
        and not alive and not leaked
    )
    return out


def phase_bulk(torch, staging) -> dict:
    dev = torch.device("cuda", 0)
    layers, sizing = plan_bulk_layers(torch, dev)
    if layers < LAYERS:
        emit({"reduced": {"bulk_layers": layers}, **sizing})
    layers = time_capped("bulk_layers", layers)
    emit({"reduced": {"bulk_fault_layers": FAULT_LAYERS, "of": LAYERS,
                      "why": "the demoted put moves the bytes in RPC frames"}})
    res = asyncio.run(_bulk_path(torch, staging, layers, dev))
    res["phase"] = "bulk"
    res["sizing"] = sizing
    res["nvidia_smi"] = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    return res


# --------------------------------------------------------------------------
# landing: host-to-host copies, the landing pool against the native batch
# --------------------------------------------------------------------------

LANDING_ORDER = ("pool", "native", "native", "pool")


def phase_landing(torch) -> dict:
    """The host landing a get into host targets runs, at main's sizes: the
    pool path of ``landing.land_async`` (TORCHSTORE_TORCH_USE_NATIVE off)
    against ``native.copy_batch`` over the same row blocks and threads."""
    from torchstore_tpu_torch import native
    from torchstore_tpu_torch.config import ENV_USE_NATIVE
    from torchstore_tpu_torch.observability import metrics
    from torchstore_tpu_torch.transport import landing
    from torchstore_tpu_torch.workloads import LLAMA3_8B, llama_shapes

    budget = 0.6 * mem_available_bytes()
    layers = LAYERS
    while layers > 1 and 4 * _llama_params(layers) > budget:  # bf16 source + destination
        layers -= 1
    if layers < LAYERS:
        emit({"reduced": {"landing_layers": layers}, "host_budget_bytes": int(budget)})
    dev = torch.device("cuda", 0)
    shapes = [tuple(s) for s in _leaves(llama_shapes(**{**LLAMA3_8B, "layers": layers}))]
    gen = torch.Generator(device=dev)
    srcs = []
    for i, shape in enumerate(shapes):
        gen.manual_seed(24680 + i)
        srcs.append(torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16).cpu())
    dsts = [torch.zeros_like(x) for x in srcs]
    nbytes = sum(x.numel() * x.element_size() for x in srcs)
    threads = landing.configured_threads()
    dst_addrs, src_addrs, lens = [], [], []
    for d, x in zip(dsts, srcs):
        n = x.numel() * x.element_size()
        for off in range(0, n, landing.CHUNK_BYTES):
            dst_addrs.append(d.data_ptr() + off)
            src_addrs.append(x.data_ptr() + off)
            lens.append(min(landing.CHUNK_BYTES, n - off))
    calls = metrics.counter("ts_native_calls_total")
    saved = os.environ.get(ENV_USE_NATIVE)
    rows, ok = [], True
    try:
        for mode in LANDING_ORDER:
            for d in dsts:
                d.zero_()
            c0 = calls.total()
            if mode == "pool":
                os.environ[ENV_USE_NATIVE] = "0"
                t0 = time.perf_counter()
                asyncio.run(landing.land_async(list(zip(dsts, srcs))))
                s = time.perf_counter() - t0
                os.environ.pop(ENV_USE_NATIVE)
            else:
                t0 = time.perf_counter()
                native.copy_batch(dst_addrs, src_addrs, lens, threads)
                s = time.perf_counter() - t0
            native_calls = calls.total() - c0
            equal = all(torch.equal(d, x) for d, x in zip(dsts, srcs))
            ok = ok and equal and native_calls == (0 if mode == "pool" else 1)
            rows.append({"mode": mode, "s": s, "gb_per_s": nbytes / s / 1e9,
                         "bit_equal": equal, "native_calls": native_calls})
    finally:
        if saved is None:
            os.environ.pop(ENV_USE_NATIVE, None)
        else:
            os.environ[ENV_USE_NATIVE] = saved
    return {"phase": "landing", "ok": ok, "layers": layers, "tensors": len(shapes),
            "bytes": nbytes, "row_blocks": len(lens), "threads": threads, "rows": rows,
            "nvidia_smi": sh(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"])}


# --------------------------------------------------------------------------
# spmd: four torchrun-style ranks on two emulated hosts
# --------------------------------------------------------------------------

SPMD_WORLD, SPMD_LOCAL = 4, 2  # ranks 0-1: the trainer host; 2-3: the generator host
SPMD_SECRET = "chip-smoke-spmd-secret"
SPMD_STEPS = (("put", "get"), ("reput", "reget"))
SPMD_TIMEOUT_S = 900


def _spmd_leaf(torch, index: int, shape, dev):
    """Leaf ``index`` of the phase's state dict, fp32, from a seed of its
    own: every rank makes the same tensor without holding the model."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(97531 + index)
    return torch.randn(tuple(shape), generator=gen, device=dev, dtype=torch.float32)


def _spmd_env(rank: int, port: int) -> dict:
    host = rank // SPMD_LOCAL
    return {"RANK": str(rank), "LOCAL_RANK": str(rank % SPMD_LOCAL),
            "WORLD_SIZE": str(SPMD_WORLD), "LOCAL_WORLD_SIZE": str(SPMD_LOCAL),
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
            "TORCHSTORE_TORCH_AUTH_SECRET": SPMD_SECRET,
            "TORCHSTORE_TORCH_ADVERTISE_HOST": "127.0.0.1",
            "TORCHSTORE_TORCH_HOSTNAME": f"tst-spmd-{'trainer' if host == 0 else 'generator'}"}


async def _spmd_rank(torch, rank: int, spec: dict) -> dict:
    """One rank: a trainer rank (0, 1) puts its Shard(0) half of the fp32
    state dict on the card; a generator rank (2, 3) gets its
    tensor-parallel bf16 half on the card, from the other host's volumes."""
    import torchstore_tpu_torch as tst
    from torchstore_tpu_torch.ops import staging
    from torchstore_tpu_torch.workloads import LLAMA3_8B, llama_shapes

    dev = torch.device(spec["device"])
    cuda = dev.type == "cuda"
    bf16 = torch.bfloat16
    geo = {**LLAMA3_8B, **(spec.get("geometry") or {}), "layers": spec["layers"]}
    leaves = list(_flat(llama_shapes(**geo)))  # (path, kind, shape)
    trainer = rank < SPMD_LOCAL
    coord = rank % SPMD_LOCAL

    def sync() -> None:
        if cuda:
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    await tst.initialize_spmd(store_name="spmd")
    out: dict = {"rank": rank, "role": "trainer" if trainer else "generator",
                 "initialize_s": time.perf_counter() - t0, "steps": {}}
    if trainer:
        shards = {}
        for i, (path, _, shape) in enumerate(leaves):
            sl = _layout(tst, tuple(shape), 0, SPMD_LOCAL)[coord]
            shards[path] = tst.Shard(_spmd_leaf(torch, i, shape, dev)[sl.box.to_index()].clone(),
                                     sl)
        sync()
        out["chunks"] = len(staging.plan_chunks([s.data for s in shards.values()], bf16))
        out["wire_bytes"] = 2 * sum(s.data.numel() for s in shards.values())
        tree = _nest(shards)
    else:
        targets = {path: tst.Shard(torch.zeros(sl.local_shape, dtype=bf16, device=dev), sl)
                   for path, kind, shape in leaves
                   for sl in [_layout(tst, tuple(shape), TP_DIM[kind], SPMD_LOCAL)[coord]]}
        out["wire_bytes"] = 2 * sum(s.data.numel() for s in targets.values())
        tree = _nest(targets)
    staging.cast_kernel.launches = 0
    staging.cast_kernel.fallbacks = 0
    for n, (put, get) in enumerate(SPMD_STEPS):
        if trainer:
            pin_wait = 0.0
            if n:
                for s in shards.values():
                    s.data.add_(1.0)  # the training step, in place
                # The step's gap: the client's page-locking of the segments
                # it attached ends, as main's steady state waits for it.
                pin_wait = await tst.client("spmd").wait_pinned()
            sync()
            k1 = staging.cast_kernel.launches, staging.cast_kernel.fallbacks
            ops0 = _rung_ops()
            t0 = time.perf_counter()
            await tst.put_state_dict("policy", tree, transfer_dtype=bf16, store_name="spmd")
            sync()
            s = time.perf_counter() - t0
            out["steps"][put] = {"s": s, "gb_per_s": out["wire_bytes"] / s / 1e9,
                                 "wait_pinned_s": pin_wait,
                                 "launches": staging.cast_kernel.launches - k1[0],
                                 "fallbacks": staging.cast_kernel.fallbacks - k1[1],
                                 "rung": _rungs_of(_delta(_rung_ops(), ops0), "put")}
        await tst.barrier(f"{put}_done", store_name="spmd")
        if not trainer:
            for s in targets.values():
                s.data.zero_()
            sync()
            ops0, stripes0 = _rung_ops(), _striped_counts()
            bulk0 = tst.client("spmd").bulk_stats()
            mem0 = torch.cuda.memory_allocated(dev) if cuda else 0
            t0 = time.perf_counter()
            await tst.get_state_dict("policy", tree, store_name="spmd")
            sync()
            s = time.perf_counter() - t0
            moved = _delta(_rung_ops(), ops0)
            bulk1 = tst.client("spmd").bulk_stats()
            bad = 0
            for i, (path, _, shape) in enumerate(leaves):
                want = _spmd_leaf(torch, i, shape, dev)[targets[path].tensor_slice.box.to_index()]
                for _ in range(n):
                    want.add_(1.0)
                bad += not torch.equal(targets[path].data.view(torch.int16),
                                       want.to(bf16).view(torch.int16))
                del want
            out["steps"][get] = {
                "s": s, "gb_per_s": out["wire_bytes"] / s / 1e9,
                "rung": _rungs_of(moved, "get"), "ops": {k: v for k, v in moved.items() if v},
                "dials": bulk1["dials"] - bulk0["dials"],
                "striped": _delta(_striped_counts(), stripes0),
                "split": {k: bulk1[k] - bulk0[k] for k in ("recv_s", "h2d_wait_s", "card_sync_s",
                                                           "recv_bytes")},
                "card_bytes_left": torch.cuda.memory_allocated(dev) - mem0 if cuda else 0,
                "bit_equal": not bad, "mismatched": bad}
        await tst.barrier(f"{get}_done", store_name="spmd")
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev) if cuda else 0
    children = [p.pid for p in multiprocessing.active_children()]
    from multiprocessing import forkserver

    server_pid = getattr(forkserver._forkserver, "_forkserver_pid", None)
    if server_pid:
        children.append(server_pid)  # it leaves when this rank does
    t0 = time.perf_counter()
    await tst.shutdown("spmd")
    out["shutdown_s"] = time.perf_counter() - t0
    out["children"] = children
    return out


def _spmd_rank_main(rank: int, env: dict, spec: dict, queue) -> None:
    """A spawned rank: the launcher's environment, then the rank's work."""
    import traceback

    os.environ.update(env)
    try:
        import torch

        queue.put((rank, asyncio.run(_spmd_rank(torch, rank, spec)), None))
    except BaseException:  # noqa: BLE001 - reported to the parent, which fails the phase
        queue.put((rank, None, traceback.format_exc()))


def _descendants(pids) -> list:
    """Every live process below ``pids`` (children, theirs, ...)."""
    parent_of = {}
    for name in os.listdir("/proc"):
        if name.isdigit():
            try:
                with open(f"/proc/{name}/stat") as f:
                    parent_of[int(name)] = int(f.read().split(")")[-1].split()[1])
            except (OSError, ValueError, IndexError):
                continue
    found, frontier = [], set(pids)
    while frontier:
        nxt = {pid for pid, ppid in parent_of.items() if ppid in frontier}
        found.extend(nxt)
        frontier = nxt
    return found


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    try:  # a zombie is gone too
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except OSError:
        return False


def _spmd_path(torch, staging, layers: int, device: str, geometry=None) -> dict:
    """Launch the four ranks with torchrun's variables (an ephemeral
    MASTER_PORT), collect each rank's record, and check the world: every
    target bit-equal, every cross-host read on the bulk rung, K1 launches =
    the planner's chunks on every trainer put, no process left."""
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    spec = {"layers": layers, "device": device, "geometry": geometry}
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_spmd_rank_main, args=(r, _spmd_env(r, port), spec, queue))
             for r in range(SPMD_WORLD)]
    for p in procs:
        p.start()
    ranks: list = [None] * SPMD_WORLD
    errors = {}
    try:
        for _ in range(SPMD_WORLD):
            rank, res, err = queue.get(timeout=SPMD_TIMEOUT_S)
            if err is not None:
                errors[rank] = err[-3000:]
            ranks[rank] = res
            if errors:
                break
    except Exception as exc:  # noqa: BLE001 - a rank that never answered fails the phase
        errors["timeout"] = repr(exc)
    finally:
        if errors:  # the others wait at a barrier that never fills: stop them all
            for pid in _descendants([p.pid for p in procs]):
                try:
                    os.kill(pid, 9)
                except OSError:
                    pass
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    wall = time.perf_counter() - t0
    exit_codes = [p.exitcode for p in procs]
    out: dict = {"world": SPMD_WORLD, "hosts": SPMD_WORLD // SPMD_LOCAL, "layers": layers,
                 "seconds_all": wall, "exit_codes": exit_codes, "errors": errors}
    if errors or any(r is None for r in ranks):
        out["ok"] = False
        return out
    # A rank's forkserver leaves once it sees its rank gone: allow it a moment.
    deadline = time.monotonic() + 15.0
    left = [pid for r in ranks for pid in r["children"]]
    while left and time.monotonic() < deadline:
        time.sleep(0.2)
        left = [pid for pid in left if _pid_alive(pid)]
    trainers = [r for r in ranks if r["role"] == "trainer"]
    generators = [r for r in ranks if r["role"] == "generator"]
    cuda = device.startswith("cuda")
    out.update({
        "ranks": ranks,
        "initialize_s": [r["initialize_s"] for r in ranks],
        "launches": sum(s["launches"] for r in trainers for s in r["steps"].values()),
        "processes_left": left,
    })
    out["ok"] = bool(
        all(s["bit_equal"] for r in generators for s in r["steps"].values())
        and all(s["rung"] == ["bulk"] for r in generators for s in r["steps"].values())
        and all(s["rung"] == ["shm"] for r in trainers for s in r["steps"].values())
        and all(s["fallbacks"] == 0 for r in trainers for s in r["steps"].values())
        and (not cuda or all(s["launches"] == r["chunks"] for r in trainers
                             for s in r["steps"].values()))
        and all(s["card_bytes_left"] <= 0 for r in generators for s in r["steps"].values())
        and all(code == 0 for code in exit_codes)
        and not left
    )
    return out


def plan_spmd_layers(torch, dev) -> tuple[int, dict]:
    """Depth that fits one card shared by the four ranks: the trainers' fp32
    halves and their bf16 casts, the generators' bf16 halves (8 bytes a
    parameter over the world), the fp32 leaf each generator makes at a time
    to check a target, and a context per rank; on the host the trainer
    volumes' bf16 segments, live and the warm set a reput rotates to (4
    bytes a parameter)."""
    from torchstore_tpu_torch.workloads import LLAMA3_8B

    free, _ = torch.cuda.mem_get_info(dev)
    leaf = 4 * LLAMA3_8B["vocab"] * LLAMA3_8B["hidden"]
    card_budget = 0.95 * free - SPMD_WORLD * (768 << 20)
    host_budget = 0.8 * min(shm_free_bytes(), mem_available_bytes())
    need = lambda n: 8 * _llama_params(n) + 2 * leaf  # noqa: E731
    layers = LAYERS
    while layers > 1 and (need(layers) > card_budget
                          or 4 * _llama_params(layers) > host_budget):
        layers -= 1
    return layers, {"card_budget_bytes": int(card_budget),
                    "card_needed_bytes": need(layers),
                    "host_budget_bytes": int(host_budget),
                    "host_needed_bytes": 4 * _llama_params(layers)}


def phase_spmd(torch, staging) -> dict:
    dev = torch.device("cuda", 0)
    layers, sizing = plan_spmd_layers(torch, dev)
    if layers < LAYERS:
        emit({"reduced": {"spmd_layers": layers}, **sizing})
    layers = time_capped("spmd_layers", layers)
    res = _spmd_path(torch, staging, layers, "cuda:0")
    res["phase"] = "spmd"
    res["sizing"] = sizing
    res["nvidia_smi"] = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    return res


# --------------------------------------------------------------------------
# tiering: version retention and the disk tier
# --------------------------------------------------------------------------

TIER_KEEP = 2
TIER_VERSIONS = 4  # leg (a): v0..v3; leg (e) publishes v4
TIER_SEED = 4242
TIER_STORE = "tiering"
TIER_DURABLE_STORE = "tiering_durable"
TIER_CHANNEL = "tier"
# The tier store's segment pool: small, so a demoted version's segments
# leave /dev/shm at once, and no warm spare set competes with the versions.
TIER_POOL_CAP = 1 << 30
MEMORY_FS = ("tmpfs", "ramfs")


def _mount_of(path: str) -> tuple[str, str]:
    """(mount point, filesystem type) of ``path``, from /proc/mounts."""
    real = os.path.realpath(path)
    best = ("/", "unknown")
    with open("/proc/mounts") as f:
        for line in f:
            fields = line.split()
            if len(fields) < 3:
                continue
            mount = fields[1].encode().decode("unicode_escape")
            inside = real == mount or real.startswith(mount.rstrip("/") + "/")
            if inside and len(mount) >= len(best[0]):
                best = (mount, fields[2])
    return best


def _dir_facts(path: str) -> dict:
    os.makedirs(path, exist_ok=True)
    mount, fstype = _mount_of(path)
    st = os.statvfs(path)
    return {"path": path, "mount": mount, "fstype": fstype,
            "free_bytes": st.f_frsize * st.f_bavail}


def _tier_base_dirs() -> list:
    """Where the phase may keep its tier and storage directories: a
    directory of the checkout (git-ignored) and one under the temporary
    directory, in that order."""
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    return [os.path.join(here, "_tiering"), os.path.join(tempfile.gettempdir(), "tst_tiering")]


def plan_tiering(torch, dev) -> tuple[int, dict]:
    """The phase's plan: both directories on the first candidate that is a
    disk filesystem (not tmpfs: a disk tier there would measure RAM), and
    the depth that fits. /dev/shm holds four bf16 versions at the peak (the
    leased v0, the two kept, one landing) and the pool cap (plus both disk
    copies when only tmpfs is left); the disk holds one spilled version and
    the durable copy; the card holds the fp32 source, the bf16 targets, a
    publish's bf16 cast and a check's regenerated tensor. Widths never
    change."""
    from torchstore_tpu_torch.workloads import LLAMA3_8B, llama_shapes

    facts = [_dir_facts(p) for p in _tier_base_dirs()]
    disk = [f for f in facts if f["fstype"] not in MEMORY_FS]
    base = (disk or facts)[0]
    geo = dict(LLAMA3_8B)
    per_layer = sum(math.prod(s) for s in _leaves(llama_shapes(**{**geo, "layers": 1})["layers"]))
    outer = sum(math.prod(s) for s in _leaves({**llama_shapes(**{**geo, "layers": 0}),
                                               "layers": {}}))
    params = lambda n: outer + n * per_layer  # noqa: E731
    shm_free, mem_free = shm_free_bytes(), mem_available_bytes()
    host_budget = 0.8 * min(shm_free, mem_free)
    card_free, card_total = torch.cuda.mem_get_info(dev)
    card_budget = 0.9 * card_free
    on_disk = base["fstype"] not in MEMORY_FS
    leaf = 4 * geo["vocab"] * geo["hidden"]
    host_need = lambda n: 4 * 2 * params(n) + TIER_POOL_CAP + (0 if on_disk else 4 * params(n))  # noqa: E731
    disk_need = lambda n: int(2 * 2 * params(n) * 1.05) + (64 << 20)  # noqa: E731
    card_need = lambda n: (4 + 2 + 2) * params(n) + 3 * leaf  # noqa: E731
    layers = geo["layers"]
    while layers > 1 and (host_need(layers) > host_budget or card_need(layers) > card_budget
                          or disk_need(layers) > base["free_bytes"]):
        layers -= 1
    plan = {
        "dev_shm_free_bytes": shm_free, "mem_available_bytes": mem_free,
        "card_free_bytes": card_free, "card_total_bytes": card_total,
        "candidates": facts, "base": base["path"], "on_disk": on_disk,
        "tier_dir": os.path.join(base["path"], "tier"),
        "storage_dir": os.path.join(base["path"], "storage"),
        "host_budget_bytes": int(host_budget), "host_needed_bytes": host_need(layers),
        "disk_needed_bytes": disk_need(layers), "card_budget_bytes": int(card_budget),
        "card_needed_bytes": card_need(layers), "pool_cap": TIER_POOL_CAP,
    }
    plan["dirs"] = {name: {**_dir_facts(plan[name]), "free_bytes": base["free_bytes"]}
                    for name in ("tier_dir", "storage_dir")}
    return layers, plan


def _tier_tensor(torch, shape, idx: int, version: int, dev):
    """Tensor ``idx`` of the source at ``version``: its seeded fp32 start
    plus one seeded step per version, each added in place as the phase's
    training step adds it; regenerated to check a target bit for bit."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(TIER_SEED + idx)
    t = torch.randn(shape, generator=gen, device=dev)
    for v in range(1, version + 1):
        _tier_step(torch, t, idx, v, dev)
    return t


def _tier_step(torch, t, idx: int, version: int, dev) -> None:
    gen = torch.Generator(device=dev)
    gen.manual_seed(TIER_SEED + 100_003 * version + idx)
    t.add_(torch.randn(t.shape, generator=gen, device=dev), alpha=1e-3)


def _tier_mismatches(torch, targets: dict, shapes: dict, version: int, dev) -> int:
    """Targets that differ from the bf16 cast of the source at ``version``
    (regenerated one tensor at a time)."""
    bad = 0
    for idx, key in enumerate(shapes):
        want = _tier_tensor(torch, shapes[key], idx, version, dev).to(torch.bfloat16)
        bad += not torch.equal(targets[key].view(torch.int16), want.view(torch.int16))
        del want
    return bad


async def _volume_stats(client) -> dict:
    stats = await client.controller.stats.call_one(include_volumes=True)
    (vol,) = stats["volumes"].values()
    return {"tier": vol.get("tier", {}), "metrics": vol["metrics"],
            "controller_metrics": stats["metrics"], "resident_bytes": vol["resident_bytes"]}


async def _quarantines(client) -> float:
    """Volumes the store's supervisor has quarantined so far."""
    stats = await client.controller.stats.call_one()
    return _series_total(stats["metrics"], "ts_quarantines_total")


async def _stop_keeping_files(tst, store_name: str) -> None:
    """A restart's first half: the store's processes stop (each volume
    releases its segments), without the teardown that would reset the
    volumes and with them the durable directory."""
    from torchstore_tpu_torch import api
    from torchstore_tpu_torch.runtime import stop_singleton
    from torchstore_tpu_torch.runtime.actors import close_all_connections

    handle = api._stores.pop(store_name)
    handle.client.close()
    os.environ.pop(api.ENV_STORE_PREFIX + store_name, None)
    await handle.volume_mesh.stop()
    await stop_singleton(api._controller_name(store_name))
    await close_all_connections()


async def _tiering_path(torch, staging, layers: int, dev, tier_dir: str, storage_dir: str,
                        cfg=None) -> dict:
    """The channel's multi-version path at Llama-3-8B width (the port
    Llama's 291 tensors, fp32 on the card, bf16 on the wire, bf16 targets on
    the card), six legs through the port's entry points: (a) keep=2 publishes
    v0..v3 with v0 leased by cohort eval; (b) a spill pass demotes v2; (c) a
    pinned acquire of resident v0; (d) a pinned acquire of v2 from disk,
    then warm; (e) the lease released, v4 published, v0 reaped; (f) a
    durable store restarted and recovered."""
    import torchstore_tpu_torch as tst
    from torchstore_tpu_torch.config import StoreConfig
    from torchstore_tpu_torch.transport.shared_memory import PREFIX, SHM_DIR
    from torchstore_tpu_torch.workloads import llama3_8b_config

    bf16 = torch.bfloat16
    cuda = dev.type == "cuda"
    shapes = _model_shapes(torch, cfg or llama3_8b_config(layers), layers)
    src = {k: _tier_tensor(torch, s, i, 0, dev) for i, (k, s) in enumerate(shapes.items())}
    targets = {k: torch.zeros(s, dtype=bf16, device=dev) for k, s in shapes.items()}
    n_params = sum(t.numel() for t in src.values())
    wire = 2 * n_params
    chunks = len(staging.plan_chunks(list(src.values()), bf16))

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def zero_targets():
        for t in targets.values():
            t.zero_()
        sync()

    out: dict = {"layers": layers, "tensors": len(src), "params": n_params, "wire_bytes": wire,
                 "chunks_per_publish": chunks, "tier_dir": tier_dir, "storage_dir": storage_dir}
    env = {"TORCHSTORE_TORCH_TIER_ENABLED": "1", "TORCHSTORE_TORCH_TIER_DIR": tier_dir,
           "TORCHSTORE_TORCH_TIER_BUDGET_BYTES": str(2 * wire),
           "TORCHSTORE_TORCH_TIER_HIGH_PCT": "1.0", "TORCHSTORE_TORCH_TIER_LOW_PCT": "1.0",
           "TORCHSTORE_TORCH_TIER_SWEEP_INTERVAL_S": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    staging.cast_kernel.launches = 0  # count the tiering path's launches only
    staging.cast_kernel.fallbacks = 0
    config = StoreConfig(shm_pool_max_bytes=TIER_POOL_CAP)
    pids: set = set()
    legs: dict = {}
    try:
        await tst.initialize(store_name=TIER_STORE, config=config)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    pids |= {p.pid for p in multiprocessing.active_children()}
    client = tst.client(TIER_STORE)
    try:
        # (a) keep=2 publishes, v0 leased by cohort "eval" before v1.
        pub = tst.WeightPublisher(TIER_CHANNEL, store_name=TIER_STORE, keep=TIER_KEEP)
        rows, lease = [], None
        for v in range(TIER_VERSIONS):
            if v:
                for i, t in enumerate(src.values()):
                    _tier_step(torch, t, i, v, dev)
            sync()
            launched, fell = staging.cast_kernel.launches, staging.cast_kernel.fallbacks
            t0 = time.perf_counter()
            version = await pub.publish(src, transfer_dtype=bf16)
            sync()
            seconds = time.perf_counter() - t0
            if v == 0:
                lease = await tst.lease_acquire("eval", TIER_CHANNEL, 0, ttl_s=3600,
                                                store_name=TIER_STORE)
            catalog = await tst.version_catalog(TIER_CHANNEL, store_name=TIER_STORE)
            rows.append({"version": version, "publish_s": seconds,
                         "publish_gb_per_s": wire / seconds / 1e9,
                         "launches": staging.cast_kernel.launches - launched,
                         "cast_fallbacks": staging.cast_kernel.fallbacks - fell,
                         "versions_present": sorted(catalog.get(TIER_CHANNEL, {}))})
        before = await _volume_stats(client)
        removed = await tst.delete_prefix(f"{TIER_CHANNEL}/v0", store_name=TIER_STORE)
        after = await _volume_stats(client)
        blocked = (_series_total(after["controller_metrics"], "ts_lease_blocked_deletes_total")
                   - _series_total(before["controller_metrics"], "ts_lease_blocked_deletes_total"))
        v0_keys = len(await tst.keys(f"{TIER_CHANNEL}/v0", store_name=TIER_STORE))
        leg = {"publishes": rows, "lease": {k: lease[k] for k in ("lease_id", "resident_keys")},
               "raw_delete_listed": removed, "v0_keys_after_raw_delete": v0_keys,
               "blocked_deletes": blocked}
        leg["ok"] = (
            [r["version"] for r in rows] == list(range(TIER_VERSIONS))
            and rows[-1]["versions_present"] == [0, 2, 3]
            and v0_keys == len(src) + 1 and blocked >= v0_keys
            and all(r["cast_fallbacks"] == 0 for r in rows)
            and (not cuda or all(r["launches"] == chunks for r in rows))
        )
        legs["a_publish"] = leg
        emit({"tiering_leg": "a_publish", **leg})

        # (b) a spill pass: resident v0 (leased), v2, v3 against a budget of
        # two versions; v2, the coldest unpinned, goes to disk.
        t0 = time.perf_counter()
        report = await tst.tier_sweep(TIER_STORE)
        sweep_s = time.perf_counter() - t0
        after_b = await _volume_stats(client)
        spill_bytes = after_b["tier"]["spill_bytes"] - before["tier"].get("spill_bytes", 0)
        spill_s = after_b["tier"]["spill_s"] - before["tier"].get("spill_s", 0.0)
        catalog = await tst.version_catalog(TIER_CHANNEL, store_name=TIER_STORE)
        tiers = {v: (rec["resident_keys"], rec["spilled_keys"])
                 for v, rec in catalog[TIER_CHANNEL].items()}
        (rep,) = report.values()
        leg = {"sweep_s": sweep_s, "spill_s": spill_s, "spill_bytes": spill_bytes,
               "spill_gb_per_s": spill_bytes / spill_s / 1e9 if spill_s else None,
               "spilled_keys": rep["spilled"], "tiers": tiers,
               "resident_bytes": after_b["resident_bytes"],
               "spills_total": _series_total(after_b["metrics"], "ts_spills_total"),
               "tier_files": sum(len(fs) for _, _, fs in os.walk(tier_dir))}
        leg["ok"] = (tiers[2] == (0, len(src) + 1) and tiers[0][1] == 0 and tiers[3][1] == 0
                     and spill_bytes == wire and rep["spilled"] == len(src) + 1)
        legs["b_spill"] = leg
        emit({"tiering_leg": "b_spill", **leg})

        # (c) cohort eval reads its pinned v0, resident: no fault-in.
        sub = tst.WeightSubscriber(TIER_CHANNEL, store_name=TIER_STORE, cohort="eval")
        zero_targets()
        t0 = time.perf_counter()
        _, got = await sub.acquire(targets, version=0)
        sync()
        seconds = time.perf_counter() - t0
        after_c = await _volume_stats(client)
        leg = {"version": got, "acquire_s": seconds, "acquire_gb_per_s": wire / seconds / 1e9,
               "fault_ins": after_c["tier"]["fault_ins"] - after_b["tier"]["fault_ins"],
               "mismatched": _tier_mismatches(torch, targets, shapes, 0, dev)}
        leg["ok"] = got == 0 and leg["fault_ins"] == 0 and leg["mismatched"] == 0
        legs["c_pinned_resident"] = leg
        emit({"tiering_leg": "c_pinned_resident", **leg})

        # (d) a pinned read of v2 faults it in from disk; then again, warm.
        steps = {}
        for step in ("fault_in", "warm"):
            zero_targets()
            before_d = await _volume_stats(client)
            t0 = time.perf_counter()
            _, got = await sub.acquire(targets, version=2)
            sync()
            seconds = time.perf_counter() - t0
            after_d = await _volume_stats(client)
            fin_s = after_d["tier"]["fault_in_s"] - before_d["tier"]["fault_in_s"]
            fin_bytes = after_d["tier"]["fault_in_bytes"] - before_d["tier"]["fault_in_bytes"]
            steps[step] = {
                "version": got, "acquire_s": seconds, "acquire_gb_per_s": wire / seconds / 1e9,
                "fault_ins": after_d["tier"]["fault_ins"] - before_d["tier"]["fault_ins"],
                "fault_in_s": fin_s, "fault_in_bytes": fin_bytes,
                "fault_in_gb_per_s": fin_bytes / fin_s / 1e9 if fin_s else None,
                "ts_fault_ins_total": _series_total(after_d["metrics"], "ts_fault_ins_total"),
                "mismatched": _tier_mismatches(torch, targets, shapes, 2, dev),
            }
        leg = dict(steps)
        leg["ok"] = (steps["fault_in"]["fault_ins"] == len(src) + 1
                     and steps["fault_in"]["fault_in_bytes"] == wire
                     and steps["warm"]["fault_ins"] == 0
                     and all(s["version"] == 2 and s["mismatched"] == 0 for s in steps.values()))
        legs["d_pinned_fault_in"] = leg
        emit({"tiering_leg": "d_pinned_fault_in", **leg})

        # (e) the lease released and v4 published: GC reaps v0 at last.
        await tst.lease_release(lease["lease_id"], store_name=TIER_STORE)
        for i, t in enumerate(src.values()):
            _tier_step(torch, t, i, TIER_VERSIONS, dev)
        sync()
        launched, fell = staging.cast_kernel.launches, staging.cast_kernel.fallbacks
        t0 = time.perf_counter()
        version = await pub.publish(src, transfer_dtype=bf16)
        sync()
        seconds = time.perf_counter() - t0
        catalog = await tst.version_catalog(TIER_CHANNEL, store_name=TIER_STORE)
        try:
            await sub.acquire(targets, version=0)
            gone = None
        except KeyError as exc:
            gone = str(exc)
        leg = {"version": version, "publish_s": seconds, "publish_gb_per_s": wire / seconds / 1e9,
               "launches": staging.cast_kernel.launches - launched,
               "cast_fallbacks": staging.cast_kernel.fallbacks - fell,
               "versions_present": sorted(catalog.get(TIER_CHANNEL, {})), "v0_acquire": gone}
        leg["ok"] = (version == TIER_VERSIONS and leg["versions_present"] == [3, 4]
                     and gone is not None and "does not retain v0" in gone
                     and leg["cast_fallbacks"] == 0 and (not cuda or leg["launches"] == chunks))
        legs["e_release"] = leg
        emit({"tiering_leg": "e_release", **leg})
        quarantines = {"tier_store": await _quarantines(tst.client(TIER_STORE))}
    finally:
        await tst.shutdown(TIER_STORE)
    out["tier_files_left"] = [os.path.join(d, f) for d, _, fs in os.walk(tier_dir) for f in fs]

    # (f) a durable store: put, restart over the directory, recover, get.
    await tst.initialize(store_name=TIER_DURABLE_STORE, storage_dir=storage_dir)
    pids |= {p.pid for p in multiprocessing.active_children()}
    try:
        launched, fell = staging.cast_kernel.launches, staging.cast_kernel.fallbacks
        t0 = time.perf_counter()
        await tst.put_state_dict("durable", src, transfer_dtype=bf16,
                                 store_name=TIER_DURABLE_STORE)
        sync()
        put_s = time.perf_counter() - t0
        put_launches = staging.cast_kernel.launches - launched
        put_fallbacks = staging.cast_kernel.fallbacks - fell
        files = sum(len(fs) for _, _, fs in os.walk(storage_dir))
        quarantines["durable_put"] = await _quarantines(tst.client(TIER_DURABLE_STORE))
        await _stop_keeping_files(tst, TIER_DURABLE_STORE)
        t0 = time.perf_counter()
        await tst.initialize(store_name=TIER_DURABLE_STORE, storage_dir=storage_dir,
                             recover=True)
        init_s = time.perf_counter() - t0
        pids |= {p.pid for p in multiprocessing.active_children()}
        dclient = tst.client(TIER_DURABLE_STORE)
        t0 = time.perf_counter()
        count = await dclient.controller.rebuild_index.call_one()
        rebuild_s = time.perf_counter() - t0
        zero_targets()
        t0 = time.perf_counter()
        await tst.get_state_dict("durable", targets, store_name=TIER_DURABLE_STORE)
        sync()
        get_s = time.perf_counter() - t0
        bad = _tier_mismatches(torch, targets, shapes, TIER_VERSIONS, dev)
        quarantines["recovered"] = await _quarantines(dclient)
    finally:
        if TIER_DURABLE_STORE in tst.api._stores:
            await tst.shutdown(TIER_DURABLE_STORE)
    leg = {"put_s": put_s, "put_gb_per_s": wire / put_s / 1e9, "launches": put_launches,
           "cast_fallbacks": put_fallbacks, "files": files,
           "initialize_recover_s": init_s, "rebuild_index_count": count,
           "rebuild_index_s": rebuild_s, "first_get_s": get_s,
           "first_get_gb_per_s": wire / get_s / 1e9, "mismatched": bad,
           "storage_files_left": [f for _, _, fs in os.walk(storage_dir) for f in fs]}
    leg["ok"] = (bad == 0 and count == len(src) + 1 and put_fallbacks == 0
                 and (not cuda or put_launches == chunks) and not leg["storage_files_left"])
    legs["f_durable"] = leg
    emit({"tiering_leg": "f_durable", **leg})

    await asyncio.sleep(0.5)
    alive = [p.pid for p in multiprocessing.active_children() if p.pid in pids]
    own = pids | {os.getpid()}
    leaked = [n for n in os.listdir(SHM_DIR)
              if n.startswith(PREFIX) and int(n[len(PREFIX):].split("_")[0]) in own]
    out.update({"legs": {k: v["ok"] for k, v in legs.items()},
                "launches": staging.cast_kernel.launches,
                "cast_fallbacks": staging.cast_kernel.fallbacks,
                "ts_quarantines_total": quarantines,
                "processes_left": alive, "segments_left": leaked[:5],
                "peak_device_bytes": torch.cuda.max_memory_allocated(dev) if cuda else 0})
    # The supervisor runs at its defaults: a busy volume writing to disk
    # must go on answering its pings (the writes run off its event loop).
    out["ok"] = (all(v["ok"] for v in legs.values()) and not alive and not leaked
                 and not out["tier_files_left"] and staging.cast_kernel.fallbacks == 0
                 and sum(quarantines.values()) == 0)
    return out


def phase_tiering(torch, staging) -> dict:
    import shutil

    dev = torch.device("cuda", 0)
    layers, plan = plan_tiering(torch, dev)
    emit({"tiering_plan": plan})
    if layers < LAYERS:
        emit({"reduced": {"tiering_layers": layers, "of": LAYERS}, **plan})
    layers = time_capped("tiering", layers)
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        res = asyncio.run(_tiering_path(torch, staging, layers, dev, plan["tier_dir"],
                                        plan["storage_dir"]))
    finally:
        for base in _tier_base_dirs():
            shutil.rmtree(base, ignore_errors=True)
    res["phase"] = "tiering"
    res["plan"] = {k: plan[k] for k in ("base", "on_disk", "tier_dir", "storage_dir", "dirs")}
    res["nvidia_smi"] = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    return res


# --------------------------------------------------------------------------
# healing: replication, repair and the health supervisor
# --------------------------------------------------------------------------

HEAL_SEED = 5151
HEAL_STORE = "healing"
HEAL_WEDGE_STORE = "healing_wedge"
HEAL_R1_STORE = "healing_r1"
HEAL_LIVE_STORE = "healing_live"
HEAL_LIVE_LAYERS = 4  # leg (h): a trainer re-putting through the kill and the auto-repair
# The surviving source serves the auto-repair's read this late, so the pull
# is still in flight while the re-puts land on its target.
HEAL_LIVE_GET_DELAY_MS = 8000
# The trainer's step between two puts. The kill lands in one, so the
# supervisor quarantines the victim (about 1.3 s) while it still holds every
# key, and auto-repair has them all to copy.
HEAL_LIVE_STEP_S = 2.5
HEAL_LIVE_LIMIT_S = 120.0  # a hard stop; the leg is planned to take under 60 s
# Leg (h)'s reclaim schedule (the default is 1, 5, 15, 60 s): its gate reads
# the copies once the reclaims on the healthy volumes drained.
HEAL_LIVE_ENV = {"TORCHSTORE_TORCH_RECLAIM_DELAYS": "0.5,1,2,4"}
HEAL_KEY = "heal"
HEAL_VOLUMES = 3
HEAL_REPLICATION = 2
HEAL_SIDE_LAYERS = 2  # the wedge leg's and the replication-1 control's depth
HEAL_ENV = {"TORCHSTORE_TORCH_HEALTH_INTERVAL_S": "0.5",
            "TORCHSTORE_TORCH_HEALTH_MISS_THRESHOLD": "3"}
# The phase's segment pools: small, so no warm spare set competes with the
# replicas, auto-repair's copy and repair's copy for host memory.
HEAL_POOL_CAP = 1 << 30
# Host copies at the peak: the dead volume's segments (until repair reaps
# them), the surviving replica, auto-repair's copy, and one for the pools,
# the client's transient staging and the replacement's copy racing the reap.
HEAL_HOST_COPIES = 4
HEAL_WAIT_S = 120.0


def plan_healing(torch, dev) -> tuple[int, dict]:
    """Depth that fits, by plan_layers' rule: HEAL_HOST_COPIES bf16 copies
    in host memory and /dev/shm; on the card the fp32 source, its bf16 cast
    during the put, and the bf16 targets. Widths never change."""
    from torchstore_tpu_torch.workloads import LLAMA3_8B, llama_shapes

    geo = dict(LLAMA3_8B)
    per_layer = sum(math.prod(s) for s in _leaves(llama_shapes(**{**geo, "layers": 1})["layers"]))
    outer = sum(math.prod(s) for s in _leaves({**llama_shapes(**{**geo, "layers": 0}),
                                               "layers": {}}))
    params = lambda n: outer + n * per_layer  # noqa: E731
    shm_free, mem_free = shm_free_bytes(), mem_available_bytes()
    host_budget = 0.8 * min(shm_free, mem_free)
    card_free, card_total = torch.cuda.mem_get_info(dev)
    card_budget = 0.9 * card_free
    host_need = lambda n: HEAL_HOST_COPIES * 2 * params(n)  # noqa: E731
    card_need = lambda n: (4 + 2 + 2) * params(n) + 4 * geo["vocab"] * geo["hidden"]  # noqa: E731
    layers = geo["layers"]
    while layers > 1 and (host_need(layers) > host_budget or card_need(layers) > card_budget):
        layers -= 1
    return layers, {"dev_shm_free_bytes": shm_free, "mem_available_bytes": mem_free,
                    "host_budget_bytes": int(host_budget), "host_needed_bytes": host_need(layers),
                    "host_copies": HEAL_HOST_COPIES, "card_free_bytes": card_free,
                    "card_total_bytes": card_total, "card_budget_bytes": int(card_budget),
                    "card_needed_bytes": card_need(layers)}


def _volume_process(tst, store_name: str, ref):
    """The process hosting the volume at ``ref`` (its first mesh, or a
    replacement repair spawned)."""
    handle = tst.api._stores[store_name]
    for mesh in [handle.volume_mesh, *handle.repair_meshes]:
        for idx, mine in enumerate(mesh.refs):
            if (mine.host, mine.port, mine.name) == (ref.host, ref.port, ref.name):
                return mesh._processes[idx]
    raise LookupError(f"no process hosts {ref!r}")


async def _wait_until(predicate, limit_s: float = HEAL_WAIT_S, every_s: float = 0.05):
    """Poll ``predicate`` (a coroutine function) until it returns a truthy
    value; that value, or None after ``limit_s``."""
    deadline = time.monotonic() + limit_s
    while time.monotonic() < deadline:
        got = await predicate()
        if got:
            return got
        await asyncio.sleep(every_s)
    return None


async def _heal_store(tst, store_name: str, num_volumes: int, replication: int,
                      env: dict | None = None):
    """A store of ``num_volumes`` volumes under the phase's supervisor
    settings and ``env`` (they ride the controller's spawn environment)."""
    from torchstore_tpu_torch.config import StoreConfig

    env = {**HEAL_ENV, **(env or {})}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        await tst.initialize(num_storage_volumes=num_volumes, store_name=store_name,
                             strategy=tst.LocalRankStrategy(replication=replication),
                             config=StoreConfig(shm_pool_max_bytes=HEAL_POOL_CAP))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return tst.client(store_name)


async def _healing_path(torch, staging, layers: int, dev, cfg=None,
                        side_layers: int = HEAL_SIDE_LAYERS,
                        live_layers: int = HEAL_LIVE_LAYERS) -> dict:
    """Replicated puts that survive a volume's death, at Llama-3-8B width
    (fp32 weights on the card, bf16 on the wire, bf16 targets on the
    card), through the port's entry points, on 3 volumes at replication
    2: (a) put_state_dict, every key on exactly 2 volumes; (b) a get; (c)
    SIGKILL of the volume holding the most bytes, then gets; (d) the
    supervisor's quarantine and auto-repair back to 2 healthy copies; (e)
    repair(); (f) a wedged (SIGSTOPped) volume reported, not replaced;
    (g) replication 1: a killed volume's keys raise with the controller's
    diagnosis and repair reports them lost; (h) a trainer re-putting the
    same keys every round through a kill and the auto-repair that follows,
    its pull slowed on the source, at ``live_layers``: every healthy copy
    ends bit-equal to the last put. Every target is held bit for bit
    against the plain cast of its source."""
    import signal

    import torchstore_tpu_torch as tst
    from torchstore_tpu_torch.runtime import ActorDiedError
    from torchstore_tpu_torch.transport.shared_memory import SHM_DIR, owner_pid
    from torchstore_tpu_torch.workloads import llama3_8b_config

    bf16 = torch.bfloat16
    cuda = dev.type == "cuda"
    cfg = cfg or llama3_8b_config(layers)
    gen = torch.Generator(device=dev)
    gen.manual_seed(HEAL_SEED)
    src = _model_state(torch, cfg, layers, gen, dev)
    targets = {k: torch.zeros(t.shape, dtype=bf16, device=dev) for k, t in src.items()}
    n_params = sum(t.numel() for t in src.values())
    wire = 2 * n_params
    chunks = len(staging.plan_chunks(list(src.values()), bf16))

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def mismatched(tgts: dict, source: dict) -> int:
        sync()
        return sum(not torch.equal(tgts[k].view(torch.int16), source[k].to(bf16).view(torch.int16))
                   for k in source)

    async def get_all(store_name: str, tgts: dict) -> float:
        for t in tgts.values():
            t.zero_()
        sync()
        t0 = time.perf_counter()
        await tst.get_state_dict(HEAL_KEY, tgts, store_name=store_name)
        sync()
        return time.perf_counter() - t0

    async def put_all(store_name: str, source: dict) -> dict:
        launched, fell = staging.cast_kernel.launches, staging.cast_kernel.fallbacks
        sync()
        t0 = time.perf_counter()
        await tst.put_state_dict(HEAL_KEY, source, transfer_dtype=bf16, store_name=store_name)
        sync()
        seconds = time.perf_counter() - t0
        return {"put_s": seconds,
                "put_gb_per_s": 2 * sum(t.numel() for t in source.values()) / seconds / 1e9,
                "launches": staging.cast_kernel.launches - launched,
                "chunks": len(staging.plan_chunks(list(source.values()), bf16)),
                "cast_fallbacks": staging.cast_kernel.fallbacks - fell}

    out: dict = {"layers": layers, "tensors": len(src), "params": n_params, "wire_bytes": wire,
                 "chunks_per_put": chunks, "volumes": HEAL_VOLUMES,
                 "replication": HEAL_REPLICATION, "supervisor": HEAL_ENV}
    staging.cast_kernel.launches = 0  # count the healing path's launches only
    staging.cast_kernel.fallbacks = 0
    legs: dict = {}
    pids: set = set()
    dead_pids: set = set()
    stopped: list = []
    client = await _heal_store(tst, HEAL_STORE, HEAL_VOLUMES, HEAL_REPLICATION)
    pids |= {p.pid for p in multiprocessing.active_children()}
    try:
        # (a) the replicated put: K1 casts on the card, every key on 2 volumes.
        leg = await put_all(HEAL_STORE, src)
        keys = await tst.keys(HEAL_KEY, store_name=HEAL_STORE)
        located = await client.controller.locate_volumes.call_one(keys)
        copies = sorted({len(v) for v in located.values()})
        leg.update({"keys": len(keys), "copies_per_key": copies})
        leg["ok"] = (copies == [HEAL_REPLICATION] and leg["cast_fallbacks"] == 0
                     and (not cuda or leg["launches"] == leg["chunks"]))
        legs["a_put"] = leg
        emit({"healing_leg": "a_put", **leg})

        # (b) a get into the card targets.
        seconds = await get_all(HEAL_STORE, targets)
        leg = {"get_s": seconds, "get_gb_per_s": wire / seconds / 1e9,
               "mismatched": mismatched(targets, src)}
        leg["ok"] = leg["mismatched"] == 0
        legs["b_get"] = leg
        emit({"healing_leg": "b_get", **leg})

        # (c) SIGKILL the volume holding the most bytes; the next gets fail over.
        stats = await client.controller.stats.call_one(include_volumes=True)
        held = {vid: v.get("resident_bytes", 0) for vid, v in stats["volumes"].items()}
        victim = sorted(held, key=lambda v: (-held[v], v))[0]
        victim_keys = sorted(k for k, infos in located.items() if victim in infos)
        vmap = await client.controller.get_volume_map.call_one()
        proc = _volume_process(tst, HEAL_STORE, vmap[victim]["ref"])
        victim_pid = proc.pid
        dead_pids.add(victim_pid)
        proc.kill()
        t_kill = time.time()
        proc.join(10)
        diagnoses = client.diagnoses
        first_s = await get_all(HEAL_STORE, targets)
        first_bad = mismatched(targets, src)
        after_first = client.diagnoses
        second_s = await get_all(HEAL_STORE, targets)
        leg = {"victim": victim, "victim_bytes": held[victim], "victim_keys": len(victim_keys),
               "held_bytes": held, "first_get_s": first_s,
               "first_get_gb_per_s": wire / first_s / 1e9, "first_mismatched": first_bad,
               "diagnosis": client.last_diagnosis,
               "diagnosis_fanouts_first_get": after_first - diagnoses,
               "second_get_s": second_s, "second_mismatched": mismatched(targets, src),
               "diagnosis_fanouts_second_get": client.diagnoses - after_first}
        leg["ok"] = (first_bad == 0 and leg["second_mismatched"] == 0
                     and leg["diagnosis_fanouts_second_get"] == 0
                     and "dead" in (client.last_diagnosis or ""))
        legs["c_kill"] = leg
        emit({"healing_leg": "c_kill", **leg})

        # (d) the supervisor quarantines the victim; auto-repair restores 2
        # healthy copies of every key, volume to volume.
        async def quarantined():
            vh = await tst.volume_health(HEAL_STORE)
            return vh if vh[victim]["state"] == "quarantined" else None

        health = await _wait_until(quarantined)

        async def repaired():
            loc = await client.controller.locate_volumes.call_one(keys)
            return loc if all(victim not in v and len(v) == HEAL_REPLICATION
                              for v in loc.values()) else None

        healed = await _wait_until(repaired)
        after_heal = await tst.volume_health(HEAL_STORE)
        cstats = await client.controller.stats.call_one()
        report = cstats["auto_repairs"].get(victim, {})
        quarantines = _series_total(cstats["metrics"], "ts_quarantines_total")
        # The controller stamps the quarantine (auto-repair's start) on the
        # host's wall clock, which the kill was stamped on too.
        start = report.get("started_at")
        leg = {"quarantine_s_from_kill": start - t_kill if start else None,
               "volume_health": health, "auto_repair": report,
               "healed_s_from_kill": start + report["wall_s"] - t_kill if start else None,
               "auto_repair_gb_per_s": (report["bytes"] / report["seconds"] / 1e9
                                        if report.get("seconds") else None),
               "quarantines": quarantines,
               "others_health": {v: h["state"] for v, h in after_heal.items() if v != victim}}
        leg["ok"] = (health is not None and healed is not None and quarantines == 1
                     and report.get("keys") == len(victim_keys)
                     and set(report.get("rungs", {})) == {"bulk"}
                     and all(s == "ok" for s in leg["others_health"].values()))
        legs["d_quarantine"] = leg
        emit({"healing_leg": "d_quarantine", **leg})

        # (e) repair(): a replacement under the victim's id gets its keys back.
        t0 = time.perf_counter()
        rep = await tst.repair(HEAL_STORE)
        repair_s = time.perf_counter() - t0
        pids |= {p.pid for p in multiprocessing.active_children()}
        seconds = await get_all(HEAL_STORE, targets)
        left = [n for n in os.listdir(SHM_DIR) if owner_pid(n) == victim_pid]
        statuses = await client.controller.check_volumes.call_one()
        leg = {"report": {k: (v if k != "lost" else v[:5]) for k, v in rep.items()},
               "repair_s": repair_s, "repair_gb_per_s": wire / repair_s / 1e9,
               "get_s": seconds, "mismatched": mismatched(targets, src),
               "victim_segments_left": left[:5], "statuses": statuses}
        leg["ok"] = (rep["replaced"] == [victim] and rep["lost"] == [] and rep["failed"] == []
                     and rep["wedged"] == [] and rep["rereplicated"] == len(victim_keys)
                     and leg["mismatched"] == 0 and not left)
        legs["e_repair"] = leg
        emit({"healing_leg": "e_repair", **leg})
    finally:
        await tst.shutdown(HEAL_STORE)
    del targets

    side_cfg = __import__("dataclasses").replace(cfg, num_layers=side_layers)
    side_gen = torch.Generator(device=dev)
    side_gen.manual_seed(HEAL_SEED + 1)
    side = _model_state(torch, side_cfg, side_layers, side_gen, dev)
    side_targets = {k: torch.zeros(t.shape, dtype=bf16, device=dev) for k, t in side.items()}

    # (f) a wedged volume: reported by check_volumes and repair, not replaced.
    wclient = await _heal_store(tst, HEAL_WEDGE_STORE, HEAL_VOLUMES, HEAL_REPLICATION)
    pids |= {p.pid for p in multiprocessing.active_children()}
    try:
        put = await put_all(HEAL_WEDGE_STORE, side)
        wvmap = await wclient.controller.get_volume_map.call_one()
        wproc = _volume_process(tst, HEAL_WEDGE_STORE, wvmap["0"]["ref"])
        os.kill(wproc.pid, signal.SIGSTOP)
        stopped.append(wproc.pid)
        t0 = time.perf_counter()
        statuses = await wclient.controller.check_volumes.call_one()
        check_s = time.perf_counter() - t0
        rep = await tst.repair(HEAL_WEDGE_STORE)
        os.kill(wproc.pid, signal.SIGCONT)
        stopped.remove(wproc.pid)
        seconds = await get_all(HEAL_WEDGE_STORE, side_targets)
        leg = {**put, "status": statuses["0"], "check_s": check_s, "report": rep,
               "get_s": seconds, "mismatched": mismatched(side_targets, side)}
        leg["ok"] = (statuses["0"].startswith("wedged") and rep["wedged"] == ["0"]
                     and rep["replaced"] == [] and leg["mismatched"] == 0
                     and put["cast_fallbacks"] == 0 and (not cuda or put["launches"] == put["chunks"]))
        legs["f_wedge"] = leg
        emit({"healing_leg": "f_wedge", **leg})
    finally:
        for pid in stopped:
            os.kill(pid, signal.SIGCONT)
        await tst.shutdown(HEAL_WEDGE_STORE)

    # (g) replication 1: a killed volume's keys are lost, loudly.
    rclient = await _heal_store(tst, HEAL_R1_STORE, 2, 1)
    pids |= {p.pid for p in multiprocessing.active_children()}
    try:
        put = await put_all(HEAL_R1_STORE, side)
        rkeys = await tst.keys(HEAL_KEY, store_name=HEAL_R1_STORE)
        rloc = await rclient.controller.locate_volumes.call_one(rkeys)
        (home,) = {vid for infos in rloc.values() for vid in infos}
        rvmap = await rclient.controller.get_volume_map.call_one()
        rproc = _volume_process(tst, HEAL_R1_STORE, rvmap[home]["ref"])
        dead_pids.add(rproc.pid)
        rproc.kill()
        rproc.join(10)
        try:
            await get_all(HEAL_R1_STORE, side_targets)
            raised = None
        except ActorDiedError as exc:
            raised = str(exc)
        rep = await tst.repair(HEAL_R1_STORE)
        pids |= {p.pid for p in multiprocessing.active_children()}
        try:
            await get_all(HEAL_R1_STORE, side_targets)
            after = None
        except KeyError as exc:
            after = f"KeyError: {exc}"
        leg = {**put, "home": home, "keys": len(rkeys), "error": (raised or "")[:400],
               "report": {**rep, "lost": len(rep["lost"])}, "get_after_repair": after}
        leg["ok"] = (raised is not None and "controller diagnosis" in raised
                     and "dead" in raised and rep["replaced"] == [home]
                     and sorted(rep["lost"]) == sorted(rkeys) and rep["rereplicated"] == 0
                     and after is not None and put["cast_fallbacks"] == 0
                     and (not cuda or put["launches"] == put["chunks"]))
        legs["g_replication_1"] = leg
        emit({"healing_leg": "g_replication_1", **leg})
    finally:
        await tst.shutdown(HEAL_R1_STORE)
    del side, side_targets

    # (h) a trainer re-putting through a kill and the auto-repair.
    emit({"reduced": {"healing_live_layers": live_layers, "of": LAYERS}})
    live_cfg = __import__("dataclasses").replace(cfg, num_layers=live_layers)
    live_gen = torch.Generator(device=dev)
    live_gen.manual_seed(HEAL_SEED + 2)
    live = _model_state(torch, live_cfg, live_layers, live_gen, dev)
    leg = await asyncio.wait_for(
        _live_repair_leg(torch, tst, live, live_layers, put_all, pids, dead_pids),
        HEAL_LIVE_LIMIT_S)
    legs["h_live_repair"] = leg
    emit({"healing_leg": "h_live_repair", **leg})
    del live

    await asyncio.sleep(0.5)
    alive = [p.pid for p in multiprocessing.active_children() if p.pid in pids]
    leaked = [n for n in os.listdir(SHM_DIR) if owner_pid(n) in pids | {os.getpid()}]
    out.update({"legs": {k: v["ok"] for k, v in legs.items()},
                "launches": staging.cast_kernel.launches,
                "cast_fallbacks": staging.cast_kernel.fallbacks,
                "processes_left": alive, "segments_left": leaked[:5],
                "dead_volume_segments_left": [n for n in leaked if owner_pid(n) in dead_pids][:5],
                "peak_device_bytes": torch.cuda.max_memory_allocated(dev) if cuda else 0})
    out["ok"] = (all(v["ok"] for v in legs.values()) and len(legs) == 8 and not alive
                 and not leaked and staging.cast_kernel.fallbacks == 0)
    return out


async def _copies_bit_equal(torch, client, keys: list, want: dict) -> dict:
    """Read every healthy copy of every key through a reader pinned to its
    volume alone; ``{"copies": {key: count}, "mismatched": [(key, vid)]}``
    against ``want`` ({store key: bf16 tensor on the host})."""
    located = await client.controller.locate_volumes.call_one(keys)
    readers: dict = {}
    mismatched = []
    try:
        for key in keys:
            for vid, info in sorted(located[key].items()):
                reader = readers.get(vid)
                if reader is None:
                    reader = readers[vid] = type(client)(client.controller, client.config)
                    await reader.get(key)  # its first read settles its epoch
                reader._loc_cache[key] = {vid: info}
                got = await reader.get(key)
                if not torch.equal(got.view(torch.int16), want[key].view(torch.int16)):
                    mismatched.append((key, vid))
                del got
    finally:
        for reader in readers.values():
            reader.close()
    return {"copies": {k: len(v) for k, v in located.items()}, "mismatched": mismatched}


async def _live_repair_leg(torch, tst, live: dict, layers: int, put_all, pids: set,
                           dead_pids: set) -> dict:
    """Leg (h): 3 volumes at replication 2; a trainer loop re-puts
    ``live`` (a new fill each round, added on the card) every
    ``HEAL_LIVE_STEP_S`` from before the SIGKILL of volume 0 (in a step,
    right after a put) until the supervisor's auto-repair reports done,
    while a delay on the surviving source holds the repair's pull open.
    Gates: no error reaches the trainer, one quarantine, the auto-repair's
    pull ran, and once the loop stopped and the reclaims drained, every
    healthy copy of every key is bit-equal to the last value put (a put
    landing on the pull's target during the read keeps its bytes:
    ``skipped_moved``)."""
    from torchstore_tpu_torch.state_dict_utils import _store_key

    bf16 = torch.bfloat16
    t_leg = time.perf_counter()
    cuda = next(iter(live.values())).is_cuda
    client = await _heal_store(tst, HEAL_LIVE_STORE, HEAL_VOLUMES, HEAL_REPLICATION,
                               env=HEAL_LIVE_ENV)
    pids |= {p.pid for p in multiprocessing.active_children()}
    rounds: list = []
    errors: list = []
    stop = asyncio.Event()
    round_done = asyncio.Event()
    task = None

    async def trainer():
        while not stop.is_set():
            for t in live.values():
                t.add_(1.0)  # the next round's weights
            t0 = time.time()
            try:
                step = await put_all(HEAL_LIVE_STORE, live)
            except Exception as exc:  # noqa: BLE001 - a gate, reported below
                errors.append(repr(exc)[:400])
                return
            rounds.append({"start": t0, "end": time.time(), "put_s": step["put_s"],
                           "launches": step["launches"], "chunks": step["chunks"],
                           "cast_fallbacks": step["cast_fallbacks"]})
            round_done.set()
            await asyncio.sleep(HEAL_LIVE_STEP_S)  # the training step

    try:
        vmap = await client.controller.get_volume_map.call_one()
        victim, source = "0", "1"  # client id 0 puts on volumes 0 and 1
        task = asyncio.ensure_future(trainer())
        await round_done.wait()  # the loop runs before the kill
        await tst.inject_fault("volume.get", "delay", count=1, delay_ms=HEAL_LIVE_GET_DELAY_MS,
                               scope=source, store_name=HEAL_LIVE_STORE)
        proc = _volume_process(tst, HEAL_LIVE_STORE, vmap[victim]["ref"])
        dead_pids.add(proc.pid)
        proc.kill()
        t_kill = time.time()
        proc.join(10)

        async def auto_repaired():
            return (await client.controller.stats.call_one())["auto_repairs"].get(victim)

        report = await _wait_until(auto_repaired, HEAL_LIVE_LIMIT_S)
        stop.set()
        await task
        live_keys = {_store_key(HEAL_KEY, k): k for k in live}

        async def drained():  # the dead volume's reclaims never run
            stats = await client.controller.stats.call_one()
            pending = {v: n for v, n in stats.get("pending_reclaims", {}).items() if v != victim}
            return stats if not pending else None

        cstats = await _wait_until(drained, HEAL_LIVE_LIMIT_S)
        want = {key: live[k].to(bf16).cpu() for key, k in live_keys.items()}
        read = await _copies_bit_equal(torch, client, sorted(live_keys), want)
        del want
        health = await tst.volume_health(HEAL_LIVE_STORE)
    finally:
        stop.set()
        if task is not None and not task.done():
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
        await tst.shutdown(HEAL_LIVE_STORE)
    report = report or {}
    start, wall = report.get("started_at"), report.get("wall_s", 0.0)
    during = [r for r in rounds if start and r["start"] < start + wall and r["end"] > start]
    leg = {"layers": layers, "tensors": len(live),
           "wire_bytes": 2 * sum(t.numel() for t in live.values()),
           "get_delay_ms": HEAL_LIVE_GET_DELAY_MS, "step_s": HEAL_LIVE_STEP_S,
           "env": HEAL_LIVE_ENV,
           "rounds": len(rounds), "round_put_s": [r["put_s"] for r in rounds],
           "puts_after_kill": sum(r["start"] > t_kill for r in rounds),
           "reputs_during_pull": len(during), "errors": errors,
           "quarantines": _series_total((cstats or {}).get("metrics", {}),
                                        "ts_quarantines_total"),
           "auto_repair": report, "skipped_moved": report.get("skipped_moved"),
           "pull_s": report.get("seconds"),
           "quarantine_s_from_kill": start - t_kill if start else None,
           "copies_per_key": sorted(set(read["copies"].values())),
           "mismatched_copies": read["mismatched"][:5],
           "victim_state": health.get(victim, {}).get("state"),
           "launches": sum(r["launches"] for r in rounds),
           "put_chunks": sum(r["chunks"] for r in rounds),
           "cast_fallbacks": sum(r["cast_fallbacks"] for r in rounds),
           "leg_s": time.perf_counter() - t_leg}
    leg["ok"] = (not errors and cstats is not None and leg["quarantines"] == 1
                 and leg["victim_state"] == "quarantined"
                 and sum(report.get("rungs", {}).values()) >= 1
                 and leg["copies_per_key"] == [HEAL_REPLICATION] and not read["mismatched"]
                 and leg["cast_fallbacks"] == 0
                 and (not cuda or leg["launches"] == leg["put_chunks"]))
    return leg


def phase_healing(torch, staging) -> dict:
    dev = torch.device("cuda", 0)
    layers, plan = plan_healing(torch, dev)
    emit({"healing_plan": plan})
    if layers < LAYERS:
        emit({"reduced": {"healing_layers": layers, "of": LAYERS}, **plan})
    layers = time_capped("healing_layers", layers)
    torch.cuda.reset_peak_memory_stats(dev)
    res = asyncio.run(_healing_path(torch, staging, layers, dev))
    res["phase"] = "healing"
    res["nvidia_smi"] = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    return res


def phase_kernels(results: dict) -> dict:
    """One entry per ported kernel, and per (mode, variant) of the flash
    kernels, the tensor-core kernels' d = 256 instances and their zero-padded
    calls at d = 96 apart. The cast's times are the timing phase's measured
    publish row (cast_group over the 291 tensors of the Llama-3-8B state
    dict), its launches those of the main phase's run (five casting steps).
    The flash kernels' are one call at FLASH_TIMED (FLASH_TIMED_GEMMA for
    d = 256, FLASH_TIMED_PHI3 for d = 96 and simt; flash_timing), their
    launches those of the ring phase's paths (Llama-width bf16: sm90,
    Gemma-width bf16: sm90 at d = 256, fp32 at both widths: sm90_fp32,
    Gemma-width fp32: its d = 256 instance, Phi-3-mini-width bf16 and fp32:
    the padded calls, strides TMA refuses: simt)."""
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
    if "provision" in results:
        by_path["provision"] = results["provision"]["launches"]
    if "reshard" in results:
        by_path["reshard"] = sum(results["reshard"]["launches_by_step"].values())
    if "channel" in results:
        by_path["channel"] = results["channel"]["launches"]
    if "rl" in results:
        by_path["rl"] = sum(s["cast_launches"] for s in results["rl"]["steps"])
    if "direct_device" in results:
        by_path["direct_device"] = results["direct_device"]["launches"]
    if "runtime" in results:
        by_path["runtime"] = results["runtime"]["launches"]
    if "bulk" in results:
        by_path["bulk"] = results["bulk"]["launches"]
    if "spmd" in results:
        by_path["spmd"] = results["spmd"]["launches"]
    if "tiering" in results:
        by_path["tiering"] = results["tiering"]["launches"]
    if "healing" in results:
        by_path["healing"] = results["healing"]["launches"]
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
               + (f"; on provision: the prewarmed first put and its reput, the registered "
                  f"channel's first "
                  f"publish and the auto-hinted store's two puts, per leg "
                  f"{results['provision']['launches_by_leg']}" if "provision" in results else "")
               + (f"; on reshard (8 FSDP ranks) {results['reshard']['launches_by_step']}"
                  if "reshard" in results else "")
               + ("; on channel: 5 barrier publishes and one streamed publish of a fragment "
                  "per module" if "channel" in results else "")
               + ("; on rl: the learner process's publishes" if "rl" in results else "")
               + ("; on direct_device: the device rung's register and refreshes, and leg (e)'s "
                  "host-rung register, per publish "
                  f"{results['direct_device']['launches_per_publish']}"
                  if "direct_device" in results else "")
               + ("; on runtime: the colocated leg's 3 puts, the fault leg's 2 and the traced "
                  "process's 3 puts and 2 device-rung publishes" if "runtime" in results else "")
               + ("; on bulk: put, reput and reput2 over the bulk rung" if "bulk" in results
                  else "")
               + ("; on spmd: the two trainer ranks' put and reput, each of its half"
                  if "spmd" in results else "")
               + ("; on tiering: the channel's publishes v0..v4 and the durable put"
                  if "tiering" in results else "")
               + ("; on healing: the replicated put, the wedge and replication-1 legs' puts "
                  "and leg (h)'s re-puts" if "healing" in results else ""),
    }]
    fparity, ftiming, ring = results["flash_parity"], results["flash_timing"]["rows"], results["ring"]
    within = "within tolerance" if fparity["ok"] else "differs"
    sources = {"sm90": "torchstore_tpu_torch/csrc/flash_attention_sm90.cu",
               "sm90_fp32": "torchstore_tpu_torch/csrc/flash_attention_sm90_fp32.cu",
               "simt": "torchstore_tpu_torch/csrc/flash_attention.cu"}
    # (entry suffix, variant, timing row prefix and suffix, worst-error key,
    # launches, shape, input type). Launches: the sm90 kernel's d 64/128
    # instances on the ring phase's bf16 Llama-width path, its d = 256
    # instance on the Gemma-width one; the sm90_fp32 kernel's on the fp32
    # paths at both widths (its d = 256 instance's, on the Gemma-width one,
    # also apart); both kernels' zero-padded d = 96 calls on the
    # Phi-3-mini-width paths; the simt kernel's on the path whose strides
    # TMA refuses (bf16 and fp32).
    def added(a, b):
        return {mode: {v: n + b[mode][v] for v, n in by.items()} for mode, by in a.items()}

    fp32_launches = added(ring["fp32_launches"], ring["gemma"]["fp32_launches"])
    flavours = (
        ("sm90", "sm90", "", "", "sm90", ring["launches"], FLASH_TIMED, "bf16",
         "launches from the bf16 ring path"),
        ("sm90_fp32", "sm90_fp32", "", "_fp32", "sm90_fp32", fp32_launches, FLASH_TIMED,
         "fp32", "launches from the fp32 ring paths at Llama-3-8B and Gemma-7B width"),
        ("sm90_fp32_d256", "sm90_fp32", "gemma_", "_fp32", "sm90_fp32_d256",
         ring["gemma"]["fp32_launches"], FLASH_TIMED_GEMMA, "fp32",
         "launches from the Gemma-7B-width fp32 ring path (d = 256; counted in the "
         "sm90_fp32 entries too)"),
        ("simt", "simt", "rowpad_", "", "simt", ring["simt"]["launches"], FLASH_TIMED_PHI3,
         "bf16, q, k, v cut from rows of d + 2 (strides TMA refuses)",
         "launches from the ring phase's simt path (the same layout; bf16 and fp32)"),
        ("sm90_d256", "sm90", "gemma_", "", "sm90_d256", ring["gemma"]["launches"],
         FLASH_TIMED_GEMMA, "bf16", "launches from the Gemma-7B-width bf16 ring path"),
        ("sm90_pad", "sm90", "d96_", "", "sm90_pad", ring["phi3"]["launches"], FLASH_TIMED_PHI3,
         "bf16", "the d = 128 instance zero-padded; launches from the Phi-3-mini-width bf16 "
         "ring path"),
        ("sm90_fp32_pad", "sm90_fp32", "d96_", "_fp32", "sm90_fp32_pad",
         ring["phi3"]["fp32_launches"], FLASH_TIMED_PHI3, "fp32",
         "the d = 128 instance zero-padded; launches from the Phi-3-mini-width fp32 ring path"),
    )
    for suffix, variant, prefix, row_suffix, err_key, launches, shape, dtype, origin in flavours:
        b, s, h, hk, d = shape
        per = f"one call, b={b} sq=sk={s} h={h} hk={hk} d={d} {dtype}"
        for name, row_key, err in (("flash_stats", "flash_stats", "stats"),
                                   ("flash", "flash_causal", "o")):
            row = ftiming[prefix + row_key + row_suffix]
            entries.append({
                "name": f"{name}_{suffix}",
                "route": "cuda",
                "source": sources[variant],
                "replaces": "torchstore_tpu/ops/flash_attention.py:205",
                "launches": launches[name][variant],
                "max_abs_err": fparity["worst"][f"{err}_{err_key}"],
                "parity": within,
                "ms": row["ms"],
                "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"],
                "library": row["library"],
                "per": per + (", causal" if row["causal"] else ", not causal") + "; " + origin,
            })
    print(json.dumps({"kernels": entries}), flush=True)
    ok = (parity["ok"] and fparity["ok"] and ring["ok"] and all(e["launches"] for e in entries)
          and all(by_path.values()))
    return {"phase": "kernels", "ok": ok}


if __name__ == "__main__":
    sys.exit(main())
