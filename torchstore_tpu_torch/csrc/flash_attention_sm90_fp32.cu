// Blockwise (flash) attention in fp32 for Hopper (sm_90a): both products on
// the TF32 tensor cores with a 3xTF32 split, a TMA ring of k/v tiles behind
// mbarriers, producer-and-transform warpgroups and consumer warpgroups (one
// and two at d = 64 and 128, two and one at d = 256).
//
// Replaces the TPU kernel torchstore_tpu/ops/flash_attention.py::_kernel,
// launched by _flash_call (pl.pallas_call, :205), for fp32 q/k/v with any
// head dim d <= 256 with d % 8 == 0, in both of its modes:
//   EMIT_STATS = true  (flash_attention_stats, ring attention's per-hop body):
//     the unnormalized fp32 accumulator acc (b, h, sq, d) = sum_k p v and the
//     running max m and denominator l (b, h, sq);
//   EMIT_STATS = false (flash_attention): o = acc / max(l, 1e-30) in fp32,
//     laid out (b, sq, h, d).
// Scores are q.k^T times 1/sqrt(d), scaled after the product. ``causal``
// masks row >= col in the call's own coordinates with the reference's finite
// NEG_INF = -1e30; columns past sk take no part in the max or the sum; rows
// past sq are never stored; GQA maps q head i to kv head i / (h / hk) with
// no repeat. bf16 and fp16 calls run in flash_attention_sm90.cu; fp32 with
// strides TMA refuses runs in flash_attention.cu.
//
// Bound: operations. At b=1, h=32, hk=8, d=128, sq = sk = 8192 the two
// products take 4 b h sq sk d = 1.1e12 FLOP against ~0.34 GB of fp32 input
// and output: ~3200 FLOP per byte, far above the card's balance point. The
// CUDA cores run fp32 at 67 TFLOP/s (a 16.4 ms bound); the TF32 tensor cores
// at 495. Plain TF32 keeps 11 significant bits, errors of ~5e-4 on the
// scores, outside the port's fp32 tolerance (1e-5 + 1e-4 |want|). The
// 3xTF32 split keeps fp32 accuracy: x = hi + lo with hi = tf32(x) and
// lo = tf32(x - hi), and a.b = a_lo.b_hi + a_hi.b_lo + a_hi.b_hi (a_lo.b_lo,
// <= 2**-22 relative, is dropped), so the bound is three TF32 passes:
// 3 x 1.1e12 / 495e12 = 6.66 ms. What each choice does about it:
// - every product is wgmma.mma_async m64nNk8.f32.tf32.tf32, three passes
//   each, fp32 accumulators in registers. TF32 wgmma takes both operands
//   K-major (there is no transpose flag for it): q and k are K-major in
//   their (s, d) rows as loaded, v is not, so v is transposed into shared
//   memory as v^T (d rows of keys);
// - the splits are explicit (cvt.rna.tf32.f32, low 13 bits cleared), so
//   flash_attention.py's stats_blockwise_reference(split="tf32x3") repeats
//   the arithmetic up to the order of fp32 sums. k and v are split once per
//   k-tile by the producer warpgroups and shared by the consumers: k hi over
//   the raw k, k lo beside it, v^T hi and lo from a raw v landing buffer. p
//   is split in registers; l sums the fp32 p;
// - q stays raw in shared memory, and every product takes its A operand from
//   registers: each tile, a consumer splits its q fragments again, kQSteps
//   k-steps at a time, into one of two register buffers while the wgmma
//   group before runs (commit groups, wait_group 1). Two alternatives fail
//   on this card: q hi held in registers across the tile loop as a wgmma
//   operand makes ptxas serialize every wgmma (C7512) and spill, at both
//   head dims; q hi and lo both in shared memory (128 KB at d = 128) leave
//   room for one stage only. The re-split costs each consumer thread d/2
//   shared loads and conversions a tile;
// - S is two accumulator chains: q_lo k_hi^T + q_hi k_lo^T (small terms) and
//   q_hi k_hi^T, added once the products are done, so the small terms never
//   round against the large sum (the twin's (lo + lo) + hi order). P.V adds
//   p_lo v_hi, p_hi v_lo, then p_hi v_hi into o, pass by pass;
// - P.V reads p from registers. The m64k8 TF32 A fragment holds columns
//   (t, t + 4) of a thread's rows where the score accumulator holds columns
//   (2t, 2t + 1), so the keys of each 8-key group of v^T are stored in the
//   order 0 2 4 6 1 3 5 7: A column t is key 2t, column t + 4 key 2t + 1,
//   and p's registers feed the wgmma in the accumulator's order;
// - one thread of the producer warpgroups issues the TMA loads (q once, then
//   raw k and v per tile into a ring of kStages stages, or into one stage
//   by halves at d = 256); all their threads then split and transpose each
//   landed tile, fence it for the tensor cores and arrive on its ready
//   barrier. The loads of
//   tile t + 1 and the transform of t + 1 overlap the consumers' math on t;
//   the consumers spend no instructions on copies or on k and v's splits;
// - 128-byte swizzle everywhere: a 32-element fp32 row is 128 bytes, so a
//   d-column tile is d/32 boxes of 32 columns and a k-step of 8 fp32 is 32
//   bytes into a row, as a k-step of 16 bf16 is in flash_attention_sm90.cu;
//   v^T is written in the same swizzled layout, and the transform's reads
//   and writes are free of bank conflicts (a warp reads one row of 32
//   consecutive d, and a quarter-warp writes 8 rows whose swizzled chunks
//   differ);
// - budget. At d = 128 with 64-key tiles a stage (k hi, k lo, v^T hi, v^T
//   lo, raw v: 5 x 32 KB) and q (64 KB) leave no room for a second stage.
//   So the k-tile holds 32 keys at d = 128 (Tiling<D>): two stages of 5 x
//   16 KB and q's 64 KB take 224 KB of the 227 a block may use. A consumer
//   holds o (d/2 fp32 a thread), the two score chains (kBK/2 each), p hi and
//   lo (kBK/2 each) and two buffers of q hi and lo fragments (4 kQSteps
//   each): 64 + 32 + 32 + 32 = 160 at d = 128, at most 192 at d = 64 (64
//   keys a tile: two stages of 5 x 16 KB and q's 32 KB, 192 KB), in the 232
//   registers setmaxnreg gives it; the producer keeps 40 (128 x 40 + 256 x
//   232 = 64,512, the 384 x 168 allocated at launch), its transform holding
//   4 values and their hi at a time. Each wgmma's descriptor is a base plus
//   an immediate added inside its asm, so only the bases stay live;
// - budget at d = 256 (Tiling<256>). o alone is 128 fp32 a consumer thread,
//   and 128 rows of raw q would take 128 KB, so a CTA holds one consumer
//   warpgroup on 64 q rows (q: 64 KB), and the two other warpgroups both
//   transform (256 threads; 256 x 40 + 128 x 240 = 40,960 of the 64,512
//   registers allocated at launch). Two stages of 16-key tiles (5 x 16 KB
//   each) would fit, but at 16 keys the per-tile costs dominate: the q
//   re-split (d/2 values a thread a tile), m64n16 score wgmmas, the
//   softmax's shuffles and each tile's load latency. So d = 256 takes one
//   stage of 32-key tiles (5 x 32 KB; q and the stage, 224 KB) whose halves
//   refill apart (kStages = 1, barriers of its own for each half): raw k of
//   tile t + 1 lands once S of tile t has left k hi and k lo, and is split
//   while the consumer runs the softmax and P.V of t; raw v of t + 1 lands
//   as soon as v of t is transposed, and is transposed once P.V of t has
//   left v^T, while the consumer runs S of t + 1. S is m64n32k8 (32
//   k-steps, 3 passes), P.V m64n256k8 (4 k-steps, 3 passes). The consumer
//   holds o (128), the score chains, p hi and p lo (16 each) and the q
//   fragment buffers (32): at most 192 live in its 240. (On an H100 SXM at
//   700 W, Gemma-width K2 took 24.4-25.0 ms with two stages of 16 keys, and
//   25.3 ms with two consumer warpgroups on the same 64 rows taking
//   alternate 16-key tiles; this design measured 17.9 ms there);
// - one CTA per (b*h, q-tile of kBQ rows), heads fastest and the heaviest
//   causal q-tiles first; causal k-tiles wholly above a q-tile's last row
//   are never loaded, and the mask runs only on tiles that cross the
//   diagonal or the sk edge. No persistent grid and no overlap of the
//   softmax with the next tile's product yet.
// TMA tensor maps are rank 4 over (d, s, h, b) with the tensor's own strides
// (no transpose or copy), built on the host at each call with
// cuTensorMapEncodeTiled fetched through cudaGetDriverEntryPoint (no -lcuda);
// boxes past the sequence ends fill with zeros.
// Head dims between the instances' (64, 128, 256) run on the next one up,
// D, with d zero-padded to D: the maps' innermost dimension is the real d,
// so a box that crosses d reads zeros past it; the boxes that lie wholly
// past d (at d = 96 under D = 128, the fourth of 32 columns) are never
// loaded (the barriers expect only the loaded boxes' bytes), and every
// thread zeroes them once, before the first load: raw q, and in each stage
// raw k (split in place into zero hi and lo) and raw v (transposed into
// zero rows of v^T). Zero columns of q and k add nothing to q.k^T and zero
// columns of v make output columns that are never stored; the scale is the
// caller's 1/sqrt(d) of the real d, and the epilogue stores d columns.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (torchstore_tpu_torch/ops/flash_attention.py). The launch goes
// on the caller's stream, does not synchronise and allocates nothing; the
// return value is the CUDA error of the launch (0 on success) or one of the
// kBad* codes below.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's finite mask value
constexpr float kFloor = 1e-30f;   // the reference's denominator floor
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 384;  // producer warpgroups first, then one consumer per 64 q rows
constexpr int kProducerRegs = 40;
constexpr int kRowBytes = 128;  // one row of a 32-column box of fp32 values
constexpr int kBoxCols = 32;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use
constexpr int kBadKind = -1;
constexpr int kBadHeadDim = -2;
constexpr int kBadShape = -3;
constexpr int kBadLayout = -4;     // alignment or strides TMA refuses
constexpr int kBadTensorMap = -5;  // cuTensorMapEncodeTiled refused the map
constexpr int kNoDriver = -6;      // cuTensorMapEncodeTiled not found

struct Params {
  float* out;  // acc (b, h, sq, d), or o (b, sq, h, d)
  float* m;    // (b, h, sq), stats mode only
  float* l;
  int h, hk, sq, sk;
  int d;  // the real head dim, d <= D, d % 8 == 0
  int causal;
  float scale;
};

// Per head dim: keys per k/v tile (flash_attention.py's SM90_FP32_BLOCK_K
// repeats kBK), q rows per CTA (one consumer warpgroup per 64), the
// registers setmaxnreg gives a consumer thread, and the stages of k and v.
// With two stages each stage is one unit behind one set of barriers; with
// one (d = 256) its k half and its v half are refilled apart, each behind
// barriers of its own, so the next tile's k loads during this tile's
// softmax and P.V, and its v during the next S.
template <int D>
struct Tiling {
  static constexpr int kBK = D == 64 ? 64 : 32;
  static constexpr int kBQ = D == 256 ? 64 : 128;
  static constexpr int kConsumerRegs = D == 256 ? 240 : 232;
  static constexpr int kStages = D == 256 ? 1 : 2;
};

// Shared memory, in bytes from a 1024-byte aligned base: q, then kStages
// stages, then the barriers. A q tile is D/32 boxes of kBQ rows; a stage
// holds k hi (where raw k lands), k lo and raw v, each D/32 boxes of kBK
// rows, and v^T hi and lo, each kBK/32 boxes of D rows.
template <int D>
struct Layout {
  static constexpr int kBK = Tiling<D>::kBK;
  static constexpr int kBQ = Tiling<D>::kBQ;
  static constexpr int kStages = Tiling<D>::kStages;
  static constexpr int kConsumers = 2 * kBQ;  // 128 threads per 64 q rows
  static constexpr int kTransformers = kThreads - kConsumers;
  static constexpr int kQBox = kBQ * kRowBytes;
  static constexpr int kKBox = kBK * kRowBytes;
  static constexpr int kVtBox = D * kRowBytes;
  static constexpr int kQTile = (D / kBoxCols) * kQBox;
  static constexpr int kKTile = (D / kBoxCols) * kKBox;
  static constexpr int kVtTile = (kBK / kBoxCols) * kVtBox;
  static constexpr int kKh = 0;
  static constexpr int kKl = kKTile;
  static constexpr int kVraw = 2 * kKTile;
  static constexpr int kVth = 3 * kKTile;
  static constexpr int kVtl = 3 * kKTile + kVtTile;
  static constexpr int kStage = 3 * kKTile + 2 * kVtTile;
  static constexpr int kQ = 0;
  static constexpr int kStages0 = kQTile;
  static constexpr int kBar = kStages0 + kStages * kStage;
  // barrier indices: q full, raw full[s], ready[s], empty[s]; with one
  // stage these three are its k half's, and its v half has its own three
  static constexpr int kQFull = 0;
  static constexpr int kRawFull = 1;
  static constexpr int kReady = 1 + kStages;
  static constexpr int kEmpty = 1 + 2 * kStages;
  static constexpr int kVRawFull = 1 + 3 * kStages;
  static constexpr int kVReady = kVRawFull + 1;
  static constexpr int kVEmpty = kVRawFull + 2;
  static constexpr int kBytes = kBar + 8 * (4 + 3 * kStages) + 1024;  // + alignment slack
};

// What each instance needs of its Layout: it fits, its tiles split evenly
// over the transform threads, its stages keep the swizzle's 1024-byte
// alignment, and its register split fits the 384 x 168 allocated at launch.
template <int D>
constexpr bool layout_ok() {
  using L = Layout<D>;
  return L::kBytes <= kSmemLimit && L::kKTile % (16 * L::kTransformers) == 0 &&
         (D * L::kBK / 8) % L::kTransformers == 0 && L::kStage % 1024 == 0 &&
         L::kQTile % 1024 == 0 && L::kVtTile % 1024 == 0 &&
         L::kTransformers * kProducerRegs + L::kConsumers * Tiling<D>::kConsumerRegs <=
             kThreads * 168;
}
static_assert(layout_ok<64>(), "d = 64 layout");
static_assert(layout_ok<128>(), "d = 128 layout");
static_assert(layout_ok<256>(), "d = 256 layout");

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

// Wait until the barrier's phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a rank-4 (d, s, h, b) tensor map into shared memory; completes
// its bytes on ``bar``.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Generic-proxy writes to shared memory made visible to the async proxy
// (wgmma operands, later TMA writes to the same bytes).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ float lds(uint32_t addr) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(x) : "r"(addr) : "memory");
  return x;
}
__device__ __forceinline__ float4 lds4(uint32_t addr) {
  float4 x;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
               : "r"(addr)
               : "memory");
  return x;
}
__device__ __forceinline__ void sts4(uint32_t addr, uint32_t a, uint32_t b, uint32_t c,
                                     uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "r"(a), "r"(b), "r"(c),
               "r"(d)
               : "memory");
}

// Zeroes ``bytes`` (a multiple of 16) of shared memory from ``addr`` with
// every thread of the block.
__device__ __forceinline__ void zero_smem(uint32_t addr, int bytes) {
  for (int i = threadIdx.x * 16; i < bytes; i += kThreads * 16) sts4(addr + i, 0, 0, 0, 0);
}

// x = hi + lo to TF32 precision: hi = tf32(x) rounded to nearest (ties away
// from zero), lo = tf32(x - hi); both as fp32 bit patterns with the low 13
// bits clear (ptxas expands cvt.rna.tf32.f32 to an add of 0x1000 to the
// magnitude bits and a mask of them, so no second mask is needed).
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// wgmma shared-memory descriptor, 128-byte swizzle, K-major: ``sbo`` bytes
// between 8-row groups (the leading offset is unused for this layout).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  constexpr uint32_t lbo = 16, sbo = 1024;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pins registers in place around asynchronous wgmma: no access to them
// moves across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The TF32 wgmma forms. Each takes the accumulator d[0..N/2) of one thread
// (the m64nN fp32 layout) as "+f" operands %0..%(N/2 - 1), then its inputs.
#define TST_F8(i)                                                                             \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define TST_ACC16 TST_F8(0), TST_F8(8)
#define TST_ACC32 TST_ACC16, TST_F8(16), TST_F8(24)
#define TST_ACC64 TST_ACC32, TST_F8(32), TST_F8(40), TST_F8(48), TST_F8(56)
#define TST_ACC128                                                                      \
  TST_ACC64, TST_F8(64), TST_F8(72), TST_F8(80), TST_F8(88), TST_F8(96), TST_F8(104), \
      TST_F8(112), TST_F8(120)
#define TST_REGS16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define TST_REGS32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define TST_REGS64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define TST_REGS128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63," \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79," \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95," \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111," \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"

// D (64 x N, fp32) += A (64 x 8, registers) * B (N x 8, smem, K-major)^T.
#define TST_WGMMA_RS(N, REGS, ACC, A0, A1, A2, A3, IB, IS, IOB)                          \
  asm volatile("{\n.reg .pred p;\n.reg .b64 db;\nsetp.ne.b32 p, %" IS ", 0;\n"          \
               "add.s64 db, %" IB ", %" IOB ";\n"                                         \
               "wgmma.mma_async.sync.aligned.m64n" N "k8.f32.tf32.tf32 " REGS ", {%" A0 \
               ", %" A1 ", %" A2 ", %" A3 "}, db, p, 1, 1;\n}\n"                       \
               : ACC                                                                    \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(OB))

// D (64 x N) += A B^T with B at db + OB; scale_d = 0 overwrites D.
template <int N, int OB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t* a, uint64_t db,
                                         int scale_d = 1) {
  static_assert(N == 32 || N == 64 || N == 128 || N == 256, "tile width");
  if constexpr (N == 32) {
    TST_WGMMA_RS("32", TST_REGS16, TST_ACC16, "16", "17", "18", "19", "20", "21", "22");
  } else if constexpr (N == 64) {
    TST_WGMMA_RS("64", TST_REGS32, TST_ACC32, "32", "33", "34", "35", "36", "37", "38");
  } else if constexpr (N == 128) {
    TST_WGMMA_RS("128", TST_REGS64, TST_ACC64, "64", "65", "66", "67", "68", "69", "70");
  } else {
    TST_WGMMA_RS("256", TST_REGS128, TST_ACC128, "128", "129", "130", "131", "132", "133",
                 "134");
  }
}

// Descriptor offset (bytes / 16) of k-step ``k`` (8 fp32 = 32 bytes) in a
// tile of 32-column boxes ``box`` bytes apart.
__host__ __device__ constexpr int kstep(int k, int box) {
  return ((k / 4) * box + (k % 4) * 32) / 16;
}

// k-steps K..KEND-1 of D += A_regs * B^T; A's fragment of step k is a[4k..4k+3].
template <int N, int BOXB, int K, int KEND>
__device__ __forceinline__ void rs_steps(float (&d)[N / 2], const uint32_t* a, uint64_t db) {
  if constexpr (K < KEND) {
    wgmma_rs<N, kstep(K, BOXB)>(d, a + 4 * K, db);
    rs_steps<N, BOXB, K + 1, KEND>(d, a, db);
  }
}

// k-steps K0 + J .. K0 + NK - 1 of S with A fragments hi, lo [4J .. 4J + 3]:
// q_lo k_hi^T and q_hi k_lo^T into s_lo, q_hi k_hi^T into s (two chains,
// so the small terms never round against the large sum); step 0
// overwrites both.
template <int N, int BOX, int K0, int J, int NK>
__device__ __forceinline__ void s_steps(float (&s)[N / 2], float (&s_lo)[N / 2],
                                        const uint32_t* hi, const uint32_t* lo, uint64_t d_kh,
                                        uint64_t d_kl) {
  if constexpr (J < NK) {
    constexpr int off = kstep(K0 + J, BOX);
    wgmma_rs<N, off>(s_lo, lo + 4 * J, d_kh, K0 + J > 0);
    wgmma_rs<N, off>(s, hi + 4 * J, d_kh, K0 + J > 0);
    wgmma_rs<N, off>(s_lo, hi + 4 * J, d_kl);
    s_steps<N, BOX, K0, J + 1, NK>(s, s_lo, hi, lo, d_kh, d_kl);
  }
}

// This thread's TF32 A fragments of q for k-steps K0 .. K0 + NK - 1 (d
// columns 8k .. 8k + 7), split from raw q in shared memory: hi[4j + r] and
// lo[4j + r] of step K0 + j hold rows (g, g + 8, g, g + 8) of the warp's 16,
// columns (t, t, t + 4, t + 4), from 128-byte swizzled boxes of BQ rows.
template <int BQ, int K0, int NK>
__device__ __forceinline__ void q_fragments(uint32_t (&hi)[4 * NK], uint32_t (&lo)[4 * NK],
                                            uint32_t q_rows, int group, int quad) {
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    const int kk = K0 + j;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int chunk = 2 * (kk % 4) + (r >> 1);
      split(lds(q_rows + (kk / 4) * (BQ * kRowBytes) + (r & 1) * 8 * kRowBytes +
                ((chunk ^ group) * 16) + quad * 4),
            hi[4 * j + r], lo[4 * j + r]);
    }
  }
}

// S over k-steps G * NK .. D/8 - 1, one commit group of NK k-steps at a
// time, each k-step as q_lo k_hi^T, q_hi k_lo^T, q_hi k_hi^T; the first
// wgmma overwrites S. Group G's fragments go to buffer G % 2 once group
// G - 2, which read that buffer, has completed (at most one group left in
// flight), so splitting overlaps the tensor cores.
template <int D, int kBK, int NK, int G>
__device__ __forceinline__ void s_product(float (&s)[kBK / 2], float (&s_lo)[kBK / 2],
                                          uint32_t (&qh)[2][4 * NK], uint32_t (&ql)[2][4 * NK],
                                          uint32_t q_rows, uint64_t d_kh, uint64_t d_kl,
                                          int group, int quad) {
  if constexpr (G * NK < D / 8) {
    constexpr int kKBox = kBK * kRowBytes;
    if constexpr (G >= 2) wgmma_wait<1>();
    q_fragments<Tiling<D>::kBQ, G * NK, NK>(qh[G % 2], ql[G % 2], q_rows, group, quad);
    wgmma_fence();
    s_steps<kBK, kKBox, G * NK, 0, NK>(s, s_lo, qh[G % 2], ql[G % 2], d_kh, d_kl);
    wgmma_commit();
    s_product<D, kBK, NK, G + 1>(s, s_lo, qh, ql, q_rows, d_kh, d_kl, group, quad);
  }
}

// The producer warpgroups' share of one landed stage: k hi over raw k and k
// lo beside it (the same swizzled offsets), then v^T hi and lo from raw v.
// v^T row d holds the tile's keys in 32-key boxes, each 8-key group in the
// order 0 2 4 6 1 3 5 7 (two 16-byte chunks), swizzled by d % 8.
template <int D>
__device__ __forceinline__ void transform_k(uint32_t stage, int tid) {
  using L = Layout<D>;
#pragma unroll 1
  for (int i = 0; i < L::kKTile / 16 / L::kTransformers; ++i) {
    const uint32_t off = stage + (uint32_t)(i * L::kTransformers + tid) * 16;
    const float4 x = lds4(off + L::kKh);
    const uint32_t h0 = tf32(x.x), h1 = tf32(x.y), h2 = tf32(x.z), h3 = tf32(x.w);
    sts4(off + L::kKh, h0, h1, h2, h3);
    sts4(off + L::kKl, tf32(x.x - __uint_as_float(h0)), tf32(x.y - __uint_as_float(h1)),
         tf32(x.z - __uint_as_float(h2)), tf32(x.w - __uint_as_float(h3)));
  }
}
template <int D>
__device__ __forceinline__ void transform_v(uint32_t stage, int tid) {
  using L = Layout<D>;
  constexpr int kBK = L::kBK;
  constexpr int kTransformers = L::kTransformers;
#pragma unroll 1
  for (int i = 0; i < D * kBK / 8 / kTransformers; ++i) {
    const int item = i * kTransformers + tid;
    const int d = item % D;
    const int g = item / D;  // 8-key group of the tile
    // Raw v: key row 8g + kk of box d / 32; its 16-byte chunk (d % 32) / 4
    // sits at chunk ((d % 32) / 4) ^ kk of the row.
    const uint32_t raw = stage + L::kVraw + (d / kBoxCols) * L::kKBox + (8 * g) * kRowBytes +
                         (d % 4) * 4;
    const int chunk = (d % kBoxCols) / 4;
    const uint32_t row = stage + (g / 4) * L::kVtBox + d * kRowBytes;
    // Even keys to chunk 2 (g % 4), odd keys to the next, swizzled by d % 8.
#pragma unroll
    for (int odd = 0; odd < 2; ++odd) {
      float x[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = 2 * j + odd;
        x[j] = lds(raw + kk * kRowBytes + ((chunk ^ kk) * 16));
      }
      const uint32_t c = row + ((2 * (g % 4) + odd) ^ (d % 8)) * 16;
      const uint32_t h0 = tf32(x[0]), h1 = tf32(x[1]), h2 = tf32(x[2]), h3 = tf32(x[3]);
      sts4(c + L::kVth, h0, h1, h2, h3);
      sts4(c + L::kVtl, tf32(x[0] - __uint_as_float(h0)), tf32(x[1] - __uint_as_float(h1)),
           tf32(x[2] - __uint_as_float(h2)), tf32(x[3] - __uint_as_float(h3)));
    }
  }
}
template <int D>
__device__ __forceinline__ void transform_stage(uint32_t stage, int tid) {
  transform_k<D>(stage, tid);
  transform_v<D>(stage, tid);
}

// The producer warpgroups meet at named barrier 1 (0 is __syncthreads).
__device__ __forceinline__ void producers_sync(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

template <int D, bool EMIT_STATS>
__global__ void __launch_bounds__(kThreads, 1)
    flash_sm90_fp32_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using L = Layout<D>;
  constexpr int kBK = L::kBK;
  constexpr int kBQ = L::kBQ;
  constexpr int kStages = L::kStages;
  constexpr int kBoxes = D / kBoxCols;
  constexpr int kQSteps = 2;  // k-steps of S per commit group
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + L::kBar;
  auto bar = [&](int i) { return bars + 8u * (uint32_t)i; };
  auto stage_at = [&](int s) { return base + L::kStages0 + (uint32_t)(s * L::kStage); };

  const int bh = blockIdx.x;
  const int bi = bh / p.h;
  const int head = bh % p.h;
  const int kvh = head / (p.h / p.hk);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest causal q-tiles first
  const int q_last = min(q0 + kBQ, p.sq) - 1;
  int n_tiles = (p.sk + kBK - 1) / kBK;
  if (p.causal) n_tiles = min(n_tiles, q_last / kBK + 1);
  // 32-column boxes of a tile that hold some of the d columns; the rest of
  // the kBoxes lie wholly past d and stay zero.
  const int n_boxes = (p.d + kBoxCols - 1) / kBoxCols;

  if (threadIdx.x == 0) {
    mbar_init(bar(L::kQFull), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar(L::kRawFull + s), 1);
      mbar_init(bar(L::kReady + s), L::kTransformers);
      mbar_init(bar(L::kEmpty + s), L::kConsumers);
    }
    if (kStages == 1) {
      mbar_init(bar(L::kVRawFull), 1);
      mbar_init(bar(L::kVReady), L::kTransformers);
      mbar_init(bar(L::kVEmpty), L::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (n_boxes < kBoxes) {
    zero_smem(base + L::kQ + n_boxes * L::kQBox, L::kQTile - n_boxes * L::kQBox);
    for (int s = 0; s < kStages; ++s) {
      zero_smem(stage_at(s) + L::kKh + n_boxes * L::kKBox, L::kKTile - n_boxes * L::kKBox);
      zero_smem(stage_at(s) + L::kVraw + n_boxes * L::kKBox, L::kKTile - n_boxes * L::kKBox);
    }
    fence_proxy_async();  // visible to the wgmmas that read them
  }
  __syncthreads();

  if (threadIdx.x < L::kTransformers) {
    // Producer warpgroups: thread 0 issues every load; all their threads
    // split and transpose each landed stage.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    const int tid = threadIdx.x;
    const uint32_t tile_bytes = n_boxes * L::kKBox;
    if (tid == 0) {
      mbar_expect_tx(bar(L::kQFull), n_boxes * L::kQBox);
#pragma unroll
      for (int x = 0; x < kBoxes; ++x)
        if (x < n_boxes)
          tma_load(base + L::kQ + x * L::kQBox, &tm_q, bar(L::kQFull), kBoxCols * x, q0, head,
                   bi);
    }
    if constexpr (kStages == 1) {
      // One stage refilled by halves: raw k lands in k hi once S of the tile
      // before has left k hi and k lo, raw v in its landing tile once this
      // warpgroup pair has transformed the tile before.
      const uint32_t stage = stage_at(0);
      // Tile t of k or v (D/32 boxes of kBK rows) to ``dst``, its bytes
      // completing on barrier ``full``.
      auto load = [&](const CUtensorMap* map, uint32_t dst, int full, int t) {
        mbar_expect_tx(bar(full), tile_bytes);
#pragma unroll
        for (int x = 0; x < kBoxes; ++x)
          if (x < n_boxes)
            tma_load(dst + x * L::kKBox, map, bar(full), kBoxCols * x, t * kBK, kvh, bi);
      };
      auto load_k = [&](int t) { load(&tm_k, stage + L::kKh, L::kRawFull, t); };
      auto load_v = [&](int t) { load(&tm_v, stage + L::kVraw, L::kVRawFull, t); };
      if (tid == 0) {
        load_k(0);
        load_v(0);
      }
      for (int t = 0; t < n_tiles; ++t) {
        mbar_wait(bar(L::kRawFull), t & 1);
        transform_k<D>(stage, tid);
        fence_proxy_async();
        mbar_arrive(bar(L::kReady));
        mbar_wait(bar(L::kVRawFull), t & 1);
        mbar_wait(bar(L::kVEmpty), (t & 1) ^ 1);  // P.V of tile t - 1 has left v^T
        transform_v<D>(stage, tid);
        fence_proxy_async();
        mbar_arrive(bar(L::kVReady));
        if (t + 1 < n_tiles) {
          producers_sync(L::kTransformers);  // every thread has read raw v
          if (tid == 0) {
            load_v(t + 1);
            mbar_wait(bar(L::kEmpty), t & 1);  // S of tile t has left k
            load_k(t + 1);
          }
        }
      }
      return;
    }
    // Raw k into the stage's k hi tile, raw v into its landing tile; the
    // stage is free once the consumers are done with tile t - kStages.
    auto issue = [&](int t) {
      const int s = t % kStages;
      mbar_wait(bar(L::kEmpty + s), ((t / kStages) & 1) ^ 1);  // the first round passes at once
      mbar_expect_tx(bar(L::kRawFull + s), 2 * tile_bytes);
#pragma unroll
      for (int x = 0; x < kBoxes; ++x) {
        if (x >= n_boxes) continue;
        tma_load(stage_at(s) + L::kKh + x * L::kKBox, &tm_k, bar(L::kRawFull + s),
                 kBoxCols * x, t * kBK, kvh, bi);
        tma_load(stage_at(s) + L::kVraw + x * L::kKBox, &tm_v, bar(L::kRawFull + s),
                 kBoxCols * x, t * kBK, kvh, bi);
      }
    };
    if (tid == 0) issue(0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      mbar_wait(bar(L::kRawFull + s), (t / kStages) & 1);
      transform_stage<D>(stage_at(s), tid);
      fence_proxy_async();
      mbar_arrive(bar(L::kReady + s));
      if (tid == 0 && t + 1 < n_tiles) issue(t + 1);
    }
  } else {
    // Consumer warpgroups: wg w owns q rows 64 w .. 64 w + 63 of the tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(Tiling<D>::kConsumerRegs));
    const int wg = (threadIdx.x - L::kTransformers) / 128;
    const int tid = threadIdx.x % 128;
    const int quad = tid & 3;
    const int group = (tid % 32) / 4;
    // This thread's two rows of the accumulator layout: row0 and row0 + 8.
    const int row0 = q0 + 64 * wg + 16 * (tid / 32) + group;
    const int wg_first_row = q0 + 64 * wg;

    // Raw q stays in shared memory; each tile splits this thread's A
    // fragments again, kQSteps k-steps at a time (see s_product).
    const uint32_t q_rows = base + L::kQ + (64 * wg + 16 * (tid / 32) + group) * kRowBytes;
    mbar_wait(bar(L::kQFull), 0);

    float s[kBK / 2];
    float s_lo[kBK / 2];
    float o[D / 2];
    uint32_t qh[2][4 * kQSteps];  // two groups' A fragments in flight at once
    uint32_t ql[2][4 * kQSteps];
    uint32_t ph[kBK / 2];
    uint32_t pl[kBK / 2];
    float m_r[2] = {kNegInf, kNegInf};
    float l_r[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kStages;
      const uint32_t stage = stage_at(st);
      const int k0 = t * kBK;

      // S = q_lo k_hi^T + q_hi k_lo^T + q_hi k_hi^T over D/8 k-steps of 8,
      // in commit groups of kQSteps k-steps; a group's q fragments are
      // split into one of two register buffers while the group before runs.
      const uint64_t d_kh = desc_sw128(stage + L::kKh), d_kl = desc_sw128(stage + L::kKl);
      mbar_wait(bar(L::kReady + st), (t / kStages) & 1);
      __syncwarp();
      s_product<D, kBK, kQSteps, 0>(s, s_lo, qh, ql, q_rows, d_kh, d_kl, group, quad);
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(s_lo);
      if constexpr (kStages == 1) mbar_arrive(bar(L::kEmpty));  // S has left k
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) s[i] += s_lo[i];

      // Scale, mask (only tiles that cross the diagonal or the sk edge),
      // row max. s[i]: row row0 + 8 * ((i >> 1) & 1), column
      // k0 + 8 * (i >> 2) + 2 * quad + (i & 1).
      float mx[2] = {-INFINITY, -INFINITY};
      const bool edge = k0 + kBK > p.sk;
      const bool diag = p.causal && k0 + kBK - 1 > wg_first_row;
      if (edge || diag) {
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) {
          const int r = (i >> 1) & 1;
          const int col = k0 + 8 * (i >> 2) + 2 * quad + (i & 1);
          float x = s[i] * p.scale;
          if (col >= p.sk) {
            x = -INFINITY;  // past the block: no part in max or sum
          } else if (p.causal && col > row0 + 8 * r) {
            x = kNegInf;
          }
          s[i] = x;
          mx[r] = fmaxf(mx[r], x);
        }
      } else {
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) {
          s[i] *= p.scale;
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
        }
      }
      float corr[2];
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_r[r], mx[r]);
        corr[r] = ex2((m_r[r] - m_new) * kLog2e);
        m_r[r] = m_new;
      }
      // p = exp(s - m) in fp32; l sums the fp32 p.
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const int r = (i >> 1) & 1;
        s[i] = ex2((s[i] - m_r[r]) * kLog2e);
        sum[r] += s[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l_r[r] = l_r[r] * corr[r] + sum[r];
      }
      // p's A fragments of the P.V k-steps (8 keys each): A column t is key
      // 2t and column t + 4 key 2t + 1 (v^T's order), so registers
      // (row0, 2t), (row0 + 8, 2t), (row0, 2t + 1), (row0 + 8, 2t + 1).
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        split(s[4 * j + 0], ph[4 * j + 0], pl[4 * j + 0]);
        split(s[4 * j + 2], ph[4 * j + 1], pl[4 * j + 1]);
        split(s[4 * j + 1], ph[4 * j + 2], pl[4 * j + 2]);
        split(s[4 * j + 3], ph[4 * j + 3], pl[4 * j + 3]);
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];

      // o += p_lo v_hi + p_hi v_lo + p_hi v_hi: kBK / 8 k-steps of 8 keys;
      // v^T's 32-key boxes are kVtBox apart.
      const uint64_t d_vth = desc_sw128(stage + L::kVth), d_vtl = desc_sw128(stage + L::kVtl);
      fence_regs(ph);
      fence_regs(pl);
      fence_regs(o);
      if constexpr (kStages == 1) {
        mbar_wait(bar(L::kVReady), t & 1);
        __syncwarp();
      }
      wgmma_fence();
      rs_steps<D, L::kVtBox, 0, kBK / 8>(o, pl, d_vth);
      rs_steps<D, L::kVtBox, 0, kBK / 8>(o, ph, d_vtl);
      rs_steps<D, L::kVtBox, 0, kBK / 8>(o, ph, d_vth);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(ph);  // p stays in its registers until the wgmma has read it
      fence_regs(pl);
      mbar_arrive(bar(kStages == 1 ? L::kVEmpty : L::kEmpty + st));
    }

    // Epilogue: o[4j + 2r + e] is row row0 + 8r, column 8j + 2 quad + e.
    // Rows are d long; the 8-column groups j >= d / 8 are padding.
    const int d_groups = p.d / 8;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= p.sq) continue;
      const int64_t stat_row = (int64_t)bh * p.sq + row;  // (b, h, sq) row
      if (EMIT_STATS) {
        float* acc = p.out + stat_row * p.d;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          if (j < d_groups)
            *reinterpret_cast<float2*>(acc + 8 * j + 2 * quad) =
                make_float2(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
        if (quad == 0) {
          p.m[stat_row] = m_r[r];
          p.l[stat_row] = l_r[r];
        }
      } else {
        const float denom = fmaxf(l_r[r], kFloor);
        float* out = p.out + (((int64_t)bi * p.sq + row) * p.h + head) * p.d;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          if (j < d_groups)
            *reinterpret_cast<float2*>(out + 8 * j + 2 * quad) =
                make_float2(o[4 * j + 2 * r] / denom, o[4 * j + 2 * r + 1] / denom);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A rank-4 (d, s, h, b) map of fp32 values with 32 x ``rows`` boxes,
// 128-byte swizzle, zero fill past the ends (past d as well as past s).
// Strides in elements.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int d, int s, int heads,
              int b, int64_t sb, int64_t ss, int64_t sh, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)heads, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 4, (cuuint64_t)sh * 4, (cuuint64_t)sb * 4};
  const cuuint32_t box[4] = {(cuuint32_t)kBoxCols, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// TMA takes 16-byte aligned bases and strides: 4 fp32 elements.
bool tma_ok(const void* ptr, int64_t sb, int64_t ss, int64_t sh) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb > 0 && ss > 0 && sh > 0 &&
         sb % 4 == 0 && ss % 4 == 0 && sh % 4 == 0;
}

struct Call {
  const void *q, *k, *v;
  int b, h, hk, sq, sk, d;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
};

template <int D, bool EMIT_STATS>
int launch(const Call& c, const Params& p, cudaStream_t stream) {
  using L = Layout<D>;
  if ((c.sq + L::kBQ - 1) / L::kBQ > 65535) return kBadShape;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kNoDriver;
  CUtensorMap tq, tk, tv;
  if (!make_map(encode, &tq, c.q, c.d, c.sq, c.h, c.b, c.q_sb, c.q_ss, c.q_sh, L::kBQ) ||
      !make_map(encode, &tk, c.k, c.d, c.sk, c.hk, c.b, c.k_sb, c.k_ss, c.k_sh, L::kBK) ||
      !make_map(encode, &tv, c.v, c.d, c.sk, c.hk, c.b, c.v_sb, c.v_ss, c.v_sh, L::kBK))
    return kBadTensorMap;
  auto kernel = flash_sm90_fp32_kernel<D, EMIT_STATS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(c.b * p.h, (p.sq + L::kBQ - 1) / L::kBQ);
  kernel<<<grid, kThreads, L::kBytes, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

// The instance of the next head dim up: flash_attention.py's
// padded_head_dim repeats the rule.
template <bool EMIT_STATS>
int dispatch_d(const Call& c, const Params& p, cudaStream_t stream) {
  if (c.d > 128) return launch<256, EMIT_STATS>(c, p, stream);
  if (c.d > 64) return launch<128, EMIT_STATS>(c, p, stream);
  return launch<64, EMIT_STATS>(c, p, stream);
}

}  // namespace

// kind: 0 fp32 (q, k, v and, in the normalized mode, o). q (b, sq, h, d), k
// and v (b, sk, hk, d), unit d stride; strides in elements. Size-1
// dimensions must come with a valid stride (the caller passes the
// contiguous one).
extern "C" int tst_flash_sm90_fp32(const void* q, const void* k, const void* v, void* out,
                                   float* m, float* l, int kind, int emit_stats, int causal,
                                   int b, int h, int hk, int sq, int sk, int d, int64_t q_sb,
                                   int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
                                   int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
                                   float scale, void* stream) {
  if (kind != 0) return kBadKind;
  if (d <= 0 || d > 256 || d % 8 != 0) return kBadHeadDim;
  if (b <= 0 || h <= 0 || hk <= 0 || h % hk != 0 || sq <= 0 || sk <= 0) return kBadShape;
  if (!tma_ok(q, q_sb, q_ss, q_sh) || !tma_ok(k, k_sb, k_ss, k_sh) || !tma_ok(v, v_sb, v_ss, v_sh))
    return kBadLayout;
  const Call c{q, k, v, b, h, hk, sq, sk, d, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  const Params p{static_cast<float*>(out), m, l, h, hk, sq, sk, d, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return emit_stats != 0 ? dispatch_d<true>(c, p, s) : dispatch_d<false>(c, p, s);
}
