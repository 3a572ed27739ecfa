// Blockwise (flash) attention for Hopper (sm_90a): bf16 wgmma, a TMA ring of
// k/v tiles behind mbarriers, one producer and two consumer warpgroups.
//
// Replaces the TPU kernel torchstore_tpu/ops/flash_attention.py::_kernel,
// launched by _flash_call (pl.pallas_call, :205), for bf16 q/k/v with head
// dim d in {64, 128}, in both of its modes:
//   EMIT_STATS = true  (flash_attention_stats, ring attention's per-hop body):
//     the unnormalized fp32 accumulator acc (b, h, sq, d) = sum_k p v and the
//     running max m and denominator l (b, h, sq), fp32;
//   EMIT_STATS = false (flash_attention): o = acc / max(l, 1e-30) in bf16,
//     laid out (b, sq, h, d).
// Scores are fp32 q.k^T times 1/sqrt(d). ``causal`` masks row >= col in the
// call's own coordinates with the reference's finite NEG_INF = -1e30;
// columns past sk take no part in the max or the sum; rows past sq are never
// stored; GQA maps q head i to kv head i / (h / hk) with no repeat. Other
// shapes and types run on the fp32 kernel in flash_attention.cu.
//
// Bound: operations. At b=1, h=32, hk=8, d=128, sq = sk = 8192 the two
// products take 4 b h sq sk d = 1.1e12 FLOP against ~0.24 GB of input and
// output: ~5000 FLOP per byte, far above the card's ~295, so only the bf16
// tensor cores (989 TFLOP/s) can approach the bound. What each choice does
// about it:
// - both products are wgmma.mma_async m64nNk16 bf16 with fp32 accumulators
//   in registers: S = q.k^T reads q and k from shared memory (K-major); P.V
//   reads p from registers (rounded to bf16, as FlashAttention-2/3 and
//   PyTorch's SDPA do; l is summed from the fp32 p) and v from shared memory
//   (MN-major, the transpose flag set). The CUDA cores keep only the online
//   softmax: row max and sum over the 4 threads that share a row of the
//   accumulator layout, exp2 on the special-function unit;
// - one elected producer thread issues TMA loads: q once, then k and v tiles
//   into a ring of kStages stages, each with its own k-full and v-full
//   barrier (q.k^T starts before v lands) and an empty barrier the 256
//   consumer threads arrive on. The loads of tile t+1 overlap the math of
//   tile t; the consumers spend no instructions or registers on copies;
// - 128-byte swizzle everywhere: a 128-element bf16 row is 256 bytes, so a
//   tile is two 64-column boxes, each the canonical swizzled layout wgmma's
//   descriptors read without bank conflicts;
// - setmaxnreg moves registers from the producer (40) to the consumers
//   (232): a consumer holds the 64 x 128 score tile and the 64 x d output
//   accumulator (64 + 64 fp32 per thread at d = 128) without spills;
// - two consumer warpgroups of 64 q rows each share every k/v tile (each tile
//   is loaded once per 128 q rows), and their softmax and wgmma phases
//   interleave on the SM;
// - one CTA per (b*h, 128-row q-tile), heads fastest and the heaviest causal
//   q-tiles first, so the last wave holds the lightest tiles; causal k-tiles
//   wholly above a q-tile's last row are never loaded, and the mask runs only
//   on tiles that cross the diagonal or the sk edge.
// TMA tensor maps are rank 4 over (d, s, h, b) with the tensor's own strides
// (no transpose or copy), built on the host at each call with
// cuTensorMapEncodeTiled fetched through cudaGetDriverEntryPoint (no -lcuda);
// boxes past the sequence ends fill with zeros.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (torchstore_tpu_torch/ops/flash_attention.py). The launch goes
// on the caller's stream, does not synchronise and allocates nothing; the
// return value is the CUDA error of the launch (0 on success) or one of the
// kBad* codes below.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's finite mask value
constexpr float kFloor = 1e-30f;   // the reference's denominator floor
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBQ = 128;  // q rows per CTA: two consumer warpgroups of 64
constexpr int kBK = 128;  // k rows per tile
constexpr int kStages = 2;
constexpr int kThreads = 384;  // warpgroup 0 produces, 1 and 2 consume
constexpr int kConsumers = 256;
constexpr int kBox = kBK * 128;  // one 64-column box of 128 rows: 16 KB
constexpr int kBadHeadDim = -2;
constexpr int kBadShape = -3;
constexpr int kBadLayout = -4;     // alignment or strides TMA refuses
constexpr int kBadTensorMap = -5;  // cuTensorMapEncodeTiled refused the map
constexpr int kNoDriver = -6;      // cuTensorMapEncodeTiled not found

struct Params {
  void* out;  // acc (b, h, sq, d) fp32, or o (b, sq, h, d) bf16
  float* m;   // (b, h, sq), stats mode only
  float* l;
  int h, hk, sq, sk;
  int causal;
  float scale;
};

// Shared memory, in bytes from a 1024-byte aligned base: q, then kStages k
// tiles, kStages v tiles, then the barriers. A tile is D/64 boxes of kBox.
template <int D>
struct Layout {
  static constexpr int kTile = (D / 64) * kBox;
  static constexpr int kQ = 0;
  static constexpr int kK = kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;
  // barrier indices: q full, k full[s], v full[s], empty[s]
  static constexpr int kQFull = 0;
  static constexpr int kKFull = 1;
  static constexpr int kVFull = 1 + kStages;
  static constexpr int kEmpty = 1 + 2 * kStages;
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages) + 1024;  // + alignment slack
};

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

// wgmma shared-memory descriptor, 128-byte swizzle. Byte offsets: ``lbo``
// between 64-element atoms along MN (MN-major operands; unused K-major),
// ``sbo`` between 8-row groups.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
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

// Pins accumulator registers in place around asynchronous wgmma: no access
// to them moves across this point.
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 128, fp32) += A (64 x 16, smem, K-major) * B (128 x 16, smem, K-major)^T.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, fp32) += A (64 x 16, registers) * B (16 x 128, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, fp32) += A (64 x 16, registers) * B (16 x 64, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D, bool EMIT_STATS>
__global__ void __launch_bounds__(kThreads, 1)
    flash_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + L::kBar;
  auto bar = [&](int i) { return bars + 8u * (uint32_t)i; };

  const int bh = blockIdx.x;
  const int bi = bh / p.h;
  const int head = bh % p.h;
  const int kvh = head / (p.h / p.hk);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest causal q-tiles first
  const int q_last = min(q0 + kBQ, p.sq) - 1;
  int n_tiles = (p.sk + kBK - 1) / kBK;
  if (p.causal) n_tiles = min(n_tiles, q_last / kBK + 1);

  if (threadIdx.x == 0) {
    mbar_init(bar(L::kQFull), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar(L::kKFull + s), 1);
      mbar_init(bar(L::kVFull + s), 1);
      mbar_init(bar(L::kEmpty + s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer warpgroup: one thread issues every load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      constexpr int kBoxes = D / 64;
      mbar_expect_tx(bar(L::kQFull), L::kTile);
      for (int x = 0; x < kBoxes; ++x)
        tma_load(base + L::kQ + x * kBox, &tm_q, bar(L::kQFull), 64 * x, q0, head, bi);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const uint32_t phase = (t / kStages) & 1;
        mbar_wait(bar(L::kEmpty + s), phase ^ 1);  // the first round passes at once
        mbar_expect_tx(bar(L::kKFull + s), L::kTile);
        for (int x = 0; x < kBoxes; ++x)
          tma_load(base + L::kK + s * L::kTile + x * kBox, &tm_k, bar(L::kKFull + s), 64 * x,
                   t * kBK, kvh, bi);
        mbar_expect_tx(bar(L::kVFull + s), L::kTile);
        for (int x = 0; x < kBoxes; ++x)
          tma_load(base + L::kV + s * L::kTile + x * kBox, &tm_v, bar(L::kVFull + s), 64 * x,
                   t * kBK, kvh, bi);
      }
    }
  } else {
    // Consumer warpgroups: wg 0 owns q rows 0..63 of the tile, wg 1 rows 64..127.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int quad = tid & 3;
    // This thread's two rows of the accumulator layout: row0 and row0 + 8.
    const int row0 = q0 + 64 * wg + 16 * (tid / 32) + (tid % 32) / 4;
    const int wg_first_row = q0 + 64 * wg;

    float s[64];
    float o[D / 2];
    uint32_t pa[32];
    float m_r[2] = {kNegInf, kNegInf};
    float l_r[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

    const uint32_t q_base = base + L::kQ + wg * 64 * 128;
    mbar_wait(bar(L::kQFull), 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kStages;
      const uint32_t phase = (t / kStages) & 1;
      const uint32_t k_base = base + L::kK + st * L::kTile;
      const uint32_t v_base = base + L::kV + st * L::kTile;
      const int k0 = t * kBK;

      // S = q k^T: D/16 k-steps of 16; each 64-column box holds 4.
      mbar_wait(bar(L::kKFull + st), phase);
      __syncwarp();
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
        wgmma_ss_n128(s, desc_sw128(q_base + off, 16, 1024), desc_sw128(k_base + off, 16, 1024),
                      kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // Scale, mask (only tiles that cross the diagonal or the sk edge),
      // row max. s[i]: row row0 + 8 * ((i >> 1) & 1), column
      // k0 + 8 * (i >> 2) + 2 * quad + (i & 1).
      float mx[2] = {-INFINITY, -INFINITY};
      const bool edge = k0 + kBK > p.sk;
      const bool diag = p.causal && k0 + kBK - 1 > wg_first_row;
      if (edge || diag) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
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
        for (int i = 0; i < 64; ++i) {
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
      // p = exp(s - m) in fp32; l sums the fp32 p; P.V takes p in bf16.
#pragma unroll
      for (int i = 0; i < 64; ++i) {
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
#pragma unroll
      for (int i = 0; i < 32; ++i) pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];

      // o += P V: 8 k-steps of 16 keys; v is MN-major (d contiguous).
      mbar_wait(bar(L::kVFull + st), phase);
      __syncwarp();
      fence_regs(pa);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t dv = desc_sw128(v_base + kk * 16 * 128, kBox, 1024);
        if constexpr (D == 128) {
          wgmma_rs_n128(o, pa + 4 * kk, dv);
        } else {
          wgmma_rs_n64(o, pa + 4 * kk, dv);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(pa);  // p stays in its registers until the wgmma has read it
      mbar_arrive(bar(L::kEmpty + st));
    }

    // Epilogue: o[4j + 2r + e] is row row0 + 8r, column 8j + 2 quad + e.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= p.sq) continue;
      const int64_t stat_row = (int64_t)bh * p.sq + row;  // (b, h, sq) row
      if (EMIT_STATS) {
        float* acc = static_cast<float*>(p.out) + stat_row * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<float2*>(acc + 8 * j + 2 * quad) =
              make_float2(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
        if (quad == 0) {
          p.m[stat_row] = m_r[r];
          p.l[stat_row] = l_r[r];
        }
      } else {
        const float denom = fmaxf(l_r[r], kFloor);
        __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) +
                             (((int64_t)bi * p.sq + row) * p.h + head) * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(out + 8 * j + 2 * quad) =
              pack_bf16(o[4 * j + 2 * r] / denom, o[4 * j + 2 * r + 1] / denom);
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

// A rank-4 (d, s, h, b) bf16 map with 64 x kBK boxes, 128-byte swizzle,
// zero fill past the ends. Strides in elements.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int d, int s, int heads,
              int b, int64_t sb, int64_t ss, int64_t sh) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)heads, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, kBK, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool tma_ok(const void* ptr, int64_t sb, int64_t ss, int64_t sh) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb > 0 && ss > 0 && sh > 0 &&
         sb % 8 == 0 && ss % 8 == 0 && sh % 8 == 0;
}

template <int D, bool EMIT_STATS>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, const Params& p,
           int b, cudaStream_t stream) {
  constexpr int bytes = Layout<D>::kBytes;
  auto kernel = flash_sm90_kernel<D, EMIT_STATS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(b * p.h, (p.sq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, bytes, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace

// q (b, sq, h, d), k and v (b, sk, hk, d), bf16, unit d stride; strides in
// elements. Size-1 dimensions must come with a valid stride (the caller
// passes the contiguous one).
extern "C" int tst_flash_sm90(const void* q, const void* k, const void* v, void* out, float* m,
                              float* l, int emit_stats, int causal, int b, int h, int hk, int sq,
                              int sk, int d, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                              int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                              int64_t v_ss, int64_t v_sh, float scale, void* stream) {
  if (d != 64 && d != 128) return kBadHeadDim;
  if (b <= 0 || h <= 0 || hk <= 0 || h % hk != 0 || sq <= 0 || sk <= 0 ||
      (sq + kBQ - 1) / kBQ > 65535)
    return kBadShape;
  if (!tma_ok(q, q_sb, q_ss, q_sh) || !tma_ok(k, k_sb, k_ss, k_sh) || !tma_ok(v, v_sb, v_ss, v_sh))
    return kBadLayout;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kNoDriver;
  CUtensorMap tq, tk, tv;
  if (!make_map(encode, &tq, q, d, sq, h, b, q_sb, q_ss, q_sh) ||
      !make_map(encode, &tk, k, d, sk, hk, b, k_sb, k_ss, k_sh) ||
      !make_map(encode, &tv, v, d, sk, hk, b, v_sb, v_ss, v_sh))
    return kBadTensorMap;
  const Params p{out, m, l, h, hk, sq, sk, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 128) {
    return emit_stats ? launch<128, true>(tq, tk, tv, p, b, s)
                      : launch<128, false>(tq, tk, tv, p, b, s);
  }
  return emit_stats ? launch<64, true>(tq, tk, tv, p, b, s) : launch<64, false>(tq, tk, tv, p, b, s);
}
