// Blockwise (flash) attention for Hopper (sm_90a): bf16 or fp16 wgmma, a TMA
// ring of k/v tiles behind mbarriers, one producer and two consumer
// warpgroups.
//
// Replaces the TPU kernel torchstore_tpu/ops/flash_attention.py::_kernel,
// launched by _flash_call (pl.pallas_call, :205), for bf16 or fp16 q/k/v
// with any head dim d <= 256 with d % 8 == 0, in both of its modes:
//   EMIT_STATS = true  (flash_attention_stats, ring attention's per-hop body):
//     the unnormalized fp32 accumulator acc (b, h, sq, d) = sum_k p v and the
//     running max m and denominator l (b, h, sq), fp32;
//   EMIT_STATS = false (flash_attention): o = acc / max(l, 1e-30) in the
//     input type, laid out (b, sq, h, d).
// Scores are fp32 q.k^T times 1/sqrt(d). ``causal`` masks row >= col in the
// call's own coordinates with the reference's finite NEG_INF = -1e30;
// columns past sk take no part in the max or the sum; rows past sq are never
// stored; GQA maps q head i to kv head i / (h / hk) with no repeat. Strides
// TMA refuses run on the fp32 kernel in flash_attention.cu.
//
// Bound: operations. At b=1, h=32, hk=8, d=128, sq = sk = 8192 (or h=16,
// hk=16, d=256: the same h.d) the two products take 4 b h sq sk d = 1.1e12
// FLOP against ~0.24 GB of input and output: ~5000 FLOP per byte, far above
// the card's ~295, so only the 16-bit tensor cores (989 TFLOP/s) can
// approach the bound. What each choice does about it:
// - both products are wgmma.mma_async m64nNk16 in the input type with fp32
//   accumulators in registers: S = q.k^T reads q and k from shared memory
//   (K-major); P.V reads p from registers (rounded to the input type, as
//   FlashAttention-2/3 and PyTorch's SDPA do; l is summed from the fp32 p)
//   and v from shared memory (MN-major, the transpose flag set). The CUDA
//   cores keep only the online softmax: row max and sum over the 4 threads
//   that share a row of the accumulator layout, exp2 on the special-function
//   unit;
// - one elected producer thread issues TMA loads: q once, then k and v tiles
//   into a ring of kStages stages, each with its own k-full and v-full
//   barrier (q.k^T starts before v lands) and an empty barrier the 256
//   consumer threads arrive on. The loads of tile t+1 overlap the math of
//   tile t; the consumers spend no instructions or registers on copies;
// - 128-byte swizzle everywhere: a 64-element row is 128 bytes, so a tile
//   is d/64 boxes of 64 columns, each the canonical swizzled layout wgmma's
//   descriptors read without bank conflicts;
// - the k tile follows d (Tiling<D>). At d 64 and 128 a tile holds 128 keys:
//   S is m64n128k16, and a consumer holds the 64 x 128 score tile beside the
//   64 x d output accumulator (64 + 64 fp32 a thread at d = 128) in the 232
//   registers setmaxnreg gives it (the producer keeps 40). At d = 256 q (64
//   KB) and two stages of 128-key k and v tiles (4 x 64 KB) would need 320
//   KB of the 227 a block may use, and a thread would hold 128 + 64 fp32:
//   so the tile holds 64 keys (q and the ring take 64 + 4 x 32 KB), S is
//   m64n64k16 over 16 k-steps, P.V one m64n256k16 per 16 keys, and a
//   consumer holds 128 + 32 fp32 in 240 registers (the producer keeps 24:
//   128 x 24 + 256 x 240 = 64,512 of the SM's 65,536);
// - two consumer warpgroups of 64 q rows each share every k/v tile (each tile
//   is loaded once per 128 q rows), and their softmax and wgmma phases
//   interleave on the SM;
// - one CTA per (b*h, 128-row q-tile), heads fastest and the heaviest causal
//   q-tiles first, so the last wave holds the lightest tiles; causal k-tiles
//   wholly above a q-tile's last row are never loaded, and the mask runs only
//   on tiles that cross the diagonal or the sk edge (at 64-key tiles a
//   128-row q-tile's diagonal crosses two or three of them).
// TMA tensor maps are rank 4 over (d, s, h, b) with the tensor's own strides
// (no transpose or copy), built on the host at each call with
// cuTensorMapEncodeTiled fetched through cudaGetDriverEntryPoint (no -lcuda);
// boxes past the sequence ends fill with zeros.
// Head dims between the instances' (64, 128, 256) run on the next one up,
// D, with d zero-padded to D: the maps' innermost dimension is the real d,
// so a box that crosses d reads zeros past it; the boxes that lie wholly
// past d are never loaded (the barriers expect only the loaded boxes'
// bytes), and every thread zeroes them in shared memory once, before the
// first wgmma. Zero columns of q and k add nothing to q.k^T and zero
// columns of v make output columns that are never stored; the scale is the
// caller's 1/sqrt(d) of the real d, and the epilogue stores d columns.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (torchstore_tpu_torch/ops/flash_attention.py). The launch goes
// on the caller's stream, does not synchronise and allocates nothing; the
// return value is the CUDA error of the launch (0 on success) or one of the
// kBad* codes below.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's finite mask value
constexpr float kFloor = 1e-30f;   // the reference's denominator floor
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBQ = 128;  // q rows per CTA: two consumer warpgroups of 64
constexpr int kStages = 2;
constexpr int kThreads = 384;  // warpgroup 0 produces, 1 and 2 consume
constexpr int kConsumers = 256;
constexpr int kRowBytes = 128;  // one row of a 64-column box of 16-bit values
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use
constexpr int kBadKind = -1;
constexpr int kBadHeadDim = -2;
constexpr int kBadShape = -3;
constexpr int kBadLayout = -4;     // alignment or strides TMA refuses
constexpr int kBadTensorMap = -5;  // cuTensorMapEncodeTiled refused the map
constexpr int kNoDriver = -6;      // cuTensorMapEncodeTiled not found

struct Params {
  void* out;  // acc (b, h, sq, d) fp32, or o (b, sq, h, d) in the input type
  float* m;   // (b, h, sq), stats mode only
  float* l;
  int h, hk, sq, sk;
  int d;  // the real head dim, d <= D, d % 8 == 0
  int causal;
  float scale;
};

// Keys per k/v tile; flash_attention.py's SM90_BLOCK_K repeats it.
template <int D>
struct Tiling {
  static constexpr int kBK = D == 256 ? 64 : 128;
};

// Shared memory, in bytes from a 1024-byte aligned base: q, then kStages k
// tiles, kStages v tiles, then the barriers. A q tile is D/64 boxes of kBQ
// rows, a k or v tile D/64 boxes of kBK rows.
template <int D>
struct Layout {
  static constexpr int kBK = Tiling<D>::kBK;
  static constexpr int kQBox = kBQ * kRowBytes;
  static constexpr int kKBox = kBK * kRowBytes;
  static constexpr int kQTile = (D / 64) * kQBox;
  static constexpr int kKTile = (D / 64) * kKBox;
  static constexpr int kQ = 0;
  static constexpr int kK = kQTile;
  static constexpr int kV = kK + kStages * kKTile;
  static constexpr int kBar = kV + kStages * kKTile;
  // barrier indices: q full, k full[s], v full[s], empty[s]
  static constexpr int kQFull = 0;
  static constexpr int kKFull = 1;
  static constexpr int kVFull = 1 + kStages;
  static constexpr int kEmpty = 1 + 2 * kStages;
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages) + 1024;  // + alignment slack
};
static_assert(Layout<64>::kBytes <= kSmemLimit, "d = 64 exceeds shared memory");
static_assert(Layout<128>::kBytes <= kSmemLimit, "d = 128 exceeds shared memory");
static_assert(Layout<256>::kBytes <= kSmemLimit, "d = 256 exceeds shared memory");

// The input type: its tensor-map type, its wgmma type and the packing of
// two fp32 values into one 32-bit register (round to nearest).
template <typename T>
struct Elem;
template <>
struct Elem<__nv_bfloat16> {
  static constexpr bool kF16 = false;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};
template <>
struct Elem<__half> {
  static constexpr bool kF16 = true;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
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

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Zeroes ``bytes`` (a multiple of 16) of shared memory from ``addr`` with
// every thread of the block.
__device__ __forceinline__ void zero_smem(uint32_t addr, int bytes) {
  for (int i = threadIdx.x * 16; i < bytes; i += kThreads * 16)
    asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};" ::"r"(addr + i), "r"(0) : "memory");
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

// The wgmma forms. Each takes the accumulator d[0..N/2) of one thread (the
// m64nN fp32 layout) as "+f" operands %0..%(N/2 - 1), then its inputs.
#define TST_F8(i)                                                                             \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define TST_ACC32 TST_F8(0), TST_F8(8), TST_F8(16), TST_F8(24)
#define TST_ACC64 TST_ACC32, TST_F8(32), TST_F8(40), TST_F8(48), TST_F8(56)
#define TST_ACC128 \
  TST_ACC64, TST_F8(64), TST_F8(72), TST_F8(80), TST_F8(88), TST_F8(96), TST_F8(104), \
      TST_F8(112), TST_F8(120)
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

// D (64 x N, fp32) += A (64 x 16, smem, K-major) * B (N x 16, smem, K-major)^T;
// scale_d = 0 overwrites D. TY is the input type's PTX name.
#define TST_WGMMA_SS(N, TY, REGS, ACC, IA, IB, IS)                                          \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IS ", 0;\n"                            \
               "wgmma.mma_async.sync.aligned.m64n" N "k16.f32." TY "." TY " " REGS ", %" IA \
               ", %" IB ", p, 1, 1, 0, 0;\n}\n"                                             \
               : ACC                                                                        \
               : "l"(da), "l"(db), "r"(scale_d))

// D (64 x N, fp32) += A (64 x 16, registers) * B (16 x N, smem, MN-major).
#define TST_WGMMA_RS(N, TY, REGS, ACC, A0, A1, A2, A3, IB, IS)                            \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IS ", 0;\n"                          \
               "wgmma.mma_async.sync.aligned.m64n" N "k16.f32." TY "." TY " " REGS ", {%" A0 \
               ", %" A1 ", %" A2 ", %" A3 "}, %" IB ", p, 1, 1, 1;\n}\n"                   \
               : ACC                                                                      \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <typename T>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  if constexpr (Elem<T>::kF16) {
    TST_WGMMA_SS("128", "f16", TST_REGS64, TST_ACC64, "64", "65", "66");
  } else {
    TST_WGMMA_SS("128", "bf16", TST_REGS64, TST_ACC64, "64", "65", "66");
  }
}

template <typename T>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  if constexpr (Elem<T>::kF16) {
    TST_WGMMA_SS("64", "f16", TST_REGS32, TST_ACC32, "32", "33", "34");
  } else {
    TST_WGMMA_SS("64", "bf16", TST_REGS32, TST_ACC32, "32", "33", "34");
  }
}

template <typename T>
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t* a, uint64_t db) {
  if constexpr (Elem<T>::kF16) {
    TST_WGMMA_RS("256", "f16", TST_REGS128, TST_ACC128, "128", "129", "130", "131", "132", "133");
  } else {
    TST_WGMMA_RS("256", "bf16", TST_REGS128, TST_ACC128, "128", "129", "130", "131", "132", "133");
  }
}

template <typename T>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t db) {
  if constexpr (Elem<T>::kF16) {
    TST_WGMMA_RS("128", "f16", TST_REGS64, TST_ACC64, "64", "65", "66", "67", "68", "69");
  } else {
    TST_WGMMA_RS("128", "bf16", TST_REGS64, TST_ACC64, "64", "65", "66", "67", "68", "69");
  }
}

template <typename T>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t db) {
  if constexpr (Elem<T>::kF16) {
    TST_WGMMA_RS("64", "f16", TST_REGS32, TST_ACC32, "32", "33", "34", "35", "36", "37");
  } else {
    TST_WGMMA_RS("64", "bf16", TST_REGS32, TST_ACC32, "32", "33", "34", "35", "36", "37");
  }
}

template <typename T, int D, bool EMIT_STATS>
__global__ void __launch_bounds__(kThreads, 1)
    flash_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using L = Layout<D>;
  constexpr int kBK = L::kBK;
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
  // 64-column boxes of a tile that hold some of the d columns; the rest of
  // the D / 64 lie wholly past d and stay zero.
  const int n_boxes = (p.d + 63) / 64;

  if (threadIdx.x == 0) {
    mbar_init(bar(L::kQFull), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar(L::kKFull + s), 1);
      mbar_init(bar(L::kVFull + s), 1);
      mbar_init(bar(L::kEmpty + s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (n_boxes < D / 64) {
    zero_smem(base + L::kQ + n_boxes * L::kQBox, L::kQTile - n_boxes * L::kQBox);
    for (int t = 0; t < 2 * kStages; ++t)  // the k tiles, then the v tiles
      zero_smem(base + L::kK + t * L::kKTile + n_boxes * L::kKBox,
                L::kKTile - n_boxes * L::kKBox);
    fence_proxy_async();  // visible to the wgmmas that read them
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer warpgroup: one thread issues every load.
    if constexpr (D == 256) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    } else {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    }
    if (threadIdx.x == 0) {
      constexpr int kBoxes = D / 64;
      const uint32_t tile_bytes = n_boxes * L::kKBox;
      mbar_expect_tx(bar(L::kQFull), n_boxes * L::kQBox);
#pragma unroll
      for (int x = 0; x < kBoxes; ++x)
        if (x < n_boxes)
          tma_load(base + L::kQ + x * L::kQBox, &tm_q, bar(L::kQFull), 64 * x, q0, head, bi);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const uint32_t phase = (t / kStages) & 1;
        mbar_wait(bar(L::kEmpty + s), phase ^ 1);  // the first round passes at once
        mbar_expect_tx(bar(L::kKFull + s), tile_bytes);
#pragma unroll
        for (int x = 0; x < kBoxes; ++x)
          if (x < n_boxes)
            tma_load(base + L::kK + s * L::kKTile + x * L::kKBox, &tm_k, bar(L::kKFull + s),
                     64 * x, t * kBK, kvh, bi);
        mbar_expect_tx(bar(L::kVFull + s), tile_bytes);
#pragma unroll
        for (int x = 0; x < kBoxes; ++x)
          if (x < n_boxes)
            tma_load(base + L::kV + s * L::kKTile + x * L::kKBox, &tm_v, bar(L::kVFull + s),
                     64 * x, t * kBK, kvh, bi);
      }
    }
  } else {
    // Consumer warpgroups: wg 0 owns q rows 0..63 of the tile, wg 1 rows 64..127.
    if constexpr (D == 256) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    } else {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    }
    const int wg = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int quad = tid & 3;
    // This thread's two rows of the accumulator layout: row0 and row0 + 8.
    const int row0 = q0 + 64 * wg + 16 * (tid / 32) + (tid % 32) / 4;
    const int wg_first_row = q0 + 64 * wg;

    float s[kBK / 2];
    float o[D / 2];
    uint32_t pa[kBK / 4];
    float m_r[2] = {kNegInf, kNegInf};
    float l_r[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

    const uint32_t q_base = base + L::kQ + wg * 64 * kRowBytes;
    mbar_wait(bar(L::kQFull), 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kStages;
      const uint32_t phase = (t / kStages) & 1;
      const uint32_t k_base = base + L::kK + st * L::kKTile;
      const uint32_t v_base = base + L::kV + st * L::kKTile;
      const int k0 = t * kBK;

      // S = q k^T: D/16 k-steps of 16; each 64-column box holds 4.
      mbar_wait(bar(L::kKFull + st), phase);
      __syncwarp();
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        const uint64_t dq = desc_sw128(q_base + (kk / 4) * L::kQBox + col, 16, 1024);
        const uint64_t dk = desc_sw128(k_base + (kk / 4) * L::kKBox + col, 16, 1024);
        if constexpr (kBK == 128) {
          wgmma_ss_n128<T>(s, dq, dk, kk > 0);
        } else {
          wgmma_ss_n64<T>(s, dq, dk, kk > 0);
        }
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
      // p = exp(s - m) in fp32; l sums the fp32 p; P.V takes p in T.
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
#pragma unroll
      for (int i = 0; i < kBK / 4; ++i) pa[i] = Elem<T>::pack(s[2 * i], s[2 * i + 1]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];

      // o += P V: kBK / 16 k-steps of 16 keys; v is MN-major (d contiguous),
      // its 64-column boxes kKBox apart.
      mbar_wait(bar(L::kVFull + st), phase);
      __syncwarp();
      fence_regs(pa);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t dv = desc_sw128(v_base + kk * 16 * kRowBytes, L::kKBox, 1024);
        if constexpr (D == 256) {
          wgmma_rs_n256<T>(o, pa + 4 * kk, dv);
        } else if constexpr (D == 128) {
          wgmma_rs_n128<T>(o, pa + 4 * kk, dv);
        } else {
          wgmma_rs_n64<T>(o, pa + 4 * kk, dv);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(pa);  // p stays in its registers until the wgmma has read it
      mbar_arrive(bar(L::kEmpty + st));
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
        float* acc = static_cast<float*>(p.out) + stat_row * p.d;
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
        T* out = static_cast<T*>(p.out) + (((int64_t)bi * p.sq + row) * p.h + head) * p.d;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          if (j < d_groups)
            *reinterpret_cast<uint32_t*>(out + 8 * j + 2 * quad) =
                Elem<T>::pack(o[4 * j + 2 * r] / denom, o[4 * j + 2 * r + 1] / denom);
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

// A rank-4 (d, s, h, b) map of 16-bit values with 64 x ``rows`` boxes,
// 128-byte swizzle, zero fill past the ends (past d as well as past s).
// Strides in elements.
bool make_map(EncodeTiled encode, CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
              int d, int s, int heads, int b, int64_t sb, int64_t ss, int64_t sh, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)heads, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, type, 4, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool tma_ok(const void* ptr, int64_t sb, int64_t ss, int64_t sh) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb > 0 && ss > 0 && sh > 0 &&
         sb % 8 == 0 && ss % 8 == 0 && sh % 8 == 0;
}

struct Call {
  const void *q, *k, *v;
  int b, h, hk, sq, sk, d;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
};

template <typename T, int D, bool EMIT_STATS>
int launch(const Call& c, const Params& p, cudaStream_t stream) {
  using L = Layout<D>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kNoDriver;
  CUtensorMap tq, tk, tv;
  if (!make_map(encode, &tq, Elem<T>::kMap, c.q, c.d, c.sq, c.h, c.b, c.q_sb, c.q_ss, c.q_sh,
                kBQ) ||
      !make_map(encode, &tk, Elem<T>::kMap, c.k, c.d, c.sk, c.hk, c.b, c.k_sb, c.k_ss, c.k_sh,
                L::kBK) ||
      !make_map(encode, &tv, Elem<T>::kMap, c.v, c.d, c.sk, c.hk, c.b, c.v_sb, c.v_ss, c.v_sh,
                L::kBK))
    return kBadTensorMap;
  auto kernel = flash_sm90_kernel<T, D, EMIT_STATS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(c.b * p.h, (p.sq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, L::kBytes, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

// The instance of the next head dim up: flash_attention.py's
// padded_head_dim repeats the rule.
template <typename T, bool EMIT_STATS>
int dispatch_d(const Call& c, const Params& p, cudaStream_t stream) {
  if (c.d > 128) return launch<T, 256, EMIT_STATS>(c, p, stream);
  if (c.d > 64) return launch<T, 128, EMIT_STATS>(c, p, stream);
  return launch<T, 64, EMIT_STATS>(c, p, stream);
}

template <typename T>
int dispatch_mode(const Call& c, const Params& p, bool emit_stats, cudaStream_t stream) {
  return emit_stats ? dispatch_d<T, true>(c, p, stream) : dispatch_d<T, false>(c, p, stream);
}

}  // namespace

// kind: 1 bf16, 2 fp16 (q, k, v and, in the normalized mode, o). q (b, sq,
// h, d), k and v (b, sk, hk, d), unit d stride; strides in elements.
// Size-1 dimensions must come with a valid stride (the caller passes the
// contiguous one).
extern "C" int tst_flash_sm90(const void* q, const void* k, const void* v, void* out, float* m,
                              float* l, int kind, int emit_stats, int causal, int b, int h,
                              int hk, int sq, int sk, int d, int64_t q_sb, int64_t q_ss,
                              int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
                              int64_t v_sb, int64_t v_ss, int64_t v_sh, float scale,
                              void* stream) {
  if (kind != 1 && kind != 2) return kBadKind;
  if (d <= 0 || d > 256 || d % 8 != 0) return kBadHeadDim;
  if (b <= 0 || h <= 0 || hk <= 0 || h % hk != 0 || sq <= 0 || sk <= 0 ||
      (sq + kBQ - 1) / kBQ > 65535)
    return kBadShape;
  if (!tma_ok(q, q_sb, q_ss, q_sh) || !tma_ok(k, k_sb, k_ss, k_sh) || !tma_ok(v, v_sb, v_ss, v_sh))
    return kBadLayout;
  const Call c{q, k, v, b, h, hk, sq, sk, d, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  const Params p{out, m, l, h, hk, sq, sk, d, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return kind == 1 ? dispatch_mode<__nv_bfloat16>(c, p, emit_stats != 0, s)
                   : dispatch_mode<__half>(c, p, emit_stats != 0, s);
}
