// Blockwise (flash) attention with an online softmax (Hopper, sm_90a).
//
// Replaces the TPU kernel torchstore_tpu/ops/flash_attention.py::_kernel,
// launched by _flash_call (pl.pallas_call), in both of its modes:
//   EMIT_STATS = true  (flash_attention_stats, ring attention's per-hop body):
//     the unnormalized fp32 accumulator acc (b, h, sq, d) = sum_k exp(s - m) v,
//     the running max m and denominator l (b, h, sq);
//   EMIT_STATS = false (flash_attention): o = acc / max(l, 1e-30) in the input
//     type (fp32, bf16 or fp16), laid out (b, sq, h, d).
// Scores are fp32 q.k^T / sqrt(d). ``causal`` masks row >= col in the call's
// own coordinates (the ring's diagonal block, or whole-sequence causal) with
// the reference's finite NEG_INF = -1e30, and skips k-tiles that lie wholly
// above the q-tile's last row.
//
// Bound: operations. At the main path's shapes (b=1, h=32, hk=8, d=128,
// sq = sk = 8192, bf16) the two products take 4 b h sq sk d = 1.1e12 FLOP
// against ~0.2 GB of input and output, ~5000 FLOP per byte, far above the
// card's ~295: only the tensor cores could reach the bound. Every call whose
// strides and base TMA takes runs on the tensor cores (bf16 and fp16 in
// flash_attention_sm90.cu, fp32 in flash_attention_sm90_fp32.cu, each at any
// head dim d <= 256 with d % 8 == 0); this kernel takes the calls whose
// strides or base TMA refuses and does its math in fp32 on the CUDA cores,
// far below the tensor-core bound.
//
// Design. The TPU ran a sequential grid (b*h, q-block, k-block) and carried
// the softmax state in VMEM scratch across the k-blocks. Here one thread
// block owns one (b*h, 64-row q-tile) and loops over 64-row k-tiles itself:
// - the q, k and v tiles are staged in shared memory as fp32 (zero-padded to
//   DMAX columns and past the sequence ends), read from the (b, s, h, d)
//   tensors through their strides, with no transpose;
// - 256 threads as a 16 x 16 grid; thread (ty, tx) owns rows ty*4 .. ty*4+3
//   of the tile: scores for columns tx + 16 j, and output columns
//   g*64 + tx*4 .. +3. Row max and row sum reduce over the 16 lanes of a row
//   with warp shuffles; the running max, the denominator and the fp32
//   accumulator stay in registers for the whole loop;
// - each k-tile's P.V is summed apart and added as acc = acc * corr + P.V,
//   as the reference does per block;
// - GQA: q head ``head`` reads kv head head / (h / hk), with no repeat;
// - ragged edges are masked: rows past sq are computed on zeros and never
//   stored, columns past sk take no part in the max or the sum.
// Any d <= 256 with d % 8 == 0 runs, on a tile of DMAX = 64, 128 or 256.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (torchstore_tpu_torch/ops/flash_attention.py). The launch goes
// on the caller's stream and does not synchronise; the return value is the
// CUDA error of the launch (0 on success) or one of the kBad* codes below.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's finite mask value
constexpr float kFloor = 1e-30f;   // the reference's denominator floor
constexpr int kBQ = 64;            // q rows per block
constexpr int kBK = 64;            // k rows per tile
constexpr int kThreads = 256;
constexpr int kBadKind = -1;
constexpr int kBadHeadDim = -2;
constexpr int kBadShape = -3;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;  // acc (b, h, sq, d) fp32, or o (b, sq, h, d) in the input type
  float* m;   // (b, h, sq), stats mode only
  float* l;
  int64_t q_sb, q_ss, q_sh;  // strides in elements; the d stride is 1
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int h, hk, sq, sk, d;
  int causal;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void store(__half* p, float x) { *p = __float2half_rn(x); }

template <int DMAX>
constexpr int smem_floats() {
  // q tile, k tile (rows padded by 4 floats), v tile, p tile.
  return kBQ * DMAX + kBK * (DMAX + 4) + kBK * DMAX + kBQ * kBK;
}

// rows x DMAX tile of a (b, s, h, d) tensor into shared memory as fp32,
// zero past ``rows_valid`` rows and past d columns.
template <typename T, int DMAX, int LD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int64_t row_stride,
                                          int rows_valid, int d) {
  for (int idx = threadIdx.x; idx < 64 * DMAX; idx += kThreads) {
    const int r = idx / DMAX;
    const int c = idx % DMAX;
    float x = 0.f;
    if (r < rows_valid && c < d) x = to_f32(src[(int64_t)r * row_stride + c]);
    dst[r * LD + c] = x;
  }
}

template <typename T, int DMAX, bool EMIT_STATS>
__global__ void __launch_bounds__(kThreads, 1) flash_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int KLD = DMAX + 4;  // padded k rows: float4 reads across rows hit all banks
  constexpr int NG = DMAX / 64;  // output column groups of 64 per thread row
  float* qs = smem;              // [kBQ][DMAX]
  float* ks = qs + kBQ * DMAX;   // [kBK][KLD]
  float* vs = ks + kBK * KLD;    // [kBK][DMAX]
  float* ps = vs + kBK * DMAX;   // [kBQ][kBK]

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int bi = bh / p.h;
  const int head = bh % p.h;
  const int kvh = head / (p.h / p.hk);
  // Heaviest causal q-tiles first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;

  const T* qg = static_cast<const T*>(p.q) + bi * p.q_sb + head * p.q_sh + q0 * p.q_ss;
  const T* kg = static_cast<const T*>(p.k) + bi * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + bi * p.v_sb + kvh * p.v_sh;

  load_tile<T, DMAX, DMAX>(qs, qg, p.q_ss, p.sq - q0, p.d);

  float acc[4][NG * 4];
  float m_i[4];
  float l_i[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m_i[a] = kNegInf;
    l_i[a] = 0.f;
#pragma unroll
    for (int c = 0; c < NG * 4; ++c) acc[a][c] = 0.f;
  }

  const int q_last = min(q0 + kBQ, p.sq) - 1;
  int n_tiles = (p.sk + kBK - 1) / kBK;
  if (p.causal) n_tiles = min(n_tiles, q_last / kBK + 1);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, DMAX, KLD>(ks, kg + k0 * p.k_ss, p.k_ss, p.sk - k0, p.d);
    load_tile<T, DMAX, DMAX>(vs, vg + k0 * p.v_ss, p.v_ss, p.sk - k0, p.d);
    __syncthreads();

    // s = q k^T for rows ty*4+a, columns tx + 16 j.
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[a][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < p.d; c += 4) {
      float4 qv[4];
      float4 kv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        qv[a] = *reinterpret_cast<const float4*>(&qs[(ty * 4 + a) * DMAX + c]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&ks[(tx + 16 * j) * KLD + c]);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = s[a][j];
          x = fmaf(qv[a].x, kv[j].x, x);
          x = fmaf(qv[a].y, kv[j].y, x);
          x = fmaf(qv[a].z, kv[j].z, x);
          x = fmaf(qv[a].w, kv[j].w, x);
          s[a][j] = x;
        }
    }

    // Mask, online softmax, p into shared memory.
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qi = q0 + ty * 4 + a;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        float x = s[a][j] * p.scale;
        if (kj >= p.sk) {
          x = -INFINITY;  // past the block: no part in max or sum
        } else if (p.causal && kj > qi) {
          x = kNegInf;
        }
        s[a][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_i[a], mx);
      const float corr = expf(m_i[a] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[a][j] - m_new);
        rs += e;
        ps[(ty * 4 + a) * kBK + tx + 16 * j] = e;
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l_i[a] = l_i[a] * corr + rs;
      m_i[a] = m_new;
#pragma unroll
      for (int c = 0; c < NG * 4; ++c) acc[a][c] *= corr;
    }
    __syncthreads();

    // pv = p v for rows ty*4+a, columns g*64 + tx*4 + e; then acc += pv.
    float pv[4][NG * 4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < NG * 4; ++c) pv[a][c] = 0.f;
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pr[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        pr[a] = *reinterpret_cast<const float4*>(&ps[(ty * 4 + a) * kBK + j]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float4 vv =
              *reinterpret_cast<const float4*>(&vs[(j + u) * DMAX + g * 64 + tx * 4]);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float w = u == 0 ? pr[a].x : u == 1 ? pr[a].y : u == 2 ? pr[a].z : pr[a].w;
            pv[a][g * 4 + 0] = fmaf(w, vv.x, pv[a][g * 4 + 0]);
            pv[a][g * 4 + 1] = fmaf(w, vv.y, pv[a][g * 4 + 1]);
            pv[a][g * 4 + 2] = fmaf(w, vv.z, pv[a][g * 4 + 2]);
            pv[a][g * 4 + 3] = fmaf(w, vv.w, pv[a][g * 4 + 3]);
          }
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < NG * 4; ++c) acc[a][c] += pv[a][c];
  }

  // Write the rows this thread owns.
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qi = q0 + ty * 4 + a;
    if (qi >= p.sq) continue;
    const int64_t row = (int64_t)bh * p.sq + qi;  // (b, h, sq) row
    if (EMIT_STATS) {
      float* acc_out = static_cast<float*>(p.out) + row * p.d;
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = g * 64 + tx * 4 + e;
          if (c < p.d) acc_out[c] = acc[a][g * 4 + e];
        }
      if (tx == 0) {
        p.m[row] = m_i[a];
        p.l[row] = l_i[a];
      }
    } else {
      const float denom = fmaxf(l_i[a], kFloor);
      T* o = static_cast<T*>(p.out) + (((int64_t)bi * p.sq + qi) * p.h + head) * p.d;
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = g * 64 + tx * 4 + e;
          if (c < p.d) store(&o[c], acc[a][g * 4 + e] / denom);
        }
    }
  }
}

template <typename T, int DMAX, bool EMIT_STATS>
int launch(const Params& p, int b, cudaStream_t stream) {
  constexpr int bytes = smem_floats<DMAX>() * (int)sizeof(float);
  auto kernel = flash_kernel<T, DMAX, EMIT_STATS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.sq + kBQ - 1) / kBQ, b * p.h);
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, bool EMIT_STATS>
int dispatch_d(const Params& p, int b, cudaStream_t stream) {
  if (p.d <= 64) return launch<T, 64, EMIT_STATS>(p, b, stream);
  if (p.d <= 128) return launch<T, 128, EMIT_STATS>(p, b, stream);
  return launch<T, 256, EMIT_STATS>(p, b, stream);
}

}  // namespace

// kind: 0 fp32, 1 bf16, 2 fp16 (q, k, v and, in the normalized mode, o).
extern "C" int tst_flash(const void* q, const void* k, const void* v, void* out, float* m,
                         float* l, int kind, int emit_stats, int causal, int b, int h, int hk,
                         int sq, int sk, int d, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                         int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                         int64_t v_ss, int64_t v_sh, float scale, void* stream) {
  if (d <= 0 || d > 256 || d % 8 != 0) return kBadHeadDim;
  if (b <= 0 || h <= 0 || hk <= 0 || h % hk != 0 || sq <= 0 || sk <= 0 ||
      (int64_t)b * h > 65535)
    return kBadShape;
  Params p{q,    k,    v,    out,  m,    l,  q_sb, q_ss, q_sh,   k_sb,  k_ss,
           k_sh, v_sb, v_ss, v_sh, h,    hk, sq,   sk,   d,      causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0) {
    return emit_stats ? dispatch_d<float, true>(p, b, s) : dispatch_d<float, false>(p, b, s);
  }
  if (kind == 1) {
    return emit_stats ? dispatch_d<__nv_bfloat16, true>(p, b, s)
                      : dispatch_d<__nv_bfloat16, false>(p, b, s);
  }
  if (kind == 2) {
    return emit_stats ? dispatch_d<__half, true>(p, b, s) : dispatch_d<__half, false>(p, b, s);
  }
  return kBadKind;
}
