// Elementwise dtype cast for the direct weight-sync source (Hopper, sm_90a).
//
// Replaces the TPU kernel torchstore_tpu/ops/staging.py::pallas_cast, which
// tiles the flattened input into (8, 128) VPU blocks and falls back to the
// XLA cast when n % 1024 != 0. Here one grid-stride kernel walks the flat
// buffer: there is no tiling constraint, so there is no size fallback.
//
// Bound: memory. The cast does one conversion per element and moves
// sizeof(in) + sizeof(out) bytes per element (6 for fp32 -> bf16), far below
// the card's ~295 operations per byte, so the only lever is to keep every
// byte of HBM traffic useful: each thread loads and stores whole 16-byte
// vectors (8 elements per step) when both pointers are 16-byte aligned, and
// neighbouring threads touch neighbouring vectors. A pointer that is not
// 16-byte aligned (a view with a storage offset) takes the scalar path. The
// last n % 8 elements of the vector path are a masked scalar tail.
//
// Conversions: every pair goes through fp32. Widening to fp32 is exact;
// narrowing rounds to nearest even (__float2bfloat16_rn, __float2half_rn),
// keeps +-Inf and NaN, and overflows to +-Inf. bf16 <-> fp16 rounds once, as
// the fp32 intermediate is exact.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (torchstore_tpu_torch/ops/staging.py). The launch goes on the
// caller's stream and does not synchronise; the return value is the CUDA
// error of the launch (0 on success), or kBadPair for a pair not covered.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Kind : int { kF32 = 0, kBF16 = 1, kF16 = 2 };
constexpr int kBadPair = -1;
constexpr int kVec = 8;  // elements per vector step
constexpr int kThreads = 256;

template <int K> struct Bits;
template <> struct Bits<kF32> { using T = float; };
template <> struct Bits<kBF16> { using T = unsigned short; };
template <> struct Bits<kF16> { using T = unsigned short; };

template <int K> __device__ __forceinline__ float to_f32(typename Bits<K>::T v);
template <> __device__ __forceinline__ float to_f32<kF32>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<kBF16>(unsigned short v) {
  return __bfloat162float(__ushort_as_bfloat16(v));
}
template <> __device__ __forceinline__ float to_f32<kF16>(unsigned short v) {
  return __half2float(__ushort_as_half(v));
}

template <int K> __device__ __forceinline__ typename Bits<K>::T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<kF32>(float v) { return v; }
template <> __device__ __forceinline__ unsigned short from_f32<kBF16>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
template <> __device__ __forceinline__ unsigned short from_f32<kF16>(float v) {
  return __half_as_ushort(__float2half_rn(v));
}

// kVec elements of one type, addressable as 16-byte words.
template <int K> union Pack {
  typename Bits<K>::T e[kVec];
  uint4 q[sizeof(typename Bits<K>::T) * kVec / 16];
};

template <int IN, int OUT>
__global__ void __launch_bounds__(kThreads)
cast_vec(const typename Bits<IN>::T* __restrict__ x,
         typename Bits<OUT>::T* __restrict__ y, int64_t n) {
  const int64_t n_vec = n / kVec;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const uint4* src = reinterpret_cast<const uint4*>(x);
  uint4* dst = reinterpret_cast<uint4*>(y);
  constexpr int kInWords = sizeof(Pack<IN>) / 16;
  constexpr int kOutWords = sizeof(Pack<OUT>) / 16;
  for (int64_t i = tid; i < n_vec; i += stride) {
    Pack<IN> a;
    Pack<OUT> b;
#pragma unroll
    for (int w = 0; w < kInWords; ++w) a.q[w] = __ldg(src + i * kInWords + w);
#pragma unroll
    for (int k = 0; k < kVec; ++k) b.e[k] = from_f32<OUT>(to_f32<IN>(a.e[k]));
#pragma unroll
    for (int w = 0; w < kOutWords; ++w) dst[i * kOutWords + w] = b.q[w];
  }
  // Masked tail: the last n % kVec elements, one per thread.
  const int64_t t = n_vec * kVec + tid;
  if (t < n) y[t] = from_f32<OUT>(to_f32<IN>(x[t]));
}

template <int IN, int OUT>
__global__ void __launch_bounds__(kThreads)
cast_scalar(const typename Bits<IN>::T* __restrict__ x,
            typename Bits<OUT>::T* __restrict__ y, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    y[i] = from_f32<OUT>(to_f32<IN>(x[i]));
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        count <= 0) {
      count = 132;
    }
  }
  return count;
}

template <int IN, int OUT>
int launch(const void* x, void* y, int64_t n, cudaStream_t stream) {
  using TI = typename Bits<IN>::T;
  using TO = typename Bits<OUT>::T;
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  // Work items: vectors (plus one tail element per thread) or elements.
  const int64_t work = aligned ? (n / kVec > 0 ? n / kVec : 1) : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sm_count() * 16;  // grid-stride beyond this
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  if (aligned) {
    cast_vec<IN, OUT><<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const TI*>(x), static_cast<TO*>(y), n);
  } else {
    cast_scalar<IN, OUT><<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const TI*>(x), static_cast<TO*>(y), n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tst_cast(const void* x, int in_kind, void* y, int out_kind,
                        int64_t n, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_kind * 3 + out_kind) {
    case kF32 * 3 + kBF16: return launch<kF32, kBF16>(x, y, n, s);
    case kF32 * 3 + kF16: return launch<kF32, kF16>(x, y, n, s);
    case kBF16 * 3 + kF32: return launch<kBF16, kF32>(x, y, n, s);
    case kF16 * 3 + kF32: return launch<kF16, kF32>(x, y, n, s);
    case kBF16 * 3 + kF16: return launch<kBF16, kF16>(x, y, n, s);
    case kF16 * 3 + kBF16: return launch<kF16, kBF16>(x, y, n, s);
    default: return kBadPair;
  }
}
