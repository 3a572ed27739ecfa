// Grouped elementwise dtype cast for the weight-sync source (Hopper, sm_90a).
//
// Replaces the TPU kernel torchstore_tpu/ops/staging.py::pallas_cast, which
// tiles one flattened input into (8, 128) VPU blocks and falls back to the
// XLA cast when n % 1024 != 0. Here one launch casts a *group*: a table of
// entries (src, dst, n) that share one (src, dst) dtype pair, so a publish of
// a state dict is a few launches, not one per tensor, and there is no size
// fallback.
//
// Bound: memory. The cast does one conversion per element and moves
// sizeof(in) + sizeof(out) bytes per element (6 for fp32 -> bf16), far below
// the card's ~295 operations per byte, so the kernel has to keep enough bytes
// in flight to cover HBM latency (Little's law: ~2 MB across the card at
// 3.35 TB/s) while every byte it moves is useful. The design:
//
// - Persistent grid of kCtasPerSm CTA per SM. The group's elements are cut
//   into work units of kUnitElems elements that never cross an entry; CTA b
//   takes units b, b + grid, b + 2 grid, ... A 4096-element norm and a
//   525 M-element embedding share one launch.
// - The table is a __grid_constant__ kernel parameter (no host-device copy,
//   no sync). Each CTA copies the entries' first-unit column into shared
//   memory once; one thread finds a unit's entry by binary search in it,
//   starting past the entry of its previous unit.
// - The 16-byte-aligned body of each unit moves by TMA bulk copies
//   (cp.async.bulk, no tensor map): one thread keeps a ring of kStages
//   shared-memory stages loading, completed on one mbarrier per stage; all
//   threads convert a stage from its input to its output buffer; the same
//   thread writes the output back with a bulk store (bulk-group commit, and
//   a wait on the group's shared-memory reads before a stage's output
//   buffer is reused). kStages x 32 KB of fp32 input in flight per SM,
//   whatever the occupancy. (Of the settings tried on an H100, this one ran
//   a Llama-3-8B publish fastest; two CTAs per SM of 4096-element units,
//   more stages, 512 threads, stores straight from registers and an L2
//   evict-first hint on the loads did not beat it.)
// - Edges in the same launch: an entry's head before its first element
//   where both pointers are 16-byte aligned, each unit's tail of fewer than
//   8 elements, and whole entries that have no such element (views whose
//   storage offset misaligns src against dst) go element by element from
//   global memory, coalesced across the CTA's threads.
//
// Conversions: every pair goes through fp32. Widening to fp32 is exact;
// narrowing rounds to nearest even (__float2bfloat16_rn, __float2half_rn),
// keeps +-Inf and NaN, and overflows to +-Inf. bf16 <-> fp16 rounds once, as
// the fp32 intermediate is exact.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (torchstore_tpu_torch/ops/staging.py, which packs the table and
// shares the layout constants below). The launch goes on the caller's stream
// and does not synchronise; the return value is the CUDA error of the launch
// (0 on success), kBadPair for a pair not covered, or kBadTable for a table
// of more than kMaxEntries entries.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

namespace {

enum Kind : int { kF32 = 0, kBF16 = 1, kF16 = 2 };
constexpr int kBadPair = -1;
constexpr int kBadTable = -2;

// Layout shared with ops/staging.py (checked by tests/test_torch_cast_group.py).
constexpr int kUnitElems = 8192;        // elements per work unit
constexpr int kMaxEntries = 1000;       // entries per launch
constexpr int kSmallEntries = 16;       // a table this small takes the small kernel
constexpr uint32_t kNoBody = 0xFFFFFFFFu;  // head of an entry with no aligned body

struct Entry {
  uint64_t src;    // source pointer
  uint64_t dst;    // destination pointer
  int64_t n;       // elements
  uint32_t first;  // the entry's first work unit in the group
  uint32_t head;   // elements before the aligned body, or kNoBody
};
static_assert(sizeof(Entry) == 32, "Entry layout is shared with staging.py");
static_assert(offsetof(Entry, src) == 0 && offsetof(Entry, dst) == 8 &&
                  offsetof(Entry, n) == 16 && offsetof(Entry, first) == 24 &&
                  offsetof(Entry, head) == 28,
              "Entry layout is shared with staging.py");

template <int CAP> struct Table {
  int32_t count;   // entries in use
  uint32_t units;  // work units of the whole group
  Entry e[CAP];
};
static_assert(sizeof(Table<kMaxEntries>) <= 32764, "kernel parameter limit");

constexpr int kThreads = 256;
constexpr int kStages = 4;
constexpr int kCtasPerSm = 1;

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

// STEP elements of one type as one 8- or 16-byte shared-memory word.
template <int BYTES> struct Word;
template <> struct Word<8> { using T = uint2; };
template <> struct Word<16> { using T = uint4; };
template <int K, int STEP> union Pack {
  typename Bits<K>::T e[STEP];
  typename Word<sizeof(typename Bits<K>::T) * STEP>::T w;
};

// What one work unit does; written by the issuing thread when it starts the
// unit's load, read by every thread after the stage's barrier completes.
struct Unit {
  uint64_t src, dst;  // the entry's pointers
  int64_t body0;      // first element of the bulk body
  int64_t lo0, lo1;   // element range taken one by one: the head or a whole unit
  int64_t hi0, hi1;   // element range taken one by one: the tail
  uint32_t body;      // elements in the bulk body (a multiple of 8; 0: none)
  uint32_t pad;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// Global -> shared, ``bytes`` (a multiple of 16, both addresses 16-byte
// aligned), completing its bytes on ``bar``.
__device__ __forceinline__ void bulk_load(uint32_t dst, uint64_t src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Shared -> global, in the current bulk async-group.
__device__ __forceinline__ void bulk_store(uint64_t dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// At most N bulk groups may still be reading shared memory.
template <int N> __device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Generic-proxy writes to shared memory become visible to bulk copies.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

template <int IN, int OUT> struct Shape {
  using TI = typename Bits<IN>::T;
  using TO = typename Bits<OUT>::T;
  // Elements per shared-memory word: 16 bytes of the wider type.
  static constexpr int kStep = 16 / (sizeof(TI) > sizeof(TO) ? sizeof(TI) : sizeof(TO));
  static constexpr int kInBytes = kUnitElems * sizeof(TI);
  static constexpr int kOutBytes = kUnitElems * sizeof(TO);
  static constexpr int kIn = 0;                               // kStages input buffers
  static constexpr int kOut = kIn + kStages * kInBytes;       // kStages output buffers
  static constexpr int kBar = kOut + kStages * kOutBytes;     // kStages mbarriers
  static constexpr int kUnits = kBar + 8 * kStages;           // kStages Unit records
  static constexpr int kFirst = kUnits + kStages * (int)sizeof(Unit);  // first-unit column
  static constexpr int bytes(int cap) { return kFirst + 4 * cap; }
};

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// The unit ``u`` of entry ``e`` (u >= e.first) as a Unit record.
__device__ __forceinline__ void plan_unit(const Entry& e, uint32_t u, Unit& r) {
  r.src = e.src;
  r.dst = e.dst;
  const int64_t j = (int64_t)(u - e.first);
  if (e.head == kNoBody) {
    r.body0 = 0;
    r.body = 0;
    r.lo0 = j * kUnitElems;
    r.lo1 = min64(r.lo0 + kUnitElems, e.n);
    r.hi0 = r.hi1 = 0;
    return;
  }
  const int64_t start = (int64_t)e.head + j * kUnitElems;
  const int64_t end = min64(start + kUnitElems, e.n);
  const int64_t body = (end - start) & ~(int64_t)7;
  r.body0 = start;
  r.body = (uint32_t)body;
  r.lo0 = 0;
  r.lo1 = j == 0 ? (int64_t)e.head : 0;
  r.hi0 = start + body;
  r.hi1 = end;
}

// Thread 0: find unit ``u``'s entry, record the unit in stage ``s`` and
// start its body's load (or complete the stage's phase when it has none).
// ``cur`` is the entry of the thread's previous unit: units only grow, so
// the search starts past it, and most units stay in it.
template <int IN, int OUT, int CAP>
__device__ __forceinline__ void start_unit(const Table<CAP>& table, const uint32_t* first,
                                      unsigned char* smem, uint32_t u, int s, int& cur) {
  using S = Shape<IN, OUT>;
  if (cur + 1 < table.count && first[cur + 1] <= u) {
    int lo = cur + 1, hi = table.count - 1;  // the last entry whose first unit <= u
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (first[mid] <= u) lo = mid; else hi = mid - 1;
    }
    cur = lo;
  }
  Unit* rec = reinterpret_cast<Unit*>(smem + S::kUnits) + s;
  plan_unit(table.e[cur], u, *rec);
  const uint32_t bar = smem_addr(smem + S::kBar + 8 * s);
  if (rec->body) {
    const uint32_t bytes = rec->body * (uint32_t)sizeof(typename S::TI);
    mbar_expect_tx(bar, bytes);
    bulk_load(smem_addr(smem + S::kIn + s * S::kInBytes),
              rec->src + (uint64_t)rec->body0 * sizeof(typename S::TI), bytes, bar);
  } else {
    mbar_arrive(bar);
  }
}

template <int IN, int OUT, int CAP>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
cast_group(const __grid_constant__ Table<CAP> table) {
  using S = Shape<IN, OUT>;
  using TI = typename S::TI;
  using TO = typename S::TO;
  constexpr int kStep = S::kStep;
  extern __shared__ __align__(128) unsigned char smem[];
  uint32_t* first = reinterpret_cast<uint32_t*>(smem + S::kFirst);
  const Unit* recs = reinterpret_cast<const Unit*>(smem + S::kUnits);
  const int tid = threadIdx.x;
  const uint32_t units = table.units;
  const uint32_t grid = gridDim.x;

  for (int i = tid; i < table.count; i += kThreads) first[i] = table.e[i].first;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(smem_addr(smem + S::kBar + 8 * s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  int cur = 0;  // thread 0's current entry
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      const uint32_t u = blockIdx.x + s * grid;
      if (u < units) start_unit<IN, OUT, CAP>(table, first, smem, u, s, cur);
    }
  }

  uint32_t k = 0;
  for (uint32_t u = blockIdx.x; u < units; u += grid, ++k) {
    const int s = (int)(k % kStages);
    mbar_wait(smem_addr(smem + S::kBar + 8 * s), (k / kStages) & 1);
    const Unit r = recs[s];
    const TI* in = reinterpret_cast<const TI*>(smem + S::kIn + s * S::kInBytes);
    TO* out = reinterpret_cast<TO*>(smem + S::kOut + s * S::kOutBytes);
    for (int v = tid; v < (int)r.body / kStep; v += kThreads) {
      Pack<IN, kStep> a;
      Pack<OUT, kStep> b;
      a.w = reinterpret_cast<const decltype(a.w)*>(in)[v];
#pragma unroll
      for (int i = 0; i < kStep; ++i) b.e[i] = from_f32<OUT>(to_f32<IN>(a.e[i]));
      reinterpret_cast<decltype(b.w)*>(out)[v] = b.w;
    }
    const TI* x = reinterpret_cast<const TI*>(r.src);
    TO* y = reinterpret_cast<TO*>(r.dst);
    for (int64_t i = r.lo0 + tid; i < r.lo1; i += kThreads) y[i] = from_f32<OUT>(to_f32<IN>(x[i]));
    for (int64_t i = r.hi0 + tid; i < r.hi1; i += kThreads) y[i] = from_f32<OUT>(to_f32<IN>(x[i]));
    fence_proxy_async();
    // The next unit writes the output buffer of unit k + 1 - kStages: its
    // store (committed kStages - 2 groups before the newest) must be done
    // reading before any thread passes the barrier below.
    if (tid == 0) bulk_wait_read<kStages - 2>();
    __syncthreads();
    if (tid == 0) {
      if (r.body) {
        bulk_store(r.dst + (uint64_t)r.body0 * sizeof(TO), smem_addr(out),
                   r.body * (uint32_t)sizeof(TO));
      }
      bulk_commit();  // one group per unit, empty when it had no body
      const uint32_t next = u + kStages * grid;
      if (next < units) start_unit<IN, OUT, CAP>(table, first, smem, next, s, cur);
    }
  }
  if (tid == 0) bulk_wait_all();
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

template <int IN, int OUT, int CAP>
int launch_cap(const Entry* entries, int count, uint32_t units, cudaStream_t stream) {
  using S = Shape<IN, OUT>;
  constexpr int kSmem = S::bytes(CAP);
  static int ctas_per_sm = 0;  // resident CTAs per SM; set once per kernel
  if (ctas_per_sm == 0) {
    cudaError_t err = cudaFuncSetAttribute(cast_group<IN, OUT, CAP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
    int occ = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, cast_group<IN, OUT, CAP>,
                                                        kThreads, kSmem);
    if (err != cudaSuccess) return (int)err;
    ctas_per_sm = occ < 1 ? 1 : (occ > kCtasPerSm ? kCtasPerSm : occ);
  }
  Table<CAP> table;
  table.count = count;
  table.units = units;
  memcpy(table.e, entries, sizeof(Entry) * (size_t)count);
  uint32_t grid = (uint32_t)(sm_count() * ctas_per_sm);
  if (grid > units) grid = units;
  cast_group<IN, OUT, CAP><<<grid, kThreads, kSmem, stream>>>(table);
  return (int)cudaGetLastError();
}

template <int IN, int OUT>
int launch(const Entry* entries, int count, uint32_t units, cudaStream_t stream) {
  if (count <= kSmallEntries) return launch_cap<IN, OUT, kSmallEntries>(entries, count, units, stream);
  return launch_cap<IN, OUT, kMaxEntries>(entries, count, units, stream);
}

}  // namespace

// Cast ``count`` entries (``entries``: host memory, Entry layout) that share
// one (in_kind, out_kind) pair; ``units`` is the group's work-unit count (the
// last entry's first + its units). One launch on ``stream``.
extern "C" int tst_cast_group(const void* entries, int count, int in_kind, int out_kind,
                              uint32_t units, void* stream) {
  if (count <= 0 || units == 0) return 0;
  if (count > kMaxEntries) return kBadTable;
  const Entry* e = static_cast<const Entry*>(entries);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_kind * 3 + out_kind) {
    case kF32 * 3 + kBF16: return launch<kF32, kBF16>(e, count, units, s);
    case kF32 * 3 + kF16: return launch<kF32, kF16>(e, count, units, s);
    case kBF16 * 3 + kF32: return launch<kBF16, kF32>(e, count, units, s);
    case kF16 * 3 + kF32: return launch<kF16, kF32>(e, count, units, s);
    case kBF16 * 3 + kF16: return launch<kBF16, kF16>(e, count, units, s);
    case kF16 * 3 + kBF16: return launch<kF16, kBF16>(e, count, units, s);
    default: return kBadPair;
  }
}
