// Set-associative row-cache probe (the HBM row cache's hot path) for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/cache_probe.py
// (cache_probe, pallas_call at line 58, body _kernel at line 21).
//
// Per query n with s = sets[n]:
//   match[w]  = tag_table[s, w] == q_table[n] && tag_row[s, w] == q_row[n]
//   values[n] = sum_w match[w] * data[s, w, :]   (zeros on a miss)
//   hit[n]    = any(match)
//
// What bounds it on an H100: bytes. A probe reads 2 * W tag words and, on a
// hit, one cached row of D floats, and writes D floats and one int; there is
// no arithmetic to speak of. Each probe is a chain of three dependent
// trips to memory (its set id, the set's tags, the matching row), so what
// the card reaches is set by how many chains are in flight at once.
//
// Design. A warp owns up to 32 queries (`queries_per_warp`, chosen by the
// wrapper, kernels/cache_probe.py `launch_plan`) and takes each trip for
// all of them together:
//   1. Lane j loads sets[n], q_table[n] and q_row[n] of query n = n0 + j
//      (three coalesced loads) and checks the set id against [0, S).
//   2. Lane groups of WP lanes (W rounded up to a power of two) probe
//      32 / WP queries at once (4 at W 8), lane w of a group comparing way w.
//      The tags of up to 8 such rounds are loaded before the first compare,
//      so the tag lines of up to 32 sets are in flight together. One
//      __ballot_sync per round gives every group's match mask at once; the
//      lane holding query j keeps its group's bits (a segmented ballot), and
//      writes hit[n] (coalesced).
//   3. Lanes span D in float4 (or float2, float) vectors, 32 / (D / VEC)
//      queries per instruction when a row is narrower than a warp. The
//      first matching row of up to 8 such rounds is loaded before any is
//      summed; further matching ways (a key held twice) are added after it
//      in way order, as the reference's one-hot contraction sums them. A
//      miss writes zeros and reads no data.
// The Pallas kernel moves the whole [W, D] set into VMEM and selects the hit
// row with a one-hot matmul (an MXU idiom); here only the matching ways'
// rows are read. The LRU stamp and counter updates stay outside the kernel,
// as in the reference. W <= 32 (one lane per way); the wrapper enforces it.

#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;
constexpr int kBatch = 8;  // rounds of tags, and of rows, in flight at once

template <int VEC> struct FVec;
template <> struct FVec<4> { using T = float4; };
template <> struct FVec<2> { using T = float2; };
template <> struct FVec<1> { using T = float; };

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}
__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

template <typename V> __device__ __forceinline__ V zero();
template <> __device__ __forceinline__ float4 zero<float4>() { return make_float4(0.f, 0.f, 0.f, 0.f); }
template <> __device__ __forceinline__ float2 zero<float2>() { return make_float2(0.f, 0.f); }
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }

template <int WP, int VEC>
__global__ void cache_probe_kernel(const int32_t* __restrict__ tag_table,
                                   const int32_t* __restrict__ tag_row,
                                   const float* __restrict__ data,
                                   const int32_t* __restrict__ q_table,
                                   const int32_t* __restrict__ q_row,
                                   const int32_t* __restrict__ sets,
                                   float* __restrict__ values,
                                   int32_t* __restrict__ hit,
                                   int64_t n_queries, int64_t n_sets,
                                   int ways, int64_t dim, int queries_per_warp) {
  using V = typename FVec<VEC>::T;
  constexpr int kGroups = 32 / WP;                       // queries per round
  constexpr unsigned kGroupMask = WP == 32 ? kFull : (1u << WP) - 1u;
  const int lane = threadIdx.x & 31;
  const int64_t gwarp = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t n0 = gwarp * queries_per_warp;
  if (n0 >= n_queries) return;                           // the whole warp leaves
  const int nq = static_cast<int>(n_queries - n0 < queries_per_warp ? n_queries - n0
                                                                    : queries_per_warp);

  // 1. the warp's queries, one per lane
  int32_t s = 0, qt = 0, qr = 0;
  if (lane < nq) {
    s = sets[n0 + lane];
    assert(s >= 0 && s < n_sets);
    qt = q_table[n0 + lane];
    qr = q_row[n0 + lane];
  }

  // 2. tags: round k probes queries k * kGroups + g, lane w of group g way w
  const int g = lane / WP, w = lane % WP;
  const int rounds = (nq + kGroups - 1) / kGroups;
  unsigned mask = 0u;                                    // of query `lane`
  for (int k0 = 0; k0 < rounds; k0 += kBatch) {
    int32_t tt[kBatch], tr[kBatch], want_t[kBatch], want_r[kBatch];
    bool live[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (k0 + b >= rounds) break;                       // uniform across the warp
      const int j = (k0 + b) * kGroups + g;
      const int64_t sj = __shfl_sync(kFull, s, j & 31);
      want_t[b] = __shfl_sync(kFull, qt, j & 31);
      want_r[b] = __shfl_sync(kFull, qr, j & 31);
      live[b] = j < nq && w < ways;
      if (live[b]) {
        tt[b] = tag_table[sj * ways + w];
        tr[b] = tag_row[sj * ways + w];
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (k0 + b >= rounds) break;                       // uniform across the warp
      const unsigned ballot = __ballot_sync(
          kFull, live[b] && tt[b] == want_t[b] && tr[b] == want_r[b]);
      if (lane / kGroups == k0 + b) mask = (ballot >> ((lane % kGroups) * WP)) & kGroupMask;
    }
  }
  if (lane < nq) hit[n0 + lane] = mask != 0u;

  // 3. rows: lane c of a row group holds vector c (plus multiples of `span`)
  const int64_t row_vecs = dim / VEC;
  if (row_vecs == 0) return;
  const int span = row_vecs < 32 ? static_cast<int>(row_vecs) : 32;
  const int qgroups = 32 / span;
  const int gq = lane / span, c = lane - gq * span;
  for (int64_t col = c; col - c < row_vecs; col += span) {
    for (int j0 = 0; j0 < nq; j0 += qgroups * kBatch) {
      V x[kBatch];
      unsigned m[kBatch];
      int32_t set[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (j0 + b * qgroups >= nq) break;               // uniform across the warp
        const int j = j0 + b * qgroups + gq;
        m[b] = __shfl_sync(kFull, mask, j & 31);
        set[b] = __shfl_sync(kFull, s, j & 31);
        const bool ok = gq < qgroups && j < nq && col < row_vecs;
        if (!ok) m[b] = 0u;
        x[b] = zero<V>();
        if (m[b]) {
          const int way = __ffs(static_cast<int>(m[b])) - 1;
          x[b] = *reinterpret_cast<const V*>(data + (static_cast<int64_t>(set[b]) * ways + way) * dim + col * VEC);
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (j0 + b * qgroups >= nq) break;               // uniform across the warp
        const int j = j0 + b * qgroups + gq;
        if (gq >= qgroups || j >= nq || col >= row_vecs) continue;
        V acc = zero<V>();
        if (m[b]) {
          acc = add(acc, x[b]);
          for (unsigned rest = m[b] & (m[b] - 1u); rest; rest &= rest - 1u) {
            const int way = __ffs(static_cast<int>(rest)) - 1;
            acc = add(acc, *reinterpret_cast<const V*>(
                data + (static_cast<int64_t>(set[b]) * ways + way) * dim + col * VEC));
          }
        }
        *reinterpret_cast<V*>(values + (n0 + j) * dim + col * VEC) = acc;
      }
    }
  }
}

template <int WP>
int launch_ways(const void* tag_table, const void* tag_row, const void* data,
                const void* q_table, const void* q_row, const void* sets,
                void* values, void* hit, int64_t n_queries, int64_t n_sets,
                int ways, int64_t dim, int queries_per_warp, int vec,
                cudaStream_t stream) {
  const int64_t warps = (n_queries + queries_per_warp - 1) / queries_per_warp;
  const dim3 grid(static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const dim3 block(32 * kWarpsPerBlock);
#define PROBE_ARGS                                                                  \
  static_cast<const int32_t*>(tag_table), static_cast<const int32_t*>(tag_row),     \
      static_cast<const float*>(data), static_cast<const int32_t*>(q_table),        \
      static_cast<const int32_t*>(q_row), static_cast<const int32_t*>(sets),        \
      static_cast<float*>(values), static_cast<int32_t*>(hit), n_queries, n_sets,   \
      ways, dim, queries_per_warp
  switch (vec) {
    case 4: cache_probe_kernel<WP, 4><<<grid, block, 0, stream>>>(PROBE_ARGS); break;
    case 2: cache_probe_kernel<WP, 2><<<grid, block, 0, stream>>>(PROBE_ARGS); break;
    case 1: cache_probe_kernel<WP, 1><<<grid, block, 0, stream>>>(PROBE_ARGS); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PROBE_ARGS
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launch plan comes from the wrapper; a plan the kernel cannot run (a
// vector width that does not divide D or the data's base, more than 32
// queries a warp or ways) is refused with cudaErrorInvalidValue and nothing
// launches.
extern "C" int cache_probe_f32(const void* tag_table, const void* tag_row,
                               const void* data, const void* q_table,
                               const void* q_row, const void* sets,
                               void* values, void* hit, int64_t n_queries,
                               int64_t n_sets, int64_t ways, int64_t dim,
                               int64_t queries_per_warp, int64_t vec,
                               void* stream_ptr) {
  if (ways < 0 || ways > 32 || queries_per_warp < 1 || queries_per_warp > 32 ||
      (vec != 1 && vec != 2 && vec != 4) || dim % vec ||
      reinterpret_cast<uintptr_t>(data) % (4 * vec))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  const int w = static_cast<int>(ways), q = static_cast<int>(queries_per_warp);
  const int v = static_cast<int>(vec);
#define LAUNCH(WP)                                                                 \
  return launch_ways<WP>(tag_table, tag_row, data, q_table, q_row, sets, values,   \
                         hit, n_queries, n_sets, w, dim, q, v, stream)
  if (w <= 1) LAUNCH(1);
  if (w <= 2) LAUNCH(2);
  if (w <= 4) LAUNCH(4);
  if (w <= 8) LAUNCH(8);
  if (w <= 16) LAUNCH(16);
  LAUNCH(32);
#undef LAUNCH
}
