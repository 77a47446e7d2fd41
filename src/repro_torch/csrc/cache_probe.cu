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
// no arithmetic to speak of.
//
// Design: one warp per query, eight queries per block. Lane w < W compares
// way w's two tags and a warp ballot gives the match mask, so the tags are
// read once as two short contiguous loads. The Pallas kernel moves the whole
// [W, D] set into VMEM and selects the hit row with a one-hot matmul (an MXU
// idiom); here only the matching ways' rows are read, lanes spanning D, and
// their sum is written directly. A miss writes zeros and reads no data. The
// LRU stamp and counter updates stay outside the kernel, as in the reference.
// W <= 32 (one lane per way); the wrapper enforces it.

#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kQueriesPerBlock = 8;

__global__ void cache_probe_kernel(const int32_t* __restrict__ tag_table,
                                   const int32_t* __restrict__ tag_row,
                                   const float* __restrict__ data,
                                   const int32_t* __restrict__ q_table,
                                   const int32_t* __restrict__ q_row,
                                   const int32_t* __restrict__ sets,
                                   float* __restrict__ values,
                                   int32_t* __restrict__ hit,
                                   int64_t n_queries, int64_t n_sets,
                                   int64_t ways, int64_t dim) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * kQueriesPerBlock + threadIdx.y;
  if (n >= n_queries) return;  // whole warp leaves together: n is per warp
  const int lane = threadIdx.x;
  const int64_t s = sets[n];
  assert(s >= 0 && s < n_sets);
  bool match = false;
  if (lane < ways) {
    const int64_t slot = s * ways + lane;
    match = tag_table[slot] == q_table[n] && tag_row[slot] == q_row[n];
  }
  const unsigned mask = __ballot_sync(0xffffffffu, match);
  if (lane == 0) hit[n] = mask != 0u;
  const float* line = data + s * ways * dim;
  for (int64_t d = lane; d < dim; d += 32) {
    float acc = 0.0f;
    for (unsigned m = mask; m != 0u; m &= m - 1u) {
      const int w = __ffs(static_cast<int>(m)) - 1;
      acc = __fadd_rn(acc, line[w * dim + d]);
    }
    values[n * dim + d] = acc;
  }
}

}  // namespace

extern "C" int cache_probe_f32(const void* tag_table, const void* tag_row,
                               const void* data, const void* q_table,
                               const void* q_row, const void* sets,
                               void* values, void* hit, int64_t n_queries,
                               int64_t n_sets, int64_t ways, int64_t dim,
                               void* stream) {
  const dim3 block(32, kQueriesPerBlock);
  const dim3 grid(static_cast<unsigned>((n_queries + kQueriesPerBlock - 1) / kQueriesPerBlock));
  cache_probe_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tag_table), static_cast<const int32_t*>(tag_row),
      static_cast<const float*>(data), static_cast<const int32_t*>(q_table),
      static_cast<const int32_t*>(q_row), static_cast<const int32_t*>(sets),
      static_cast<float*>(values), static_cast<int32_t*>(hit), n_queries, n_sets,
      ways, dim);
  return static_cast<int>(cudaGetLastError());
}
