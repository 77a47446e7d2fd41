// Densify a columnar (CSR) chunk into the padded [B*T, P] key block and its
// valid mask, and range-check every key, for Hopper.
//
// Replaces no Pallas kernel: the reference builds the block on the host
// (src/repro/runtime/engine.py, dense_from_chunk), and so did the port, in
// a numpy pass over every one of the block's B*T*P slots followed by a
// range check over all of them and a copy of 5 bytes a slot to the card.
// Here the host sends the chunk's int64 keys as they are and two int32
// words a segment, and the card builds the block.
//
//   row r of the block (query r / T, table slot r % T) holds segment
//   s = row_seg[r] (-1: none), whose keys are values[seg_offsets[s] ..
//   seg_offsets[s + 1]):
//     idx[r, p]   = values[seg_offsets[s] + p]   for p < len(s), else 0
//     valid[r, p] = p < len(s)
//   bad         = the keys v with v < 0 or v >= rows_per_table[r % T]
//
// What bounds it on an H100: bytes. It reads each key once (8 bytes)
// and a few words a row, and writes 5 bytes a slot; there is no arithmetic.
// At M2's chunk (921,600 slots, 359,200 keys) that is under 8 MB, a few µs
// at 3.35 TB/s.
//
// Design. The block is written in one pass, each slot once, with no memset
// before it: a thread owns 4 consecutive slots of the flattened block (P is
// a power of two, so slot f is position f & (P - 1) of row f >> log2(P)),
// reads its row's segment through the inverse map row_seg (built on the
// host from the segments' rows, so empty rows need no second pass), loads
// the keys its slots hold and stores the 4 keys as one 16-byte vector and
// the 4 flags as one 4-byte word. Neighbouring threads own neighbouring
// slots, so every store is coalesced, and so is every key load within a
// row. A key is compared with its table's rows as an int64, before it is
// narrowed to int32, so a key past 2^31 is counted rather than wrapped into
// range. A warp sums its counts (__reduce_add_sync) and
// one lane adds the sum to `bad`, which the launcher zeroes first on the
// same stream. The host reads `bad` once and raises before the step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 4;  // slots a thread owns: one int4 of keys, one word of flags

__global__ void densify_kernel(const int64_t* __restrict__ values,
                               const int32_t* __restrict__ row_seg,
                               const int32_t* __restrict__ seg_offsets,
                               const int64_t* __restrict__ rows_per_table,
                               int32_t* __restrict__ idx, uint8_t* __restrict__ valid,
                               int32_t* __restrict__ bad, int64_t n_slots,
                               int64_t num_tables, int log_p) {
  const int64_t f0 =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kSlots;
  const int64_t p_mask = (int64_t{1} << log_p) - 1;
  int32_t key[kSlots];
  uint32_t flags = 0u;
  int n_bad = 0;
  int64_t row = -1, start = 0, len = 0, limit = 0;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    key[k] = 0;
    const int64_t f = f0 + k;
    if (f >= n_slots) continue;
    const int64_t r = f >> log_p;
    if (r != row) {  // once a thread unless P < 4
      row = r;
      const int32_t s = row_seg[r];
      start = s >= 0 ? seg_offsets[s] : 0;
      len = s >= 0 ? seg_offsets[s + 1] - start : 0;
      limit = rows_per_table[r % num_tables];
    }
    const int64_t p = f & p_mask;
    if (p < len) {
      const int64_t v = values[start + p];
      n_bad += (v < 0) | (v >= limit);
      key[k] = static_cast<int32_t>(v);
      flags |= 1u << (8 * k);
    }
  }
  if (f0 + kSlots <= n_slots) {
    *reinterpret_cast<int4*>(idx + f0) = make_int4(key[0], key[1], key[2], key[3]);
    *reinterpret_cast<uint32_t*>(valid + f0) = flags;
  } else {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      if (f0 + k < n_slots) {
        idx[f0 + k] = key[k];
        valid[f0 + k] = static_cast<uint8_t>((flags >> (8 * k)) & 1u);
      }
    }
  }
  // every thread of a launched block gets here: the full mask is safe
  n_bad = __reduce_add_sync(0xffffffffu, n_bad);
  if ((threadIdx.x & 31) == 0 && n_bad) atomicAdd(bad, n_bad);
}

}  // namespace

// A shape the kernel cannot take (no tables, P past 2^30, an output not
// aligned for its vector stores) is refused with cudaErrorInvalidValue and
// nothing launches.
extern "C" int densify_i64(const void* values, const void* row_seg, const void* seg_offsets,
                           const void* rows_per_table, void* idx, void* valid, void* bad,
                           int64_t n_rows, int64_t num_tables, int64_t log_p,
                           void* stream_ptr) {
  if (n_rows < 0 || num_tables < 1 || log_p < 0 || log_p > 30 ||
      reinterpret_cast<uintptr_t>(idx) % 16 || reinterpret_cast<uintptr_t>(valid) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = cudaMemsetAsync(bad, 0, sizeof(int32_t), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_slots = n_rows << log_p;
  if (n_slots == 0) return static_cast<int>(cudaGetLastError());
  const int64_t threads = (n_slots + kSlots - 1) / kSlots;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads));
  densify_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const int64_t*>(values), static_cast<const int32_t*>(row_seg),
      static_cast<const int32_t*>(seg_offsets), static_cast<const int64_t*>(rows_per_table),
      static_cast<int32_t*>(idx), static_cast<uint8_t*>(valid), static_cast<int32_t*>(bad),
      n_slots, num_tables, static_cast<int>(log_p));
  return static_cast<int>(cudaGetLastError());
}
