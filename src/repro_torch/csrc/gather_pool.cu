// Fused gather + row-wise dequant + sum pool (SparseLengthsSum) for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gather_pool.py
// (gather_pool, pallas_call at line 57, body _kernel at line 25).
//
//   out[n, d] = sum_p payload[i, d] * scale[i] + bias[i],   i = idx[n, p]
//
// What bounds it on an H100: bytes. Per bag it reads P indices, P quantized
// rows of D bytes plus 8 bytes of scale/bias, and writes D floats; there is
// one multiply and two adds per payload byte, far below the card's
// operations-per-byte line. The rows are random, and each pooled row costs
// three random reads (its payload, its scale, its bias: separate arrays),
// so at large batches the card's rate of random accesses, not its byte
// rate, sets the time (PERF.md, m1_batch).
//
// Design. One warp takes one bag (or a slice of its row, when a row is wider
// than 128 bytes: `warps_per_bag` warps then split it), and walks the bag's
// indices in steps of up to 64 rows (every bag of M1, pooling 42, is one
// step, with a tile of 42 rows):
//   1. Lane l loads idx[l] and idx[32 + l] (two coalesced loads of 32),
//      checks them against [0, R) once (the device assert stays: an index
//      out of range traps), and loads their scale and bias.
//   2. The warp's lanes form groups of `cols` lanes, each lane one vector of
//      V = 16, 8, 4, 2 or 1 bytes (the widest the row length and the
//      store's base allow), so a group covers the warp's slice of one row
//      and one warp instruction fetches 32 / cols rows (8 rows of 64 bytes
//      at V = 16); the indices reach the groups through the warp's slots in
//      shared memory. Every row of the step goes into the warp's tile by
//      cp.async (a load and a store below 4 bytes) before any is used, so a
//      bag's rows, scales and biases take one round trip together.
//   3. Each lane sums its own 1-4 bytes of the slice over p in index order,
//      taking scale and bias from lane p by __shfl_sync. The sum is carried
//      across steps in registers; each output element is written once.
// A warp's slice is at most 128 bytes and 32 vectors, so its tile (sized to
// min(P, 64) rows) is at most 8 KB and each lane owns at most one word of
// the slice.
//
// Occupancy: the wrapper (kernels/gather_pool.py, `launch_plan`) puts 4
// bags in a block when that still leaves two blocks for each of the 132
// SMs, and fewer down to one otherwise: the serving path's 256 bags of P 8
// become 256 one-warp blocks on all SMs (four-bag blocks would fill 64),
// while M1's 7,808 bags of P 42 become 1,952 blocks of 4 warps. A block's
// 22 KB of shared memory and about 50 registers a thread leave room for
// about 36 warps on an SM, each with a bag's 5.4 KB (126 random reads) in
// flight: far more than the card's memory rate times its latency needs.
//
// Exactness: the Pallas kernel walks p as a sequential grid dimension and
// accumulates in the revisited output block; here one lane carries each
// output element's sum over p in index order. Products and sums use the _rn
// intrinsics so the compiler does not contract them into an fma, so the
// result is bit-identical to an in-order loop of the plain ops. Bytes
// become floats exactly through the 2^23 trick (OR the byte into the
// mantissa of 2^23, subtract 2^23), one byte-permute and one add.

#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSliceBytes = 128;  // bytes of a row one warp covers
constexpr int kTileRows = 64;        // most rows of a bag in flight at once: two index loads
constexpr int kMaxWarpsPerBlock = 4;  // 4 x 64 x 128 B = 32 KB of tiles

// Vectors of one row slice a warp covers, at vector width V.
__host__ __device__ constexpr int max_cols(int V) {
  return kMaxSliceBytes / V < 32 ? kMaxSliceBytes / V : 32;
}

// Bytes of a block's row tiles, rounded up so the index slots after them
// are aligned.
__host__ __device__ constexpr int tiles_bytes(int bytes) { return (bytes + 15) & ~15; }

template <int V> struct Vec;
template <> struct Vec<16> { using T = uint4; };
template <> struct Vec<8> { using T = uint2; };
template <> struct Vec<4> { using T = uint32_t; };
template <> struct Vec<2> { using T = uint16_t; };
template <> struct Vec<1> { using T = uint8_t; };

// One vector of a row to byte `off` of the tile (shared address `tile_s`):
// cp.async for 4, 8 and 16 bytes (the copy holds no register while in
// flight), a load and a store below that.
template <int V>
__device__ __forceinline__ void copy_vec(uint8_t* tile, unsigned tile_s, int off,
                                         const uint8_t* src) {
  if constexpr (V == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(tile_s + off), "l"(src));
  } else if constexpr (V >= 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(tile_s + off), "l"(src),
                 "n"(V));
  } else {
    using VecT = typename Vec<V>::T;
    *reinterpret_cast<VecT*>(tile + off) = __ldg(reinterpret_cast<const VecT*>(src));
  }
}

// Byte e of word u as a float, exactly: 2^23 + byte, minus 2^23. An int8
// word comes with its bytes XOR 0x80 (done by the caller), so its bytes are
// value + 128 and 2^23 + 128 is subtracted.
template <typename T>
__device__ __forceinline__ float byte_to_float(uint32_t u, int e) {
  const uint32_t sel = static_cast<uint32_t>(e) | 0x7540u;  // byte e, 0, 0, 0x4B
  const float f = __uint_as_float(__byte_perm(u, 0x4B000000u, sel));
  return __fsub_rn(f, std::is_signed<T>::value ? 8388736.0f : 8388608.0f);
}

// acc += q * s + b for tile rows [first, last), in order, each rounded as
// the plain ops round it; lane p % 32 holds row p's scale and bias.
// Unrolled only at the widths that use cp.async: below them ptxas spills
// around the assert's call.
template <typename T, int V, int kOwn>
__device__ __forceinline__ void sum_rows(float (&acc)[kOwn], const uint8_t* tile, int stride,
                                         int lane, bool owner, int first, int last, float s,
                                         float b) {
#pragma unroll (V >= 4 ? 2 : 1)
  for (int p = first; p < last; ++p) {
    const float sp = __shfl_sync(kFull, s, p & 31);
    const float bp = __shfl_sync(kFull, b, p & 31);
    if (owner) {
      uint32_t u;
      if constexpr (kOwn == 4) u = *reinterpret_cast<const uint32_t*>(tile + p * stride + lane * 4);
      else if constexpr (kOwn == 2) u = *reinterpret_cast<const uint16_t*>(tile + p * stride + lane * 2);
      else u = tile[p * stride + lane];
      if constexpr (std::is_signed<T>::value) u ^= 0x80808080u;
#pragma unroll
      for (int e = 0; e < kOwn; ++e)
        acc[e] = __fadd_rn(acc[e], __fadd_rn(__fmul_rn(byte_to_float<T>(u, e), sp), bp));
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kMaxWarpsPerBlock * 32)
gather_pool_kernel(const uint8_t* __restrict__ payload, const float* __restrict__ scale,
                   const float* __restrict__ bias, const int32_t* __restrict__ idx,
                   float* __restrict__ out, int64_t n_bags, int64_t pooling,
                   int64_t dim, int64_t n_rows, int warps_per_bag, int cols,
                   int tile_rows) {
  constexpr int kOwn = V < 4 ? V : 4;                       // bytes a lane sums
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t gwarp = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  const int64_t bag = gwarp / warps_per_bag;
  if (bag >= n_bags) return;                     // the whole warp leaves
  const int part = static_cast<int>(gwarp % warps_per_bag);
  const int64_t row_vecs = dim / V;
  const int col0 = part * cols;                  // first vector of the slice
  const int my_cols = static_cast<int>(row_vecs - col0 < cols ? row_vecs - col0 : cols);
  const int slice = my_cols * V;                 // bytes of the slice
  const int stride = cols * V;                   // tile row pitch
  uint8_t* tile = smem + warp * tile_rows * stride;
  int32_t* slots = reinterpret_cast<int32_t*>(
                       smem + tiles_bytes((blockDim.x >> 5) * tile_rows * stride)) +
                   warp * tile_rows;
  const unsigned tile_s = static_cast<unsigned>(__cvta_generic_to_shared(tile));
  const int groups = 32 / my_cols;               // rows per warp instruction
  const int g = lane / my_cols, c = lane - g * my_cols;
  const bool owner = lane * kOwn < slice;
  const int32_t* bag_idx = idx + bag * pooling;
  const uint8_t* base = payload + static_cast<int64_t>(col0) * V + c * V;

  float acc[kOwn];
#pragma unroll
  for (int e = 0; e < kOwn; ++e) acc[e] = 0.0f;

  for (int64_t p0 = 0; p0 < pooling; p0 += tile_rows) {
    const int rows = static_cast<int>(pooling - p0 < tile_rows ? pooling - p0 : tile_rows);
    // 1. indices p0 + lane and p0 + 32 + lane, checked once, with their
    //    scale and bias: every load of the step in flight together
    int32_t i0 = 0, i1 = 0;
    float s0 = 0.0f, b0 = 0.0f, s1 = 0.0f, b1 = 0.0f;
    if (lane < rows) i0 = bag_idx[p0 + lane];
    if (lane + 32 < rows) i1 = bag_idx[p0 + 32 + lane];
    assert(i0 >= 0 && i0 < n_rows && i1 >= 0 && i1 < n_rows);
    if (lane < rows) {
      s0 = scale[i0];
      b0 = bias[i0];
    }
    if (lane + 32 < rows) {
      s1 = scale[i1];
      b1 = bias[i1];
    }
    // 2. every row of the step into the tile, `groups` rows an instruction,
    //    each group reading its rows' indices from the warp's index slots
    if (lane < rows) slots[lane] = i0;
    if (lane + 32 < rows) slots[32 + lane] = i1;
    __syncwarp();
    if (g < groups) {
#pragma unroll 4
      for (int p = g; p < rows; p += groups)
        copy_vec<V>(tile, tile_s, p * stride + c * V, base + static_cast<int64_t>(slots[p]) * dim);
    }
    if constexpr (V >= 4) asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
    // 3. each owner sums its bytes over p in index order
    sum_rows<T, V>(acc, tile, stride, lane, owner, 0, rows < 32 ? rows : 32, s0, b0);
    sum_rows<T, V>(acc, tile, stride, lane, owner, 32, rows, s1, b1);
    __syncwarp();                                // the tile is rewritten next step
  }
  if (!owner) return;
  float* dst = out + bag * dim + static_cast<int64_t>(col0) * V + lane * kOwn;
  if constexpr (kOwn == 4) *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  else if constexpr (kOwn == 2) *reinterpret_cast<float2*>(dst) = make_float2(acc[0], acc[1]);
  else dst[0] = acc[0];
}

template <typename T, int V>
int launch_width(const void* payload, const void* scale, const void* bias,
                 const void* idx, void* out, int64_t n_bags, int64_t pooling,
                 int64_t dim, int64_t n_rows, int warps, int warps_per_bag,
                 cudaStream_t stream) {
  const int64_t row_vecs = dim / V;
  const int cols = static_cast<int>((row_vecs + warps_per_bag - 1) / warps_per_bag);
  if (cols > max_cols(V) || static_cast<int64_t>(cols) * (warps_per_bag - 1) >= row_vecs)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n_bags * warps_per_bag + warps - 1) / warps;
  const int tile_rows = pooling < 1 ? 1 : pooling < kTileRows ? static_cast<int>(pooling) : kTileRows;
  const size_t smem = tiles_bytes(warps * tile_rows * cols * V) + warps * tile_rows * sizeof(int32_t);
  gather_pool_kernel<T, V><<<static_cast<unsigned>(blocks), warps * 32, smem, stream>>>(
      static_cast<const uint8_t*>(payload), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const int32_t*>(idx),
      static_cast<float*>(out), n_bags, pooling, dim, n_rows, warps_per_bag, cols, tile_rows);
  return static_cast<int>(cudaGetLastError());
}

// The launch plan comes from the wrapper; a plan the kernel cannot run
// (a width that does not divide the row or the base, too wide a slice, too
// many warps) is refused with cudaErrorInvalidValue and nothing launches.
// A block holds bags_per_block bags of warps_per_bag warps; a bag that needs
// more than a block's 4 warps (a row wider than 512 bytes) spans blocks.
template <typename T>
int launch(const void* payload, const void* scale, const void* bias,
           const void* idx, void* out, int64_t n_bags, int64_t pooling,
           int64_t dim, int64_t n_rows, int64_t vec, int64_t bags_per_block,
           int64_t warps_per_bag, void* stream_ptr) {
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  if (bags_per_block < 1 || warps_per_bag < 1 || warps_per_bag > (1 << 20) ||
      (bags_per_block > 1 && bags_per_block * warps_per_bag > kMaxWarpsPerBlock) ||
      vec < 1 || dim % vec || reinterpret_cast<uintptr_t>(payload) % vec)
    return static_cast<int>(cudaErrorInvalidValue);
  const int wpb = static_cast<int>(warps_per_bag);
  const int warps = static_cast<int>(
      bags_per_block * warps_per_bag < kMaxWarpsPerBlock ? bags_per_block * warps_per_bag
                                                         : kMaxWarpsPerBlock);
  switch (vec) {
    case 16: return launch_width<T, 16>(payload, scale, bias, idx, out, n_bags, pooling, dim, n_rows, warps, wpb, stream);
    case 8: return launch_width<T, 8>(payload, scale, bias, idx, out, n_bags, pooling, dim, n_rows, warps, wpb, stream);
    case 4: return launch_width<T, 4>(payload, scale, bias, idx, out, n_bags, pooling, dim, n_rows, warps, wpb, stream);
    case 2: return launch_width<T, 2>(payload, scale, bias, idx, out, n_bags, pooling, dim, n_rows, warps, wpb, stream);
    case 1: return launch_width<T, 1>(payload, scale, bias, idx, out, n_bags, pooling, dim, n_rows, warps, wpb, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int gather_pool_u8(const void* payload, const void* scale, const void* bias,
                   const void* idx, void* out, int64_t n_bags, int64_t pooling,
                   int64_t dim, int64_t n_rows, int64_t vec,
                   int64_t bags_per_block, int64_t warps_per_bag, void* stream) {
  return launch<uint8_t>(payload, scale, bias, idx, out, n_bags, pooling, dim,
                         n_rows, vec, bags_per_block, warps_per_bag, stream);
}

int gather_pool_i8(const void* payload, const void* scale, const void* bias,
                   const void* idx, void* out, int64_t n_bags, int64_t pooling,
                   int64_t dim, int64_t n_rows, int64_t vec,
                   int64_t bags_per_block, int64_t warps_per_bag, void* stream) {
  return launch<int8_t>(payload, scale, bias, idx, out, n_bags, pooling, dim,
                        n_rows, vec, bags_per_block, warps_per_bag, stream);
}

}  // extern "C"
