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
// operations-per-byte line.
//
// Design: one warp per bag, eight bags per block. The Pallas kernel walks the
// pooling axis as a sequential grid dimension and accumulates in the revisited
// VMEM output block; here a loop over p inside the warp takes that place and
// the sum lives in registers, so nothing crosses blocks. Lanes span D with no
// padding (D = 8, 24, 96 all work: a lane takes d = lane, lane + 32, ...), so
// a warp's loads of one row are contiguous bytes. Masked positions point at
// the store's zero sentinel row (scale = bias = 0), so there is no bounds
// mask over p; an index outside [0, R) is a caller bug and trips the device
// assert instead of reading past the store.
//
// Products and sums use the _rn intrinsics so the compiler does not contract
// them into an fma: each value is rounded exactly as the plain PyTorch
// version rounds it, and only the order of the sum over p can differ.

#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBagsPerBlock = 8;

template <typename T>
__global__ void gather_pool_kernel(const T* __restrict__ payload,
                                   const float* __restrict__ scale,
                                   const float* __restrict__ bias,
                                   const int32_t* __restrict__ idx,
                                   float* __restrict__ out,
                                   int64_t n_bags, int64_t pooling,
                                   int64_t dim, int64_t n_rows) {
  const int64_t bag = static_cast<int64_t>(blockIdx.x) * kBagsPerBlock + threadIdx.y;
  if (bag >= n_bags) return;
  const int32_t* bag_idx = idx + bag * pooling;
  for (int64_t d = threadIdx.x; d < dim; d += 32) {
    float acc = 0.0f;
    for (int64_t p = 0; p < pooling; ++p) {
      const int64_t i = bag_idx[p];
      assert(i >= 0 && i < n_rows);
      const float q = static_cast<float>(payload[i * dim + d]);
      acc = __fadd_rn(acc, __fadd_rn(__fmul_rn(q, scale[i]), bias[i]));
    }
    out[bag * dim + d] = acc;
  }
}

template <typename T>
int launch(const void* payload, const void* scale, const void* bias,
           const void* idx, void* out, int64_t n_bags, int64_t pooling,
           int64_t dim, int64_t n_rows, void* stream) {
  const dim3 block(32, kBagsPerBlock);
  const dim3 grid(static_cast<unsigned>((n_bags + kBagsPerBlock - 1) / kBagsPerBlock));
  gather_pool_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(payload), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const int32_t*>(idx),
      static_cast<float*>(out), n_bags, pooling, dim, n_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int gather_pool_u8(const void* payload, const void* scale, const void* bias,
                   const void* idx, void* out, int64_t n_bags, int64_t pooling,
                   int64_t dim, int64_t n_rows, void* stream) {
  return launch<uint8_t>(payload, scale, bias, idx, out, n_bags, pooling, dim,
                         n_rows, stream);
}

int gather_pool_i8(const void* payload, const void* scale, const void* bias,
                   const void* idx, void* out, int64_t n_bags, int64_t pooling,
                   int64_t dim, int64_t n_rows, void* stream) {
  return launch<int8_t>(payload, scale, bias, idx, out, n_bags, pooling, dim,
                        n_rows, stream);
}

}  // extern "C"
