// GQA flash-decode attention for Hopper: one query token per sequence
// against its KV cache, with the cache length split across blocks.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py
// (flash_decode, pallas_call at line 88, body _kernel at line 24).
//
//   out[b, h] = sum_s softmax_s(q[b, h] . k[b, s, h / G] * scale) v[b, s, h / G]
//
// with G = H / K query heads per KV head, scale = 1 / sqrt(hd), and every
// position s >= kv_len[b] scored -1e30 (the reference's mask value, not -inf).
//
// What bounds it on an H100: bytes. Each cached key and value up to kv_len
// is read once and takes part in 2G multiply-adds (G = 3 on smollm-135m):
// about 1.5 operations per bf16 byte, far below the ~295 per byte at which
// the card's arithmetic, not its 3.35 TB/s, becomes the limit.
//
// Design: split-KV flash-decoding, two launches.
// 1. split_kernel: one block of 128 threads per (split, KV head, sequence)
//    loads the G query heads that read this KV head, walks its share of the
//    cache in tiles of 64 positions staged in shared memory as f32, and keeps
//    the online-softmax state (running max m, running sum l, [G, hd]
//    accumulator) in shared memory. It writes (m, l, acc) to scratch.
// 2. combine_kernel: one block per (sequence, query head) merges the splits
//    by log-sum-exp and divides by the total sum.
// The Pallas kernel walks S as a sequential grid axis on one core. Here the
// split is what fills the card: the serving path has B * K = 24 (sequence,
// KV head) pairs for 132 SMs, and the wrapper picks enough splits for about
// four blocks per SM. Only [0, kv_len) is read, since a key past kv_len
// weighs exp(-1e30 - m) = 0 once any key is valid; the bytes moved are the
// bound's bytes. A row with kv_len <= 0 has no valid key: every score is then
// -1e30 and the reference returns the plain mean of v over all S, so that row
// walks all S with every score masked. kv_len > S behaves as S. The ragged
// last tile is masked here, so S need not be a multiple of the tile.
// Plain 16-byte loads, no TMA or wgmma: making it fast is later work.
//
// Arithmetic is f32 with expf (no fast math); bf16 inputs are widened with
// __bfloat162float.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;          // cache positions staged per step
constexpr int kSpanAlign = 16;     // a split's span is a multiple of this
constexpr float kMasked = -1e30f;  // score of a position at or past kv_len

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// Eight consecutive elements at p (16-byte aligned) widened to f32.
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(pairs[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared memory of one split_kernel block, in floats.
__host__ __device__ constexpr int64_t smem_floats(int64_t G, int64_t hd) {
  return 2 * G * hd              // q, acc
         + kTile * (hd + 1)      // k tile, odd row pitch
         + kTile * hd            // v tile
         + G * kTile             // scores, then weights
         + 3 * G;                // m, l, this step's rescale
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
             const TKV* __restrict__ v, const int32_t* __restrict__ kv_len,
             float* __restrict__ part_m, float* __restrict__ part_l,
             float* __restrict__ part_acc, int64_t S, int H, int K, int hd,
             int n_split, float scale) {
  extern __shared__ float smem[];
  const int G = H / K;
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kpitch = hd + 1;  // odd: the score loop's lanes hit distinct banks

  float* q_s = smem;                   // [G, hd]
  float* acc_s = q_s + G * hd;         // [G, hd]
  float* k_s = acc_s + G * hd;         // [kTile, hd + 1]
  float* v_s = k_s + kTile * kpitch;   // [kTile, hd]
  float* p_s = v_s + kTile * hd;       // [G, kTile]
  float* m_s = p_s + G * kTile;        // [G]
  float* l_s = m_s + G;                // [G]
  float* a_s = l_s + G;                // [G]

  // This block's span [lo, hi) of the walked prefix.
  const int64_t len = kv_len[b];
  const int64_t n_walk = len > 0 ? (len < S ? len : S) : S;
  int64_t span = (n_walk + n_split - 1) / n_split;
  span = (span + kSpanAlign - 1) / kSpanAlign * kSpanAlign;
  const int64_t lo = split * span;
  const int64_t hi = lo + span < n_walk ? lo + span : n_walk;

  const TQ* qb = q + (b * H + static_cast<int64_t>(kvh) * G) * hd;
  for (int i = tid; i < G * hd; i += kThreads) {
    q_s[i] = to_float(qb[i]);
    acc_s[i] = 0.0f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kMasked;
    l_s[g] = 0.0f;
  }
  __syncthreads();

  const int row_chunks = hd / 8;
  const int64_t pos_stride = static_cast<int64_t>(K) * hd;
  const TKV* kb = k + (b * S * K + kvh) * hd;
  const TKV* vb = v + (b * S * K + kvh) * hd;
  for (int64_t t0 = lo; t0 < hi; t0 += kTile) {
    const int n = static_cast<int>(hi - t0 < kTile ? hi - t0 : kTile);

    // 1. stage the tile's keys and values as f32 (zeros past n)
    for (int c = tid; c < kTile * row_chunks; c += kThreads) {
      const int s = c / row_chunks, d0 = (c % row_chunks) * 8;
      float kf[8], vf[8];
      if (s < n) {
        const int64_t off = (t0 + s) * pos_stride + d0;
        load8(kb + off, kf);
        load8(vb + off, vf);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) kf[j] = vf[j] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        k_s[s * kpitch + d0 + j] = kf[j];
        v_s[s * hd + d0 + j] = vf[j];
      }
    }
    __syncthreads();

    // 2. scores; a slot past n gets -inf and so weight 0
    for (int i = tid; i < G * kTile; i += kThreads) {
      const int g = i / kTile, s = i % kTile;
      float score = -INFINITY;
      if (s < n) {
        const float* qg = q_s + g * hd;
        const float* ks = k_s + s * kpitch;
        float dot = 0.0f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qg[d], ks[d], dot);
        score = t0 + s < len ? dot * scale : kMasked;
      }
      p_s[i] = score;
    }
    __syncthreads();

    // 3. online softmax, one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      float* pg = p_s + g * kTile;
      float mx = -INFINITY;
      for (int s = lane; s < kTile; s += 32) mx = fmaxf(mx, pg[s]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int s = lane; s < kTile; s += 32) {
        const float p = expf(pg[s] - m_new);
        pg[s] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // 4. acc = acc * alpha + p @ v
    for (int i = tid; i < G * hd; i += kThreads) {
      const int g = i / hd, d = i % hd;
      const float* pg = p_s + g * kTile;
      float acc = acc_s[i] * a_s[g];
      for (int s = 0; s < n; ++s) acc = fmaf(pg[s], v_s[s * hd + d], acc);
      acc_s[i] = acc;
    }
    __syncthreads();
  }

  // An empty span leaves m = -1e30, l = 0, acc = 0: it adds nothing below.
  const int64_t part = ((b * K + kvh) * n_split + split) * G;
  for (int g = tid; g < G; g += kThreads) {
    part_m[part + g] = m_s[g];
    part_l[part + g] = l_s[g];
  }
  for (int i = tid; i < G * hd; i += kThreads) part_acc[part * hd + i] = acc_s[i];
}

__global__ void combine_kernel(const float* __restrict__ part_m,
                               const float* __restrict__ part_l,
                               const float* __restrict__ part_acc,
                               float* __restrict__ out, int H, int K, int hd,
                               int n_split) {
  const int G = H / K;
  const int64_t bh = blockIdx.x;  // b * H + h
  const int64_t b = bh / H;
  const int h = static_cast<int>(bh % H);
  const int kvh = h / G, g = h % G;
  const int64_t first = (b * K + kvh) * n_split;  // split 0 of (b, kv head)

  float m_max = -INFINITY;
  for (int i = 0; i < n_split; ++i) m_max = fmaxf(m_max, part_m[(first + i) * G + g]);
  float l_sum = 0.0f;
  for (int i = 0; i < n_split; ++i) {
    const int64_t r = (first + i) * G + g;
    l_sum += part_l[r] * expf(part_m[r] - m_max);
  }
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float acc = 0.0f;
    for (int i = 0; i < n_split; ++i) {
      const int64_t r = (first + i) * G + g;
      acc += part_acc[r * hd + d] * expf(part_m[r] - m_max);
    }
    out[bh * hd + d] = acc / l_sum;
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, const void* kv_len,
           void* out, void* part_m, void* part_l, void* part_acc, int64_t B,
           int64_t S, int64_t H, int64_t K, int64_t hd, int64_t n_split,
           float scale, void* stream) {
  const size_t smem = static_cast<size_t>(smem_floats(H / K, hd)) * sizeof(float);
  auto kernel = split_kernel<TQ, TKV>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<dim3(static_cast<unsigned>(n_split), static_cast<unsigned>(K),
                static_cast<unsigned>(B)),
           kThreads, smem, st>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const int32_t*>(kv_len),
      static_cast<float*>(part_m), static_cast<float*>(part_l),
      static_cast<float*>(part_acc), S, static_cast<int>(H),
      static_cast<int>(K), static_cast<int>(hd), static_cast<int>(n_split), scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned combine_threads = static_cast<unsigned>((hd + 31) / 32 * 32);
  combine_kernel<<<static_cast<unsigned>(B * H), combine_threads, 0, st>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<float*>(out),
      static_cast<int>(H), static_cast<int>(K), static_cast<int>(hd),
      static_cast<int>(n_split));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory one split_kernel block needs, in bytes.
int flash_decode_smem_bytes(int64_t G, int64_t hd) {
  return static_cast<int>(smem_floats(G, hd) * sizeof(float));
}

#define FLASH_DECODE_ENTRY(NAME, TQ, TKV)                                      \
  int NAME(const void* q, const void* k, const void* v, const void* kv_len,     \
           void* out, void* part_m, void* part_l, void* part_acc, int64_t B,    \
           int64_t S, int64_t H, int64_t K, int64_t hd, int64_t n_split,        \
           float scale, void* stream) {                                         \
    return launch<TQ, TKV>(q, k, v, kv_len, out, part_m, part_l, part_acc, B,   \
                           S, H, K, hd, n_split, scale, stream);                \
  }

FLASH_DECODE_ENTRY(flash_decode_f32_f32, float, float)
FLASH_DECODE_ENTRY(flash_decode_f32_bf16, float, __nv_bfloat16)
FLASH_DECODE_ENTRY(flash_decode_bf16_f32, __nv_bfloat16, float)
FLASH_DECODE_ENTRY(flash_decode_bf16_bf16, __nv_bfloat16, __nv_bfloat16)

#undef FLASH_DECODE_ENTRY

}  // extern "C"
