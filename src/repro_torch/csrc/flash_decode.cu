// GQA flash-decode attention for Hopper: one query token per sequence
// against its KV cache, in one launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py
// (flash_decode, pallas_call at line 88, body _kernel at line 24).
//
//   out[b, h] = sum_s softmax_s(q[b, h] . k[b, s, h / G] * scale) v[b, s, h / G]
//
// with G = H / K query heads per KV head, scale = 1 / sqrt(hd), and every
// position s >= kv_len[b] scored -1e30 (the reference's mask value, not -inf).
//
// What bounds it on an H100. Each cached key and value up to kv_len is read
// once and takes part in 2G multiply-adds. At G <= 8 that is at most a few
// operations per byte, far below the ~295 per byte at which arithmetic, not
// the 3.35 TB/s of device memory, becomes the limit: the kernel is bound by
// bytes, and its design is about keeping bytes in flight with as few
// instructions per byte as the f32 arithmetic allows. At G = 48 (granite-34b,
// MQA) the f32 multiply-adds on the CUDA cores (67 TFLOP/s), not the bytes,
// set the bound. Arithmetic stays f32 on the CUDA cores: wgmma would not
// lift a byte bound at G <= 8, and a bf16 query would move the f32 results.
//
// Design, in order of what it buys:
// 1. A ring of kStages tiles in shared memory, filled by 16-byte
//    cp.async.cg copies (commit_group / wait_group<kStages - 2>): the loads
//    of the next kStages - 1 tiles are in flight while the block works on
//    the current one, with one barrier per tile. Tiles keep the cache's own
//    type: a bf16 stage is 16 KB (4096 elements of keys and as many of
//    values), so a 3-stage block needs 48 KB.
// 2. Warp-parallel dot products. A key's hd elements are split over
//    hd / E lanes (hd padded to 8 times a power of two), each lane holding E
//    elements from E / 8 16-byte shared-memory loads, so a warp scores
//    32 E / hd keys at once with log2(hd / E) shuffles per dot product.
//    E is 16 for a block of 2 or 3 query heads (smollm-135m's G = 3),
//    which halves the shuffles and the lanes repeating each expf, and 8
//    otherwise, so that q and the accumulator ([GT, E] each, GT <= 8) stay
//    in registers without spilling. Query heads are tiled kMaxHeads per
//    block: G = 48 takes six blocks per KV head, each reading its tiles
//    again, mostly from L2.
// 3. A private online softmax. Each lane group scores its 32 / E keys of a
//    tile together (independent dot products and shuffles in flight) and
//    keeps its own running max m, sum l and acc, rescaled once per tile with
//    no branch: the factor is exactly 1 while the max holds. After the walk
//    the groups merge by shuffles, the warps through shared memory, once.
// 4. One launch. A split writes its partial (m, l, acc), fences, and counts
//    itself on a per-(sequence, KV head, head tile) counter; the block that
//    arrives last merges the partials by log-sum-exp, writes out, and resets
//    the counter to 0, so the wrapper zeroes the counters only when it
//    creates them. A row walked by one split writes out directly, with no
//    partial and no counter.
// 5. Splits from the walked length. The host picks the split count from S,
//    B, K and the SM count (kv_len lies on the device). Each row's walked
//    length min(kv_len, S) is shared by as many of those splits as get
//    kMinSpan positions each, in spans of whole tiles: a row shorter than
//    2 kMinSpan is one split and needs no merge, since a merge costs about
//    as much as walking a few tiles. Splits past the walked prefix exit at
//    once, before the counter.
//
// Semantics. Only [0, kv_len) is read: a key past kv_len weighs
// exp(-1e30 - m) = 0 once any key is valid. A row with kv_len <= 0 has no
// valid key; the reference then returns the plain mean of v over all S, so
// that row walks all S with every score -1e30. kv_len > S behaves as S.
// Slots past a ragged tile's end score -inf and their copies are zero-filled.
// m starts at -1e30, so a group, warp or split that saw no position holds
// l = 0, acc = 0 and adds nothing to a merge, even when every m is -1e30.
// Arithmetic is f32 with expf (no fast math).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;         // tiles in the ring
constexpr int kMinSpan = 256;      // fewest positions a split walks
constexpr int kMaxHeads = 8;       // query heads per block
constexpr float kMasked = -1e30f;  // score of a position at or past kv_len

// hd rounded up to 8 times a power of two: the width lanes split a key into.
__host__ __device__ constexpr int padded_width(int hd) {
  int w = 16;
  while (w < hd) w *= 2;
  return w;
}

// Elements of a key each lane holds: 16 for a block of 2 or 3 query heads;
// 8 for 4 or more, so that q and acc ([GT, elems] each) stay in registers,
// and for a single head, where ptxas spills a few bytes at 16.
__host__ __device__ constexpr int lane_elems(int gt) {
  return gt == 2 || gt == 3 ? 16 : 8;
}

// Cache positions per tile: 32 x 32 / padded_width per warp, so each lane
// takes 32 / E keys of E elements (and as many values) per tile.
__host__ __device__ constexpr int tile_positions(int hd) {
  return kWarps * 32 * 32 / padded_width(hd);
}

// Dynamic shared memory of one block: the ring, reused for the warps' merge.
__host__ __device__ constexpr int64_t smem_bytes(int64_t gt, int64_t hd,
                                                 int64_t kv_bytes) {
  const int64_t ring = kStages * 2 * tile_positions(static_cast<int>(hd)) * hd * kv_bytes;
  const int64_t merge = kWarps * gt * (hd + 2) * 4;
  return ring > merge ? ring : merge;
}

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

// 16 bytes from global to shared memory; zeros when !full.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(full ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// grid (n_split, K * head tiles, B), kThreads threads. part holds
// [m | l | acc] of every (sequence, KV head, head tile, split, head);
// counters one int per (sequence, KV head, head tile), 0 between launches.
template <typename TQ, typename TKV, int GT>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                    const TKV* __restrict__ v, const int32_t* __restrict__ kv_len,
                    float* __restrict__ out, float* __restrict__ part,
                    int32_t* __restrict__ counters, int S, int H, int K,
                    int hd, int n_split, float scale) {
  constexpr int E = lane_elems(GT);     // elements of a key per lane
  constexpr int kSub = E / 8;           // 16-byte shared loads per key per lane
  constexpr int kKeys = 32 / E;         // keys a lane group scores per tile
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_arrival;
  const int G = H / K;
  const int n_head_tiles = (G + GT - 1) / GT;
  const int split = blockIdx.x;
  const int kvh = blockIdx.y / n_head_tiles;
  const int g0 = (blockIdx.y % n_head_tiles) * GT;
  const int n_heads = G - g0 < GT ? G - g0 : GT;
  const int64_t b = blockIdx.z;
  const int64_t row = static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lpk = padded_width(hd) / E, groups = 32 / lpk;  // lanes per key
  const int grp = lane / lpk, sub = lane & (lpk - 1), d0 = sub * E;
  const int tile = tile_positions(hd);

  // q heads g0 .. g0 + GT of this KV head, this lane's elements (zeros for
  // heads past G and elements past hd), loaded while kv_len is on its way.
  const int64_t h0 = static_cast<int64_t>(kvh) * G + g0;
  bool live[kSub];
#pragma unroll
  for (int u = 0; u < kSub; ++u) live[u] = d0 + 8 * u < hd;
  float qr[GT][E], acc[GT][E], m[GT], l[GT];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    const TQ* qg = q + (b * H + h0 + g) * hd + d0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      qr[g][e] = live[e / 8] && g < n_heads ? to_float(qg[e]) : 0.0f;
      acc[g][e] = 0.0f;
    }
    m[g] = kMasked;
    l[g] = 0.0f;
  }

  // This split's span [lo, hi) of the walked prefix, and how many splits
  // of the row have any work.
  const int len = kv_len[b];
  const int n_walk = len > 0 ? (len < S ? len : S) : S;
  int n_use = n_walk / kMinSpan < n_split ? n_walk / kMinSpan : n_split;
  n_use = n_use > 1 ? n_use : 1;          // splits of at least kMinSpan each
  int span = (n_walk + n_use - 1) / n_use;
  span = (span + tile - 1) / tile * tile;
  const int n_busy = (n_walk + span - 1) / span;
  const int lo = split * span;
  if (lo >= n_walk) return;
  const int hi = lo + span < n_walk ? lo + span : n_walk;

  // The ring: a stage holds a tile's keys [tile, hd], then its values. Each
  // thread copies the same (row, column) chunks of every tile.
  TKV* ring = reinterpret_cast<TKV*>(smem);
  constexpr int kChunk = 16 / static_cast<int>(sizeof(TKV));   // elements per copy
  constexpr int kCopies = 32 * 32 * kWarps / kChunk / kThreads;  // per thread, at most
  const int row_chunks = hd / kChunk;
  int copy[kCopies];                    // row << 8 | column, or -1
#pragma unroll
  for (int i = 0; i < kCopies; ++i) {
    const int c = tid + i * kThreads;
    copy[i] = c < tile * row_chunks ? (c / row_chunks) << 8 | (c % row_chunks) * kChunk : -1;
  }
  const int stage_elems = 2 * tile * hd;
  const int pos_stride = K * hd;
  const TKV* kb = k + (b * S * K + kvh) * hd;
  const TKV* vb = v + (b * S * K + kvh) * hd;
  const int n_tiles = (hi - lo + tile - 1) / tile;

  auto load_tile = [&](int t) {
    if (t < n_tiles) {
      TKV* st = ring + (t % kStages) * stage_elems;
      const int t0 = lo + t * tile;
      const TKV* kt = kb + static_cast<int64_t>(t0) * pos_stride;
      const TKV* vt = vb + static_cast<int64_t>(t0) * pos_stride;
#pragma unroll
      for (int i = 0; i < kCopies; ++i) {
        if (copy[i] >= 0) {
          const int r = copy[i] >> 8, d = copy[i] & 255;
          const bool in = r < hi - t0;
          const int off = in ? r * pos_stride + d : 0;
          cp_async16(st + r * hd + d, kt + off, in);
          cp_async16(st + (tile + r) * hd + d, vt + off, in);
        }
      }
    }
    cp_async_commit();  // an empty group keeps the wait count uniform
  };

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) load_tile(t);
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();   // this thread's copies of tile t landed
    __syncthreads();                // everyone's; and tile t - 1 is consumed
    load_tile(t + kStages - 1);     // into the stage tile t - 1 held
    const TKV* ks = ring + (t % kStages) * stage_elems;
    const TKV* vs = ks + tile * hd;
    const int t0 = lo + t * tile;

    // this group's kKeys keys of the tile together; a warp's groups read
    // adjacent rows
    float p[kKeys][GT];
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const int r = (j * kWarps + warp) * groups + grp;
      float kf[E];
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
        if (live[u]) {
          load8(ks + r * hd + d0 + 8 * u, kf + 8 * u);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) kf[8 * u + i] = 0.0f;
        }
      }
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        p[j][g] = 0.0f;
#pragma unroll
        for (int u = 0; u < kSub; ++u) {
          float part_dot = 0.0f;
#pragma unroll
          for (int i = 0; i < 8; ++i) part_dot = fmaf(qr[g][8 * u + i], kf[8 * u + i], part_dot);
          p[j][g] += part_dot;
        }
      }
    }
    for (int o = lpk >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int j = 0; j < kKeys; ++j)
#pragma unroll
        for (int g = 0; g < GT; ++g) p[j][g] += __shfl_xor_sync(0xffffffffu, p[j][g], o);
    }
    // online softmax over them, one rescale per tile; the factor is
    // expf(0) = 1 exactly when the max does not grow
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float m_new = m[g];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int pos = t0 + (j * kWarps + warp) * groups + grp;
        p[j][g] = pos < hi ? (pos < len ? p[j][g] * scale : kMasked) : -INFINITY;
        m_new = fmaxf(m_new, p[j][g]);
      }
      const float alpha = expf(m[g] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        p[j][g] = expf(p[j][g] - m_new);
        sum += p[j][g];
      }
      l[g] = l[g] * alpha + sum;
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const int r = (j * kWarps + warp) * groups + grp;
      float vf[E];
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
        if (live[u]) {
          load8(vs + r * hd + d0 + 8 * u, vf + 8 * u);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) vf[8 * u + i] = 0.0f;
        }
      }
#pragma unroll
      for (int g = 0; g < GT; ++g)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p[j][g], vf[e], acc[g][e]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                  // the ring is free for the merge

  // merge the warp's lane groups by shuffles
  for (int o = lpk; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float m_new = fmaxf(m[g], m_o);
      const float a = expf(m[g] - m_new), c = expf(m_o - m_new);
      l[g] = l[g] * a + l_o * c;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float acc_o = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
        acc[g][e] = acc[g][e] * a + acc_o * c;
      }
      m[g] = m_new;
    }
  }
  float* wm = reinterpret_cast<float*>(smem);   // [kWarps, GT]
  float* wl = wm + kWarps * GT;                 // [kWarps, GT]
  float* wacc = wl + kWarps * GT;               // [kWarps, GT, hd]
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (d0 == 0) {
        wm[warp * GT + g] = m[g];
        wl[warp * GT + g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (live[e / 8]) wacc[(warp * GT + g) * hd + d0 + e] = acc[g][e];
    }
  }
  __syncthreads();

  // merge the warps; write out, or this split's partial
  const int64_t n_part = static_cast<int64_t>(gridDim.z) * gridDim.y * n_split * GT;
  float* pm = part;
  float* pl = part + n_part;
  float* pacc = part + 2 * n_part;
  for (int i = tid; i < n_heads * hd; i += kThreads) {
    const int g = i / hd, d = i % hd;
    float m_max = -INFINITY;
    for (int w = 0; w < kWarps; ++w) m_max = fmaxf(m_max, wm[w * GT + g]);
    float l_sum = 0.0f, a_sum = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(wm[w * GT + g] - m_max);
      l_sum += wl[w * GT + g] * e;
      a_sum += wacc[(w * GT + g) * hd + d] * e;
    }
    if (n_busy == 1) {
      out[(b * H + h0 + g) * hd + d] = a_sum / l_sum;
    } else {
      const int64_t r = (row * n_split + split) * GT + g;
      if (d == 0) {
        pm[r] = m_max;
        pl[r] = l_sum;
      }
      pacc[r * hd + d] = a_sum;
    }
  }
  if (n_busy == 1) return;

  // the row's last busy split to arrive merges all of them
  __threadfence();
  __syncthreads();
  if (tid == 0) last_arrival = atomicAdd(counters + row, 1) == n_busy - 1;
  __syncthreads();
  if (!last_arrival) return;
  __threadfence();
  for (int i = tid; i < n_heads * hd; i += kThreads) {
    const int g = i / hd, d = i % hd;
    const int64_t first = row * n_split * GT + g;   // split 0, head g
    float m_max = -INFINITY;
    for (int s = 0; s < n_busy; ++s) m_max = fmaxf(m_max, __ldcg(pm + first + s * GT));
    float l_sum = 0.0f, a_sum = 0.0f;
    for (int s = 0; s < n_busy; ++s) {
      const int64_t r = first + s * GT;
      const float e = expf(__ldcg(pm + r) - m_max);
      l_sum += __ldcg(pl + r) * e;
      a_sum += __ldcg(pacc + r * hd + d) * e;
    }
    out[(b * H + h0 + g) * hd + d] = a_sum / l_sum;
  }
  if (tid == 0) counters[row] = 0;
}

template <typename TQ, typename TKV, int GT>
int launch(const void* q, const void* k, const void* v, const void* kv_len,
           void* out, void* part, void* counters, int64_t B, int64_t S,
           int64_t H, int64_t K, int64_t hd, int64_t n_split, float scale,
           cudaStream_t stream) {
  auto kernel = flash_decode_kernel<TQ, TKV, GT>;
  // Raise the kernel's shared-memory limit once per device, to the most
  // any hd takes (the ring at a power-of-two hd).
  static std::atomic<unsigned long long> opted{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(opted.load() & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes(kMaxHeads, 128, sizeof(TKV))));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted.fetch_or(bit);
  }
  const int n_head_tiles = static_cast<int>((H / K + GT - 1) / GT);
  const size_t smem = static_cast<size_t>(smem_bytes(GT, hd, sizeof(TKV)));
  kernel<<<dim3(static_cast<unsigned>(n_split),
                static_cast<unsigned>(K * n_head_tiles), static_cast<unsigned>(B)),
           kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const int32_t*>(kv_len),
      static_cast<float*>(out), static_cast<float*>(part),
      static_cast<int32_t*>(counters), static_cast<int>(S), static_cast<int>(H),
      static_cast<int>(K), static_cast<int>(hd), static_cast<int>(n_split), scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV>
int dispatch(const void* q, const void* k, const void* v, const void* kv_len,
             void* out, void* part, void* counters, int64_t B, int64_t S,
             int64_t H, int64_t K, int64_t hd, int64_t gt, int64_t n_split,
             float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_DECODE_GT(N)                                                     \
  case N:                                                                      \
    return launch<TQ, TKV, N>(q, k, v, kv_len, out, part, counters, B, S, H,   \
                              K, hd, n_split, scale, st);
  switch (gt) {
    FLASH_DECODE_GT(1) FLASH_DECODE_GT(2) FLASH_DECODE_GT(3) FLASH_DECODE_GT(4)
    FLASH_DECODE_GT(5) FLASH_DECODE_GT(6) FLASH_DECODE_GT(7) FLASH_DECODE_GT(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_DECODE_GT
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block for gt query heads per block, head dim
// hd and kv_bytes bytes per cache element.
int flash_decode_smem_bytes(int64_t gt, int64_t hd, int64_t kv_bytes) {
  return static_cast<int>(smem_bytes(gt, hd, kv_bytes));
}

// Cache positions per tile at head dim hd (a split's span is a multiple).
int flash_decode_tile_positions(int64_t hd) {
  return tile_positions(static_cast<int>(hd));
}

#define FLASH_DECODE_ENTRY(NAME, TQ, TKV)                                      \
  int NAME(const void* q, const void* k, const void* v, const void* kv_len,     \
           void* out, void* part, void* counters, int64_t B, int64_t S,         \
           int64_t H, int64_t K, int64_t hd, int64_t gt, int64_t n_split,       \
           float scale, void* stream) {                                         \
    return dispatch<TQ, TKV>(q, k, v, kv_len, out, part, counters, B, S, H, K,  \
                             hd, gt, n_split, scale, stream);                   \
  }

FLASH_DECODE_ENTRY(flash_decode_f32_f32, float, float)
FLASH_DECODE_ENTRY(flash_decode_f32_bf16, float, __nv_bfloat16)
FLASH_DECODE_ENTRY(flash_decode_bf16_f32, __nv_bfloat16, float)
FLASH_DECODE_ENTRY(flash_decode_bf16_bf16, __nv_bfloat16, __nv_bfloat16)

#undef FLASH_DECODE_ENTRY

}  // extern "C"
