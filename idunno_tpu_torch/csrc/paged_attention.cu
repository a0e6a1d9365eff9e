// Decode attention over KV pages addressed through a block table, for
// Hopper (sm_90a): K3.
//
// Replaces the TPU kernel `idunno_tpu/ops/paged_attention.py:_paged_kernel`
// (driven by `_paged_pallas`). Query rows q5 [B, T, KVH, G, D] (f32) attend
// the keys of their row's chain: block j of row b is the physical page
// tables[b, j] of the store [N, bs, KVH, D], live iff j*bs < lengths[b].
// Scores are q.k in f32 times 1/sqrt(D); the softmax runs online over the
// live blocks; the result is the normalized f32 output and the f32 lse.
// A row with no live block writes exactly out = 0 and lse = -1e30, so
// `merge_attention` gives it weight exactly 0. The int8 variant multiplies
// each token's f32 scale (pages [N, bs, KVH]) into the int8 -> f32 cast,
// so no dequantized copy of the pool exists in device memory.
//
// What bounds it: bytes. At the served decode shape (16 rows, 16 kv-heads,
// bs 16, chains of up to 3 blocks) the live pages are a few MB and the
// arithmetic is two D-long dot products per key; the launch itself costs
// more than the reads.
//
// Design: one CTA per (row b, kv-head, tile of 16 query rows), 128 threads
// as 4 warps of 4 rows each. The CTA walks its chain j < C, skips dead
// blocks, reads the live page straight from the store (never a gather)
// in chunks of 32 tokens into shared memory as f32, and keeps each row's
// running max, sum and output in the registers of one warp: lane k scores
// token k of the chunk, the max and sum are warp reductions, and lane c
// accumulates output columns c, c + 32, ... Keys at or past lengths[b]
// are never read. A table entry outside [0, N) makes the row's output NaN
// (loud) instead of reading out of bounds.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRowTile = kWarps * kRowsPerWarp;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 32;       // tokens staged in shared memory at once
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename P, bool kQuant, int D>
__global__ void __launch_bounds__(kThreads)
paged_fwd(const float* __restrict__ q5, const P* __restrict__ k_pages,
          const P* __restrict__ v_pages, const float* __restrict__ k_scale,
          const float* __restrict__ v_scale, const int* __restrict__ tables,
          const int* __restrict__ lengths, float* __restrict__ out,
          float* __restrict__ lse, int seq, int kv_heads, int group,
          int num_pages, int block_size, int chain, float scale) {
  constexpr int kCols = (D + 31) / 32;
  __shared__ float qs[kRowTile][D];
  __shared__ float ks[kChunk][D + 1];
  __shared__ float vs[kChunk][D + 1];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int r0 = blockIdx.x * kRowTile;
  const int rows = seq * group;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // row r of this (b, h) is q5[b, r / G, h, r % G, :]
  auto row_offset = [&](int r) -> int64_t {
    const int t = r / group;
    const int g = r - t * group;
    return ((static_cast<int64_t>(b) * seq + t) * kv_heads + h) * group + g;
  };
  for (int i = tid; i < kRowTile * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    qs[r][c] = r0 + r < rows ? q5[row_offset(r0 + r) * D + c] : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[rr][c] = 0.f;
  }

  const int len = lengths[b];
  bool bad = false;
  for (int j = 0; j < chain; ++j) {
    const int first = j * block_size;
    if (first >= len) continue;   // dead block: uniform over the CTA
    const int page = tables[static_cast<int64_t>(b) * chain + j];
    if (page < 0 || page >= num_pages) {
      bad = true;
      continue;
    }
    const int live = min(block_size, len - first);
    for (int c0 = 0; c0 < live; c0 += kChunk) {
      const int n = min(kChunk, live - c0);
      __syncthreads();   // the previous chunk's reads are done
      for (int i = tid; i < n * D; i += kThreads) {
        const int kk = i / D;
        const int c = i - kk * D;
        const int64_t tok =
            (static_cast<int64_t>(page) * block_size + c0 + kk) * kv_heads + h;
        float kf = to_f32(k_pages[tok * D + c]);
        float vf = to_f32(v_pages[tok * D + c]);
        if (kQuant) {
          kf = kf * k_scale[tok];
          vf = vf * v_scale[tok];
        }
        ks[kk][c] = kf;
        vs[kk][c] = vf;
      }
      __syncthreads();
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const int r = warp * kRowsPerWarp + rr;
        if (r0 + r >= rows) continue;   // uniform over the warp
        float s = -INFINITY;
        if (lane < n) {
          float dot = 0.f;
#pragma unroll 8
          for (int d = 0; d < D; ++d) dot = fmaf(qs[r][d], ks[lane][d], dot);
          s = dot * scale;
        }
        float mx = s;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[rr], mx);
        const float alpha = expf(m[rr] - m_new);
        const float p = lane < n ? expf(s - m_new) : 0.f;
        float ps = p;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          ps += __shfl_xor_sync(0xffffffffu, ps, off);
        l[rr] = l[rr] * alpha + ps;
        m[rr] = m_new;
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[rr][c] *= alpha;
        for (int kk = 0; kk < n; ++kk) {
          const float pk = __shfl_sync(0xffffffffu, p, kk);
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const int col = lane + 32 * c;
            if (col < D) acc[rr][c] = fmaf(pk, vs[kk][col], acc[rr][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    if (r0 + r >= rows) continue;
    const int64_t o = row_offset(r0 + r);
    const float l_safe = l[rr] == 0.f ? 1.f : l[rr];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) out[o * D + col] = bad ? NAN : acc[rr][c] / l_safe;
    }
    if (lane == 0) lse[o] = bad ? NAN : m[rr] + logf(l_safe);
  }
}

template <typename P, bool kQuant, int D>
int launch(const void* q5, const void* kp, const void* vp, const void* ksc,
           const void* vsc, const void* tables, const void* lengths,
           void* out, void* lse, int batch, int seq, int kv_heads, int group,
           int num_pages, int block_size, int chain, float scale,
           cudaStream_t stream) {
  const dim3 grid((seq * group + kRowTile - 1) / kRowTile, kv_heads, batch);
  paged_fwd<P, kQuant, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q5), static_cast<const P*>(kp),
      static_cast<const P*>(vp), static_cast<const float*>(ksc),
      static_cast<const float*>(vsc), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<float*>(out),
      static_cast<float*>(lse), seq, kv_heads, group, num_pages, block_size,
      chain, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename P, bool kQuant>
int dispatch_dim(int head_dim, const void* q5, const void* kp, const void* vp,
                 const void* ksc, const void* vsc, const void* tables,
                 const void* lengths, void* out, void* lse, int batch,
                 int seq, int kv_heads, int group, int num_pages,
                 int block_size, int chain, float scale, cudaStream_t s) {
#define IDUNNO_PAGED_CASE(DIM)                                               \
  case DIM:                                                                  \
    return launch<P, kQuant, DIM>(q5, kp, vp, ksc, vsc, tables, lengths, out, \
                                  lse, batch, seq, kv_heads, group,          \
                                  num_pages, block_size, chain, scale, s);
  switch (head_dim) {
    IDUNNO_PAGED_CASE(64)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef IDUNNO_PAGED_CASE
}

}  // namespace

// q5: contiguous f32 [batch, seq, kv_heads, group, head_dim]; k_pages,
// v_pages: contiguous [num_pages, block_size, kv_heads, head_dim] of
// page_dtype (0 = f32, 1 = bf16, 3 = int8, which also takes the
// contiguous f32 scale pages [num_pages, block_size, kv_heads]; pass null
// scales otherwise); tables: contiguous int32 [batch, chain]; lengths:
// int32 [batch]. out: contiguous f32 like q5; lse: contiguous f32
// [batch, seq, kv_heads, group]. head_dim is 64.
// Launches on `stream` and returns the launch's cudaError_t (0 = success);
// it neither synchronizes nor allocates.
extern "C" int idunno_paged_attention_fwd(
    const void* q5, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* lengths, void* out, void* lse, int batch, int seq,
    int kv_heads, int group, int head_dim, int num_pages, int block_size,
    int chain, int page_dtype, float scale, void* stream) {
  if (batch < 0 || seq < 0 || kv_heads <= 0 || group <= 0 || chain < 0 ||
      block_size <= 0 || num_pages < 0 || batch > 65535 || kv_heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || seq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (page_dtype) {
    case 0:
      return dispatch_dim<float, false>(head_dim, q5, k_pages, v_pages, nullptr,
                                        nullptr, tables, lengths, out, lse,
                                        batch, seq, kv_heads, group, num_pages,
                                        block_size, chain, scale, s);
    case 1:
      return dispatch_dim<__nv_bfloat16, false>(
          head_dim, q5, k_pages, v_pages, nullptr, nullptr, tables, lengths,
          out, lse, batch, seq, kv_heads, group, num_pages, block_size, chain,
          scale, s);
    case 3:
      if (k_scale == nullptr || v_scale == nullptr) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      return dispatch_dim<int8_t, true>(head_dim, q5, k_pages, v_pages,
                                        k_scale, v_scale, tables, lengths,
                                        out, lse, batch, seq, kv_heads, group,
                                        num_pages, block_size, chain, scale,
                                        s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
