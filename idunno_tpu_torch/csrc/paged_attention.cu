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
// What bounds it: latency. At the served decode shape (16 rows, 16
// kv-heads, one query row each, bs 16, chains of up to 3 blocks) the live
// pages are 2.95 MB (0.9 us at 3.35 TB/s) and the arithmetic is two D-long
// dot products per key; the launch and the dependent global-memory round
// trips (table entry, then page) cost more than the reads.
//
// Design: one CTA per (row b, kv-head, tile of 4 query rows), 4 warps.
// - The CTA reads its row of the table once, up front and beside the
//   row's length, into shared memory, and checks the live entries'
//   bounds, so every page read of the chain can be issued without waiting
//   on another table read. A table entry outside [0, N) makes the row's
//   output NaN (loud) instead of reading out of bounds.
// - The chain is split across the warps, the flash-decoding idea inside
//   one CTA: warp w takes blocks w, w + 4, w + 8, ... and keeps its own
//   running max, sum and output for each of the CTA's rows. A warp walks
//   its blocks in chunks of 16 tokens and loads the next chunk while it
//   computes this one. At the decode shape every block of a chain of up
//   to 4 has a warp of its own, so all its page reads are in flight
//   together.
// - Pages are read in 16-byte vectors straight into registers: a token
//   row of D elements spans D / V lanes (V = 4 f32, 8 bf16 or 16 int8
//   elements a vector), so a warp covers 2, 4 or 8 tokens a pass. Each
//   score is a per-lane partial product over the lane's V columns and a
//   shuffle reduction over the token's lanes; the block's max is a
//   shuffle reduction over the token groups. Each lane accumulates p.V
//   over its V columns and its own tokens; the rescaling factor of the
//   online softmax is the same in every lane, so the partial sums of the
//   token groups are added together once per warp, at the end.
// - The K/V chunk in registers is reused across the CTA's rows (T.G > 1:
//   the radix-hit suffix prefill, GQA groups).
// - The warps' partials merge through shared memory in warp order, so
//   results repeat to the bit from run to run. Keys at or past lengths[b]
//   are never read.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowTile = 4;      // query rows of one CTA
constexpr int kChunk = 16;       // tokens a warp holds in registers at once
constexpr float kNegInf = -1e30f;

// the V elements of one 16-byte vector as f32
template <typename P>
__device__ __forceinline__ void widen(const uint4& raw, float* out);

template <>
__device__ __forceinline__ void widen<float>(const uint4& raw, float* out) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}

template <>
__device__ __forceinline__ void widen<__nv_bfloat16>(const uint4& raw,
                                                     float* out) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // bf16 is the top half of an f32: exact
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <>
__device__ __forceinline__ void widen<int8_t>(const uint4& raw, float* out) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[4 * i + j] = static_cast<float>(
          static_cast<int8_t>((w[i] >> (8 * j)) & 0xffu));
}

template <typename P, int D>
struct Geometry {
  static constexpr int kVec = 16 / sizeof(P);           // elements a vector
  static constexpr int kLanesPerToken = D / kVec;
  static constexpr int kTokensPerPass = 32 / kLanesPerToken;
  static constexpr int kPasses = kChunk / kTokensPerPass;
  static_assert(D % kVec == 0 && 32 % kLanesPerToken == 0 &&
                    kChunk % kTokensPerPass == 0,
                "a token row must tile the warp in 16-byte vectors");
};

// one warp's share of one chunk: K and V vectors (and int8 scales) of its
// kPasses tokens, zero where the token is past the block's live end
template <typename P, int D>
struct Chunk {
  using G = Geometry<P, D>;
  static constexpr int kScales = std::is_same_v<P, int8_t> ? G::kPasses : 1;
  uint4 k[G::kPasses], v[G::kPasses];
  float ks[kScales], vs[kScales];
};

template <typename P, int D>
__global__ void __launch_bounds__(kThreads)
paged_fwd(const float* __restrict__ q5, const P* __restrict__ k_pages,
          const P* __restrict__ v_pages, const float* __restrict__ k_scale,
          const float* __restrict__ v_scale, const int* __restrict__ tables,
          const int* __restrict__ lengths, float* __restrict__ out,
          float* __restrict__ lse, int seq, int kv_heads, int group,
          int num_pages, int block_size, int chain, float scale) {
  using G = Geometry<P, D>;
  constexpr bool kQuant = std::is_same_v<P, int8_t>;  // with f32 scales
  constexpr int V = G::kVec;
  constexpr int LPT = G::kLanesPerToken;
  constexpr int TPP = G::kTokensPerPass;
  constexpr int NP = G::kPasses;
  extern __shared__ int pages[];                  // [chain]: the table row
  __shared__ __align__(16) float qs[kRowTile][D];
  __shared__ float part_acc[kWarps][kRowTile][D];
  __shared__ float part_m[kWarps][kRowTile], part_l[kWarps][kRowTile];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int r0 = blockIdx.x * kRowTile;
  const int nrows = min(kRowTile, seq * group - r0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int tg = lane / LPT;        // this lane's token within a pass
  const int col0 = (lane % LPT) * V;  // its first column

  // row r of this (b, h) is q5[b, r / G, h, r % G, :]
  auto row_offset = [&](int r) -> int64_t {
    const int t = r / group;
    const int g = r - t * group;
    return ((static_cast<int64_t>(b) * seq + t) * kv_heads + h) * group + g;
  };
  // the queries, the row's length and its whole table row are read in one
  // round trip (every global read issued before the first shared store);
  // the pages follow in a second
  constexpr int kQ = kRowTile * D / kThreads;   // query elements a thread
  static_assert(kRowTile * D % kThreads == 0, "queries tile the CTA");
  float qv0[kQ];
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const int r = (tid + i * kThreads) / D;
    const int c = (tid + i * kThreads) % D;
    qv0[i] = r < nrows ? q5[row_offset(r0 + r) * D + c] : 0.f;
  }
  const int len = lengths[b];
  for (int j = tid; j < chain; j += kThreads)
    pages[j] = tables[static_cast<int64_t>(b) * chain + j];
#pragma unroll
  for (int i = 0; i < kQ; ++i)
    qs[(tid + i * kThreads) / D][(tid + i * kThreads) % D] = qv0[i];
  const int nlive = len > 0 ? min(chain, (len + block_size - 1) / block_size)
                            : 0;
  bool bad = false;
  for (int j = tid; j < nlive; j += kThreads)   // the entries read above
    bad |= pages[j] < 0 || pages[j] >= num_pages;
  bad = __syncthreads_or(bad);   // also publishes qs and pages

  float m[kRowTile], l[kRowTile], acc[kRowTile][V];
#pragma unroll
  for (int rr = 0; rr < kRowTile; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int e = 0; e < V; ++e) acc[rr][e] = 0.f;
  }

  // live tokens of block j, and the 16-byte loads of one of its chunks
  auto live_of = [&](int j) { return min(block_size, len - j * block_size); };
  auto load = [&](Chunk<P, D>& c, int j, int c0) {
    const int n = live_of(j) - c0;
    const int64_t base = static_cast<int64_t>(pages[j]) * block_size + c0;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int t = p * TPP + tg;
      const bool ok = t < n;
      const int64_t tok = (base + t) * kv_heads + h;
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      c.k[p] = ok ? __ldg(reinterpret_cast<const uint4*>(
                        k_pages + tok * D + col0)) : zero;
      c.v[p] = ok ? __ldg(reinterpret_cast<const uint4*>(
                        v_pages + tok * D + col0)) : zero;
      if constexpr (kQuant) {
        c.ks[p] = ok ? __ldg(k_scale + tok) : 0.f;
        c.vs[p] = ok ? __ldg(v_scale + tok) : 0.f;
      }
    }
  };

  // this warp's units, in order: chunks c0 = 0, 16, ... of blocks
  // j = warp, warp + 4, ...; the next unit's loads are issued before this
  // one's arithmetic
  int j = warp, c0 = 0;
  bool have = !bad && j < nlive;
  Chunk<P, D> cur, nxt;
  if (have) load(cur, j, c0);
  while (have) {
    int nj = j, nc0 = c0 + kChunk;
    if (nc0 >= live_of(j)) {
      nj = j + kWarps;
      nc0 = 0;
    }
    const bool more = nj < nlive;
    if (more) load(nxt, nj, nc0);

    const int n = live_of(j) - c0;
    float kf[NP][V], vf[NP][V];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      widen<P>(cur.k[p], kf[p]);
      widen<P>(cur.v[p], vf[p]);
      if constexpr (kQuant) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          kf[p][e] *= cur.ks[p];
          vf[p][e] *= cur.vs[p];
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRowTile; ++rr) {
      if (rr >= nrows) break;   // uniform over the CTA
      float qv[V];
#pragma unroll
      for (int e = 0; e < V; e += 4) {
        const float4 x = *reinterpret_cast<const float4*>(&qs[rr][col0 + e]);
        qv[e] = x.x;
        qv[e + 1] = x.y;
        qv[e + 2] = x.z;
        qv[e + 3] = x.w;
      }
      float s[NP];
      float mx = -INFINITY;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < V; ++e) part = fmaf(qv[e], kf[p][e], part);
#pragma unroll
        for (int off = LPT / 2; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        s[p] = p * TPP + tg < n ? part * scale : -INFINITY;
        mx = fmaxf(mx, s[p]);
      }
#pragma unroll
      for (int off = LPT; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[rr], mx);
      const float alpha = expf(m[rr] - m_new);
      m[rr] = m_new;
      float ps = 0.f;
#pragma unroll
      for (int e = 0; e < V; ++e) acc[rr][e] *= alpha;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const float pk = p * TPP + tg < n ? expf(s[p] - m_new) : 0.f;
        ps += pk;
#pragma unroll
        for (int e = 0; e < V; ++e) acc[rr][e] = fmaf(pk, vf[p][e], acc[rr][e]);
      }
      l[rr] = l[rr] * alpha + ps;
    }
    cur = nxt;
    j = nj;
    c0 = nc0;
    have = more;
  }

  // this warp's partials: the token groups' sums added, then to shared
#pragma unroll
  for (int rr = 0; rr < kRowTile; ++rr) {
    if (rr >= nrows) break;
#pragma unroll
    for (int off = LPT; off < 32; off <<= 1) {
      l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], off);
#pragma unroll
      for (int e = 0; e < V; ++e)
        acc[rr][e] += __shfl_xor_sync(0xffffffffu, acc[rr][e], off);
    }
    if (tg == 0) {
#pragma unroll
      for (int e = 0; e < V; ++e) part_acc[warp][rr][col0 + e] = acc[rr][e];
    }
    if (lane == 0) {
      part_m[warp][rr] = m[rr];
      part_l[warp][rr] = l[rr];
    }
  }
  __syncthreads();

  // merge the warps' partials in warp order
  for (int i = tid; i < nrows * D; i += kThreads) {
    const int rr = i / D;
    const int c = i - rr * D;
    float mx = part_m[0][rr];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, part_m[w][rr]);
    float sum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wgt = expf(part_m[w][rr] - mx);
      sum = fmaf(part_l[w][rr], wgt, sum);
      o = fmaf(part_acc[w][rr][c], wgt, o);
    }
    const float l_safe = sum == 0.f ? 1.f : sum;
    const int64_t row = row_offset(r0 + rr);
    out[row * D + c] = bad ? NAN : o / l_safe;
    if (c == 0) lse[row] = bad ? NAN : mx + logf(l_safe);
  }
}

template <typename P, int D>
int launch(const void* q5, const void* kp, const void* vp, const void* ksc,
           const void* vsc, const void* tables, const void* lengths,
           void* out, void* lse, int batch, int seq, int kv_heads, int group,
           int num_pages, int block_size, int chain, float scale,
           cudaStream_t stream) {
  // the table row in dynamic shared memory, beside the static arrays
  const size_t smem = sizeof(int) * static_cast<size_t>(chain);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_fwd<P, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((seq * group + kRowTile - 1) / kRowTile, kv_heads, batch);
  paged_fwd<P, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q5), static_cast<const P*>(kp),
      static_cast<const P*>(vp), static_cast<const float*>(ksc),
      static_cast<const float*>(vsc), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<float*>(out),
      static_cast<float*>(lse), seq, kv_heads, group, num_pages, block_size,
      chain, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename P>
int dispatch_dim(int head_dim, const void* q5, const void* kp, const void* vp,
                 const void* ksc, const void* vsc, const void* tables,
                 const void* lengths, void* out, void* lse, int batch,
                 int seq, int kv_heads, int group, int num_pages,
                 int block_size, int chain, float scale, cudaStream_t s) {
#define IDUNNO_PAGED_CASE(DIM)                                               \
  case DIM:                                                                  \
    return launch<P, DIM>(q5, kp, vp, ksc, vsc, tables, lengths, out, lse,  \
                          batch, seq, kv_heads, group, num_pages,          \
                          block_size, chain, scale, s);
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
// scales otherwise), 16-byte aligned; tables: contiguous int32
// [batch, chain]; lengths: int32 [batch]. out: contiguous f32 like q5;
// lse: contiguous f32 [batch, seq, kv_heads, group]. head_dim is 64.
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
      return dispatch_dim<float>(head_dim, q5, k_pages, v_pages, nullptr,
                                 nullptr, tables, lengths, out, lse, batch,
                                 seq, kv_heads, group, num_pages, block_size,
                                 chain, scale, s);
    case 1:
      return dispatch_dim<__nv_bfloat16>(
          head_dim, q5, k_pages, v_pages, nullptr, nullptr, tables, lengths,
          out, lse, batch, seq, kv_heads, group, num_pages, block_size, chain,
          scale, s);
    case 3:
      if (k_scale == nullptr || v_scale == nullptr) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      return dispatch_dim<int8_t>(head_dim, q5, k_pages, v_pages, k_scale,
                                  v_scale, tables, lengths, out, lse, batch,
                                  seq, kv_heads, group, num_pages, block_size,
                                  chain, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
