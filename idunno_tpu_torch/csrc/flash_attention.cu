// Blockwise online-softmax attention forward for Hopper (sm_90a): K2.
//
// Replaces the TPU kernel `idunno_tpu/ops/flash_attention.py:_flash_kernel`
// (driven by `_flash_core`). Same contract: scores are q.k times
// 1/sqrt(D); in the causal case key tiles wholly above the diagonal are
// skipped and the in-tile triangle is masked at -1e30; keys at or beyond T
// are masked at -1e30; a row whose running sum is 0 divides by 1; the
// output is in q's dtype and lse = m + log(l) (natural log) is f32.
//
// What bounds it: at the LM prefill shape (bf16 q/k/v [4, 1024, 16, 64],
// causal) the least bytes are q, k, v and out, 33.6 MB (10.0 us at
// 3.35 TB/s), and the work is 8.6 GFLOP (8.7 us at the 989 TFLOP/s bf16
// tensor-core rate): bound by bytes, with the two close.
//
// Two kernels, chosen by dtype:
//
// - bf16 (`flash_fwd_tc`, the serving and training path): the
//   FlashAttention-2 design on `mma.sync` (tensor_core.cuh). One CTA of
//   4 warps owns 64 query rows of one (batch, head), 16 rows a warp. Q is
//   copied once with `cp.async` and put by `ldmatrix` into A fragments that
//   stay in registers. 64-key tiles of K and V pass through a two-stage
//   `cp.async` ring in shared memory, so the next tile's copy overlaps this
//   tile's products. Shared rows are padded to D + 8 bf16, so the eight
//   row addresses of an `ldmatrix` fall in eight different 16-byte bank
//   groups. S = Q.K^T in f32 accumulators, times scale.log2(e) (the
//   softmax runs in base 2; lse is returned in natural log), masked at
//   -1e30 (the causal triangle only on the diagonal tile, keys >= T only
//   on the last). The running max and sum of a row live in registers; the
//   max is reduced over the quad that shares the row with shuffles 1 and
//   2, the sum is kept per thread and reduced once at the end. l sums the
//   f32 p; p is packed to bf16 straight from the C fragments into the A
//   fragments of O += P.V, with V read by `ldmatrix.trans`. The
//   difference from the f32 arithmetic is that rounding of p: a relative
//   error of at most 2^-9 per probability, which
//   `ops/flash_attention.py:tensor_core_bound` turns into a per-element
//   bound. Rows and keys past T are zero-filled by the copy (source size
//   0) and masked, never padded; rows of the causal grid run longest
//   first (reversed blockIdx.y).
// - f32 (`flash_fwd`): the TPU kernel's f32 arithmetic on the CUDA cores,
//   which the f32 card tests hold at 1e-5 (TF32 would not). One CTA per
//   (batch*head, 64-row query tile), 256 threads as a 16 x 16 grid, q
//   staged in shared memory as f32, 64-key tiles of K and V streamed
//   through shared memory. Thread (ty, tx) owns query rows 4ty..4ty+3,
//   key columns tx + 16j of the score tile and output columns tx + 16c;
//   the running max and sum of a row are reduced over the 16 threads of a
//   half-warp with shuffles, and the probabilities pass through shared
//   memory to the P.V product. Rows of shared tiles are padded to D + 1
//   floats so that the column reads of K are free of bank conflicts.
//
// Both read q/k/v straight from the [B, T, H, D] layout through the given
// strides (no transpose to [B*H, T, D], no padding of T). The bf16 kernel
// copies 16-byte chunks, so its inputs need 16-byte aligned rows: the
// wrapper checks that the data pointers are 16-byte aligned and the
// batch, token and head strides multiples of 8 elements.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr int kTile = 64;        // query rows and keys per tile
constexpr int kThreads = 256;    // 16 x 16 (f32 kernel)
constexpr int kTcThreads = 128;  // 4 warps of 16 query rows (bf16 kernel)
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {   // element strides of the batch, token and head axes
  int64_t b, t, h;
};

template <int D>
constexpr size_t smem_bytes() {
  // q, k, v tiles [64][D + 1] and the probabilities [64][65], all f32
  return sizeof(float) * (3 * kTile * (D + 1) + kTile * (kTile + 1));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ out,
          float* __restrict__ lse, int heads, int seq, Strides sq,
          Strides sk, Strides sv, float scale, int causal) {
  constexpr int LD = D + 1;
  constexpr int LP = kTile + 1;
  constexpr int kCols = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kTile * LD;
  float* vs = ks + kTile * LD;
  float* ps = vs + kTile * LD;

  const int bh = blockIdx.x;
  const int iq = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int q0 = iq * kTile;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  for (int i = tid; i < kTile * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    const int t = q0 + r;
    qs[r * LD + c] = t < seq ? qb[t * sq.t + c] : 0.f;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  const int n_tiles = (seq + kTile - 1) / kTile;
  // causal: tile jk is live iff its lowest key is at or below the highest
  // query row of this tile (`_live`); with equal tiles that is jk <= iq
  const int nk = causal ? min(iq + 1, n_tiles) : n_tiles;
  for (int jk = 0; jk < nk; ++jk) {
    const int k0 = jk * kTile;
    __syncthreads();   // the previous tile's reads of ks, vs, ps are done
    for (int i = tid; i < kTile * D; i += kThreads) {
      const int r = i / D;
      const int c = i - r * D;
      const int t = k0 + r;
      const bool ok = t < seq;
      ks[r * LD + c] = ok ? kb[t * sk.t + c] : 0.f;
      vs[r * LD + c] = ok ? vb[t * sv.t + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = qs[(ty * 4 + r) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[r][j] = fmaf(qv[r], kv[j], s[r][j]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + ty * 4 + r;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[r][j] * scale;
        if (causal && row < col) x = kNegInf;
        if (col >= seq) x = kNegInf;
        s[r][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[r][j] - m_new);
        ps[(ty * 4 + r) * LP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[r] = l[r] * alpha + rs;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float pv[4], vv[kCols];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = ps[(ty * 4 + r) * LP + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = vs[kk * LD + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(pv[r], vv[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty * 4 + r;
    if (row >= seq) continue;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    float* o = out + ((static_cast<int64_t>(b) * seq + row) * heads + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[tx + 16 * c] = acc[r][c] / l_safe;
    if (tx == 0) {
      lse[(static_cast<int64_t>(b) * heads + h) * seq + row] = m[r] + logf(l_safe);
    }
  }
}

using bf16 = __nv_bfloat16;

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ out,
             float* __restrict__ lse, int heads, int seq, Strides sq,
             Strides sk, Strides sv, float scale, int causal) {
  constexpr int LDS = D + 8;   // padded shared row, in bf16
  constexpr int KD = D / 16;   // 16-deep steps over the head dimension
  constexpr int ND = D / 8;    // 8-wide column blocks of O
  constexpr int NK = kTile / 8;  // 8-key column blocks of S
  constexpr int kTileElems = kTile * LDS;
  // q, then K and V in two stages each: 46,080 bytes at D = 64
  __shared__ __align__(16) unsigned char tiles[5 * kTileElems * sizeof(bf16)];
  bf16* qs = reinterpret_cast<bf16*>(tiles);
  bf16* ks = qs + kTileElems;          // [2][kTileElems]
  bf16* vs = ks + 2 * kTileElems;      // [2][kTileElems]

  const int bh = blockIdx.x;
  const int n_tiles = gridDim.y;
  // causal rows do iq + 1 key tiles: launch the longest first
  const int iq = causal ? n_tiles - 1 - blockIdx.y : blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int q0 = iq * kTile;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  // the two rows of this thread's C fragments
  const int row0 = q0 + warp * 16 + g;
  const int row1 = row0 + 8;

  // live key tiles: jk <= iq in the causal case (K2's `_live` rule)
  const int nk = causal ? iq + 1 : n_tiles;
  tc::copy_rows<D, kTile, kTcThreads>(qs, qb, sq.t, q0, seq);
  tc::cp_async_commit();
  tc::copy_rows<D, kTile, kTcThreads>(ks, kb, sk.t, 0, seq);
  tc::copy_rows<D, kTile, kTcThreads>(vs, vb, sv.t, 0, seq);
  tc::cp_async_commit();

  // this warp's 16 rows of Q, as A fragments for the whole loop
  uint32_t qa[KD][4];
  tc::cp_async_wait<1>();
  __syncthreads();
#pragma unroll
  for (int kd = 0; kd < KD; ++kd)
    tc::ldmatrix_x4(qa[kd], qs + (warp * 16 + (lane & 15)) * LDS + kd * 16
                                + (lane >> 4) * 8);
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // running max (base-2 units) and per-thread partial sums of rows 0, 1
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const float scale_log2 = scale * kLog2e;

  for (int jk = 0; jk < nk; ++jk) {
    const int stage = jk & 1;
    if (jk + 1 < nk) {   // the next tile's copy overlaps this tile's work
      const int next = (stage ^ 1) * kTileElems;
      tc::copy_rows<D, kTile, kTcThreads>(ks + next, kb, sk.t,
                                          (jk + 1) * kTile, seq);
      tc::copy_rows<D, kTile, kTcThreads>(vs + next, vb, sv.t,
                                          (jk + 1) * kTile, seq);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q.K^T: this warp's 16 rows by the tile's 64 keys
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    const bf16* kt = ks + stage * kTileElems;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
      for (int p = 0; p < NK / 2; ++p) {
        uint32_t bk[4];
        tc::ldmatrix_x4(bk, kt + (p * 16 + (lane & 7) + ((lane >> 4) << 3))
                                     * LDS + kd * 16 + ((lane >> 3) & 1) * 8);
        tc::mma_bf16(s[2 * p], qa[kd], bk[0], bk[1]);
        tc::mma_bf16(s[2 * p + 1], qa[kd], bk[2], bk[3]);
      }
    }

    const int k0 = jk * kTile;
    const bool diag = causal && jk == iq;
    const bool ragged = k0 + kTile > seq;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (diag || ragged) {
          const int col = k0 + n * 8 + 2 * t4 + (e & 1);
          const int row = e < 2 ? row0 : row1;
          if ((diag && col > row) || col >= seq) x = kNegInf;
        }
        s[n][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    // the four threads of a quad hold one row's 64 columns
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float alpha0 = exp2f(m0 - mx0);
    const float alpha1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;

    // p in f32 for l, packed to bf16 as the A fragments of P.V
    uint32_t pa[NK / 2][4];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      const float p0 = exp2f(s[n][0] - m0);
      const float p1 = exp2f(s[n][1] - m0);
      const float p2 = exp2f(s[n][2] - m1);
      const float p3 = exp2f(s[n][3] - m1);
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      pa[n >> 1][(n & 1) * 2] = tc::pack_bf16(p0, p1);
      pa[n >> 1][(n & 1) * 2 + 1] = tc::pack_bf16(p2, p3);
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }

    // O += P.V, V's [key][d] tile read transposed as the B operand
    const bf16* vt = vs + stage * kTileElems;
#pragma unroll
    for (int kk = 0; kk < NK / 2; ++kk) {
#pragma unroll
      for (int p = 0; p < ND / 2; ++p) {
        uint32_t bv[4];
        tc::ldmatrix_x4_trans(
            bv, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS
                    + p * 16 + (lane >> 4) * 8);
        tc::mma_bf16(acc[2 * p], pa[kk], bv[0], bv[1]);
        tc::mma_bf16(acc[2 * p + 1], pa[kk], bv[2], bv[3]);
      }
    }
    __syncthreads();   // every warp is done with this stage before its refill
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float ls0 = l0 == 0.f ? 1.f : l0;
  const float ls1 = l1 == 0.f ? 1.f : l1;
  const int64_t lse_base = (static_cast<int64_t>(b) * heads + h) * seq;
  if (row0 < seq) {
    bf16* o = out + ((static_cast<int64_t>(b) * seq + row0) * heads + h) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(o + n * 8 + 2 * t4) =
          tc::pack_bf16(acc[n][0] / ls0, acc[n][1] / ls0);
    if (t4 == 0) lse[lse_base + row0] = m0 * kLn2 + logf(ls0);
  }
  if (row1 < seq) {
    bf16* o = out + ((static_cast<int64_t>(b) * seq + row1) * heads + h) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(o + n * 8 + 2 * t4) =
          tc::pack_bf16(acc[n][2] / ls1, acc[n][3] / ls1);
    if (t4 == 0) lse[lse_base + row1] = m1 * kLn2 + logf(ls1);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int batch, int seq, int heads, Strides sq, Strides sk, Strides sv,
           float scale, int causal, cudaStream_t stream) {
  const dim3 grid(batch * heads, (seq + kTile - 1) / kTile);
  if constexpr (std::is_same_v<T, bf16>) {
    flash_fwd_tc<D><<<grid, kTcThreads, 0, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out),
        static_cast<float*>(lse), heads, seq, sq, sk, sv, scale, causal);
  } else {
    constexpr size_t smem = smem_bytes<D>();
    static bool attr_set = false;   // once per instantiation
    if (!attr_set) {
      cudaError_t err = cudaFuncSetAttribute(
          flash_fwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      attr_set = true;
    }
    flash_fwd<D><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out),
        static_cast<float*>(lse), heads, seq, sq, sk, sv, scale, causal);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dim(const void* q, const void* k, const void* v, void* out,
                 void* lse, int batch, int seq, int heads, int head_dim,
                 Strides sq, Strides sk, Strides sv, float scale, int causal,
                 cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, 32>(q, k, v, out, lse, batch, seq, heads, sq, sk, sv,
                           scale, causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, lse, batch, seq, heads, sq, sk, sv,
                           scale, causal, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v: [batch, seq, heads, head_dim] on the device, last axis
// contiguous, the other axes at the given element strides; dtype 0 = f32,
// 1 = bf16. out: contiguous [batch, seq, heads, head_dim] in the same
// dtype; lse: contiguous f32 [batch, heads, seq]. head_dim is 32 or 64.
// Launches on `stream` and returns the launch's cudaError_t
// (0 = success); it neither synchronizes nor allocates.
extern "C" int idunno_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int batch, int seq, int heads, int head_dim, int dtype, int64_t q_sb,
    int64_t q_st, int64_t q_sh, int64_t k_sb, int64_t k_st, int64_t k_sh,
    int64_t v_sb, int64_t v_st, int64_t v_sh, float scale, int causal,
    void* stream) {
  if (batch < 0 || seq < 0 || heads <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || seq == 0) return 0;
  if (seq > 65535 * kTile) return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{q_sb, q_st, q_sh}, sk{k_sb, k_st, k_sh}, sv{v_sb, v_st, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_dim<float>(q, k, v, out, lse, batch, seq, heads,
                                 head_dim, sq, sk, sv, scale, causal, s);
    case 1:
      return dispatch_dim<__nv_bfloat16>(q, k, v, out, lse, batch, seq, heads,
                                         head_dim, sq, sk, sv, scale, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
