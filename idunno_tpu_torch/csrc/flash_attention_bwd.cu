// Flash-attention backward for Hopper (sm_90a): K4 (dQ) and K5 (dK, dV).
//
// Replace the TPU kernels `idunno_tpu/ops/flash_attention.py:
// _flash_bwd_dq_kernel` (K4) and `_flash_bwd_dkv_kernel` (K5), the
// backward half of the JAX package's `jax.custom_vjp` around the flash
// forward (K2, `flash_attention.cu`). Both recompute the probabilities
// from the forward's log-sum-exp instead of storing the [T, T] matrix:
//
//   s     = q.k * (1/sqrt(D)), masked keys at -1e30   (K2's arithmetic)
//   p     = exp(s - lse)
//   ds    = p * (dO.v - delta) * scale,   delta = rowsum(dO * O)
//   dQ    = sum_k ds . K                  (K4)
//   dK    = sum_q ds^T . Q,  dV = sum_q p^T . dO       (K5)
//
// delta is computed outside, in plain torch, as the JAX package leaves it
// to XLA. The scores are recomputed exactly as K2 computes them: an f32
// fmaf chain over d in order 0..D-1, then one multiply by the scale, the
// causal and key-past-T masks at -1e30, and expf (no fast math), so the
// f32 kernels agree with the plain backward to f32 rounding.
//
// What bounds them: at the training shape (bf16 q/k/v/dO [8, 1024, 16,
// 64], causal) K4 does three products over the T(T+1)/2 live (query, key)
// pairs of each of 128 heads (25.8 GFLOP, 26 us at the 989 TFLOP/s bf16
// tensor-core rate) and moves 84.9 MB (25 us at 3.35 TB/s); K5 does four
// (34.4 GFLOP, 35 us) and moves 101.7 MB (30 us). Both are bound by their
// operations.
//
// Design. The TPU kernels carry an accumulator in VMEM scratch across a
// sequential innermost grid axis; here a CTA loops over that axis itself
// and keeps its accumulators in registers (f32):
// - K4: one CTA per (batch*head, 64-row query tile). The CTA walks the key
//   tiles up to the causal diagonal, staging K and V.
// - K5: one CTA per (batch*head, 64-key tile). The CTA walks the query
//   tiles from the first live one (the diagonal) to the last, staging q,
//   dO, lse and delta.
// Two kernels and no atomics, as in the JAX package: every gradient
// element is summed by one thread in a fixed order, so gradients are the
// same from run to run. FlashAttention-2 fuses both into one kernel that
// adds dQ with atomics; that saves recomputing p once, but the sum's
// order then changes between runs.
//
// In f32 both keep the TPU kernels' f32 arithmetic on the CUDA cores, every
// operand staged in shared memory as f32: threads form a 16 x 16 grid, as
// in K2's f32 kernel; thread (ty, tx) owns rows 4ty..4ty+3 of the
// accumulators and columns tx + 16c, and computes the score tile's entries
// (4ty + r, tx + 16j). The ds (and p) tile passes through shared memory to
// the second product. Rows of shared tiles are padded to D + 1 floats, so
// column reads are free of bank conflicts.
//
// In bf16 (the training path) both run on the tensor cores with
// `mma.sync` m16n8k16 (tensor_core.cuh), and P and dS never touch shared
// memory. One CTA has 4 warps of 16 rows (K4: query rows, K5: keys); the
// warp's own rows are put by `ldmatrix` into A fragments once and stay in
// registers (K4: q and dO, with the rows' lse in base 2 and delta; K5: K
// and V). The other side's tiles pass through a two-stage `cp.async` ring
// (rows padded to D + 8 bf16 for conflict-free `ldmatrix`; rows past T
// zero-filled by a source size of 0), so the next tile's copy overlaps
// this tile's products. Per tile, in f32 accumulators:
// - K5 (`flash_bwd_dkv_tc`): S^T = K.q^T, P^T = exp(S^T.scale - lse) (in
//   base 2, masked at -1e30 as above), dP^T = V.dO^T, dS^T =
//   P^T.(dP^T - delta).scale; then P^T and dS^T are packed to bf16 straight
//   from their C fragments into the A fragments of dV += P^T.dO and
//   dK += dS^T.q, whose B operands q and dO are read by `ldmatrix.trans`.
//   dK and dV stay in registers (64 floats a thread at D = 64).
// - K4 (`flash_bwd_dq_tc`): S = q.K^T and dP = dO.V^T with B read from K
//   and V rows by plain `ldmatrix`, P = exp(S.scale - lse) and
//   dS = P.(dP - delta).scale as in K5; dS is packed to bf16 straight into
//   the A fragments of dQ += dS.K, whose B operand K is read by
//   `ldmatrix.trans`. dQ stays in registers (32 floats a thread at
//   D = 64) until one bf16 store. Causal query tiles run longest first
//   (reversed blockIdx.y, as K2), so the light tiles fill the tail.
// The rounding of dS (and in K5 P) to bf16, at most 2^-9 relative, is the
// only difference from the f32 arithmetic; `ops/flash_attention.py:
// tensor_core_bound` turns it into a per-element bound. Their inputs need
// 16-byte aligned rows, as K2's bf16 kernel.
//
// q, k, v and dO are read through their [B, T, H, D] strides; lse and
// delta are f32 [B, H, T]; dQ, dK and dV are written contiguous
// [B, T, H, D]. Rows and keys past T are masked (p = 0 for a query row
// past T), never padded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr int kTile = 64;        // query rows and keys per tile
constexpr int kThreads = 256;    // 16 x 16 (CUDA-core kernels)
constexpr int kTcThreads = 128;  // 4 warps of 16 rows (bf16 kernels)
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {   // element strides of the batch, token and head axes
  int64_t b, t, h;
};

struct Inputs {    // q, k, v, dO with their strides; lse and delta
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  Strides sq, sk, sv, sd;
};

// rows [t0, t0 + 64) of one head of x into a [64][D + 1] f32 tile; rows
// at or past `seq` are zero
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* x,
                                          int64_t st, int t0, int seq) {
  constexpr int LD = D + 1;
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    const int t = t0 + r;
    dst[r * LD + c] = t < seq ? x[t * st + c] : 0.f;
  }
}

// K2's score for one (query row, key): the masked, scaled product
__device__ __forceinline__ float masked_score(float dot, float scale, int row,
                                              int col, int seq, int causal) {
  float x = dot * scale;
  if (causal && row < col) x = kNegInf;
  if (col >= seq) x = kNegInf;
  return x;
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // q, dO, k, v tiles [64][D + 1] and ds [64][65], all f32
  return sizeof(float) * (4 * kTile * (D + 1) + kTile * (kTile + 1));
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // k, v, q, dO tiles [64][D + 1], p^T and ds^T [64][65], lse and delta
  return sizeof(float) * (4 * kTile * (D + 1) + 2 * kTile * (kTile + 1)
                          + 2 * kTile);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(Inputs in, float* __restrict__ dq, int heads, int seq,
             float scale, int causal) {
  constexpr int LD = D + 1;
  constexpr int LP = kTile + 1;
  constexpr int kCols = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTile * LD;
  float* ks = dos + kTile * LD;
  float* vs = ks + kTile * LD;
  float* dss = vs + kTile * LD;

  const int bh = blockIdx.x;
  const int iq = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int q0 = iq * kTile;
  const float* qb = static_cast<const float*>(in.q) + b * in.sq.b + h * in.sq.h;
  const float* kb = static_cast<const float*>(in.k) + b * in.sk.b + h * in.sk.h;
  const float* vb = static_cast<const float*>(in.v) + b * in.sv.b + h * in.sv.h;
  const float* db = static_cast<const float*>(in.dout) + b * in.sd.b + h * in.sd.h;
  const int64_t row_base = (static_cast<int64_t>(b) * heads + h) * seq;

  load_tile<D>(qs, qb, in.sq.t, q0, seq);
  load_tile<D>(dos, db, in.sd.t, q0, seq);
  float lse[4], delta[4], acc[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty * 4 + r;
    lse[r] = row < seq ? in.lse[row_base + row] : 0.f;
    delta[r] = row < seq ? in.delta[row_base + row] : 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  const int n_tiles = (seq + kTile - 1) / kTile;
  // causal: key tile jk is live iff jk <= iq (K2's `_live` rule)
  const int nk = causal ? min(iq + 1, n_tiles) : n_tiles;
  for (int jk = 0; jk < nk; ++jk) {
    const int k0 = jk * kTile;
    __syncthreads();   // the previous tile's reads of ks, vs, dss are done
    load_tile<D>(ks, kb, in.sk.t, k0, seq);
    load_tile<D>(vs, vb, in.sv.t, k0, seq);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = dp[r][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        qv[r] = qs[(ty * 4 + r) * LD + d];
        ov[r] = dos[(ty * 4 + r) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = ks[(tx + 16 * j) * LD + d];
        vv[j] = vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[r][j] = fmaf(qv[r], kv[j], s[r][j]);
          dp[r][j] = fmaf(ov[r], vv[j], dp[r][j]);
        }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + ty * 4 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const float x = masked_score(s[r][j], scale, row, col, seq, causal);
        const float p = row < seq ? expf(x - lse[r]) : 0.f;
        dss[(ty * 4 + r) * LP + tx + 16 * j] = p * (dp[r][j] - delta[r]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float dv[4], kv[kCols];
#pragma unroll
      for (int r = 0; r < 4; ++r) dv[r] = dss[(ty * 4 + r) * LP + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = ks[kk * LD + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(dv[r], kv[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty * 4 + r;
    if (row >= seq) continue;
    float* o = dq + ((static_cast<int64_t>(b) * seq + row) * heads + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[tx + 16 * c] = acc[r][c];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv(Inputs in, float* __restrict__ dk, float* __restrict__ dv,
              int heads, int seq, float scale, int causal) {
  constexpr int LD = D + 1;
  constexpr int LP = kTile + 1;
  constexpr int kCols = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile * LD;
  float* qs = vs + kTile * LD;
  float* dos = qs + kTile * LD;
  float* pts = dos + kTile * LD;      // p^T: [key][query row]
  float* dsts = pts + kTile * LP;     // ds^T
  float* lses = dsts + kTile * LP;
  float* deltas = lses + kTile;

  const int bh = blockIdx.x;
  const int jk = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int k0 = jk * kTile;
  const float* qb = static_cast<const float*>(in.q) + b * in.sq.b + h * in.sq.h;
  const float* kb = static_cast<const float*>(in.k) + b * in.sk.b + h * in.sk.h;
  const float* vb = static_cast<const float*>(in.v) + b * in.sv.b + h * in.sv.h;
  const float* db = static_cast<const float*>(in.dout) + b * in.sd.b + h * in.sd.h;
  const int64_t row_base = (static_cast<int64_t>(b) * heads + h) * seq;

  load_tile<D>(ks, kb, in.sk.t, k0, seq);
  load_tile<D>(vs, vb, in.sv.t, k0, seq);
  float dk_acc[4][kCols], dv_acc[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;

  const int n_tiles = (seq + kTile - 1) / kTile;
  // causal: query tile iq is live iff iq >= jk (K2's `_live` rule)
  for (int iq = causal ? jk : 0; iq < n_tiles; ++iq) {
    const int q0 = iq * kTile;
    __syncthreads();   // the previous tile's reads of qs, dos, pts are done
    load_tile<D>(qs, qb, in.sq.t, q0, seq);
    load_tile<D>(dos, db, in.sd.t, q0, seq);
    if (tid < kTile) {
      const int row = q0 + tid;
      lses[tid] = row < seq ? in.lse[row_base + row] : 0.f;
      deltas[tid] = row < seq ? in.delta[row_base + row] : 0.f;
    }
    __syncthreads();

    // s[r][j], dp[r][j]: key 4ty + r against query row tx + 16j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = dp[r][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        kv[r] = ks[(ty * 4 + r) * LD + d];
        vv[r] = vs[(ty * 4 + r) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = qs[(tx + 16 * j) * LD + d];
        ov[j] = dos[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[r][j] = fmaf(qv[j], kv[r], s[r][j]);
          dp[r][j] = fmaf(ov[j], vv[r], dp[r][j]);
        }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int col = k0 + ty * 4 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = tx + 16 * j;
        const int row = q0 + i;
        const float x = masked_score(s[r][j], scale, row, col, seq, causal);
        const float p = row < seq ? expf(x - lses[i]) : 0.f;
        pts[(ty * 4 + r) * LP + i] = p;
        dsts[(ty * 4 + r) * LP + i] = p * (dp[r][j] - deltas[i]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float pv[4], dsv[4], ov[kCols], qv[kCols];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pv[r] = pts[(ty * 4 + r) * LP + kk];
        dsv[r] = dsts[(ty * 4 + r) * LP + kk];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        ov[c] = dos[kk * LD + tx + 16 * c];
        qv[c] = qs[kk * LD + tx + 16 * c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          dv_acc[r][c] = fmaf(pv[r], ov[c], dv_acc[r][c]);
          dk_acc[r][c] = fmaf(dsv[r], qv[c], dk_acc[r][c]);
        }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = k0 + ty * 4 + r;
    if (key >= seq) continue;
    const int64_t off = ((static_cast<int64_t>(b) * seq + key) * heads + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      dk[off + tx + 16 * c] = dk_acc[r][c];
      dv[off + tx + 16 * c] = dv_acc[r][c];
    }
  }
}

using bf16 = __nv_bfloat16;

template <int D>
constexpr size_t dkv_tc_smem_bytes() {
  // k, v [64][D + 8] once; q, dO [64][D + 8] in two stages; lse and delta
  // [64] f32 in two stages
  return sizeof(bf16) * 6 * kTile * (D + 8) + sizeof(float) * 4 * kTile;
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dkv_tc(Inputs in, bf16* __restrict__ dk, bf16* __restrict__ dv,
                 int heads, int seq, float scale, int causal) {
  static_assert(kTcThreads == 2 * kTile, "one lse and one delta a thread");
  constexpr int LDS = D + 8;     // padded shared row, in bf16
  constexpr int KD = D / 16;     // 16-deep steps over the head dimension
  constexpr int ND = D / 8;      // 8-wide column blocks of dK and dV
  constexpr int NQ = kTile / 8;  // 8-query column blocks of S^T
  constexpr int kTileElems = kTile * LDS;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* ks = reinterpret_cast<bf16*>(tc_smem);
  bf16* vs = ks + kTileElems;
  bf16* qs = vs + kTileElems;          // [2][kTileElems]
  bf16* dos = qs + 2 * kTileElems;     // [2][kTileElems]
  float* lses = reinterpret_cast<float*>(dos + 2 * kTileElems);  // [2][64]
  float* deltas = lses + 2 * kTile;                              // [2][64]

  const int bh = blockIdx.x;
  const int jk = blockIdx.y;
  const int n_tiles = gridDim.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int k0 = jk * kTile;
  const bf16* qb = static_cast<const bf16*>(in.q) + b * in.sq.b + h * in.sq.h;
  const bf16* kb = static_cast<const bf16*>(in.k) + b * in.sk.b + h * in.sk.h;
  const bf16* vb = static_cast<const bf16*>(in.v) + b * in.sv.b + h * in.sv.h;
  const bf16* db = static_cast<const bf16*>(in.dout) + b * in.sd.b + h * in.sd.h;
  const int64_t row_base = (static_cast<int64_t>(b) * heads + h) * seq;
  // the two keys of this thread's C fragments
  const int key0 = k0 + warp * 16 + g;
  const int key1 = key0 + 8;

  // query tile iq into ring stage `stage`: q, dO, and its lse and delta
  auto copy_query_tile = [&](int stage, int iq) {
    const int q0 = iq * kTile;
    tc::copy_rows<D, kTile, kTcThreads>(qs + stage * kTileElems, qb, in.sq.t,
                                        q0, seq);
    tc::copy_rows<D, kTile, kTcThreads>(dos + stage * kTileElems, db,
                                        in.sd.t, q0, seq);
    const int i = threadIdx.x & (kTile - 1);
    const bool ok = q0 + i < seq;
    const bool is_lse = threadIdx.x < kTile;
    const float* src = is_lse ? in.lse : in.delta;
    float* dst = (is_lse ? lses : deltas) + stage * kTile + i;
    tc::cp_async4(dst, ok ? src + row_base + q0 + i : src, ok);
  };

  // causal: query tile iq is live iff iq >= jk (K2's `_live` rule)
  const int iq0 = causal ? jk : 0;
  const int n_q = n_tiles - iq0;
  tc::copy_rows<D, kTile, kTcThreads>(ks, kb, in.sk.t, k0, seq);
  tc::copy_rows<D, kTile, kTcThreads>(vs, vb, in.sv.t, k0, seq);
  tc::cp_async_commit();
  copy_query_tile(0, iq0);
  tc::cp_async_commit();

  // this warp's 16 keys of K and V, as A fragments for the whole loop
  uint32_t ka[KD][4], va[KD][4];
  tc::cp_async_wait<1>();
  __syncthreads();
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    const int off = (warp * 16 + (lane & 15)) * LDS + kd * 16 + (lane >> 4) * 8;
    tc::ldmatrix_x4(ka[kd], ks + off);
    tc::ldmatrix_x4(va[kd], vs + off);
  }
  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  const float scale_log2 = scale * kLog2e;

  for (int it = 0; it < n_q; ++it) {
    const int iq = iq0 + it;
    const int stage = it & 1;
    if (it + 1 < n_q) {   // the next tile's copy overlaps this tile's work
      copy_query_tile(stage ^ 1, iq + 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qt = qs + stage * kTileElems;
    const bf16* dot = dos + stage * kTileElems;
    const float* lt = lses + stage * kTile;
    const float* dt = deltas + stage * kTile;

    // S^T = K.q^T and dP^T = V.dO^T: this warp's 16 keys by 64 queries
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
      for (int p = 0; p < NQ / 2; ++p) {
        const int off = (p * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS
                        + kd * 16 + ((lane >> 3) & 1) * 8;
        uint32_t bq[4], bo[4];
        tc::ldmatrix_x4(bq, qt + off);
        tc::mma_bf16(s[2 * p], ka[kd], bq[0], bq[1]);
        tc::mma_bf16(s[2 * p + 1], ka[kd], bq[2], bq[3]);
        tc::ldmatrix_x4(bo, dot + off);
        tc::mma_bf16(dp[2 * p], va[kd], bo[0], bo[1]);
        tc::mma_bf16(dp[2 * p + 1], va[kd], bo[2], bo[3]);
      }
    }

    // P^T and dS^T in f32, packed to bf16 as A fragments
    const int q0 = iq * kTile;
    const bool diag = causal && iq == jk;
    const bool ragged = q0 + kTile > seq || k0 + kTile > seq;
    uint32_t pa[NQ / 2][4], dsa[NQ / 2][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int i = n * 8 + 2 * t4 + c;   // query within the tile
        const int row = q0 + i;
        const float lse_log2 = lt[i] * kLog2e;
        const float delta = dt[i];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 2 * r + c;
          const int key = r ? key1 : key0;
          float x = s[n][e] * scale_log2;
          if ((diag && key > row) || (ragged && key >= seq)) x = kNegInf;
          float p = exp2f(x - lse_log2);
          if (ragged && row >= seq) p = 0.f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - delta) * scale;
        }
      }
      pa[n >> 1][(n & 1) * 2] = tc::pack_bf16(s[n][0], s[n][1]);
      pa[n >> 1][(n & 1) * 2 + 1] = tc::pack_bf16(s[n][2], s[n][3]);
      dsa[n >> 1][(n & 1) * 2] = tc::pack_bf16(dp[n][0], dp[n][1]);
      dsa[n >> 1][(n & 1) * 2 + 1] = tc::pack_bf16(dp[n][2], dp[n][3]);
    }

    // dV += P^T.dO and dK += dS^T.q, dO and q read transposed
#pragma unroll
    for (int kk = 0; kk < NQ / 2; ++kk) {
#pragma unroll
      for (int p = 0; p < ND / 2; ++p) {
        const int off = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS
                        + p * 16 + (lane >> 4) * 8;
        uint32_t bo[4], bq[4];
        tc::ldmatrix_x4_trans(bo, dot + off);
        tc::mma_bf16(dv_acc[2 * p], pa[kk], bo[0], bo[1]);
        tc::mma_bf16(dv_acc[2 * p + 1], pa[kk], bo[2], bo[3]);
        tc::ldmatrix_x4_trans(bq, qt + off);
        tc::mma_bf16(dk_acc[2 * p], dsa[kk], bq[0], bq[1]);
        tc::mma_bf16(dk_acc[2 * p + 1], dsa[kk], bq[2], bq[3]);
      }
    }
    __syncthreads();   // every warp is done with this stage before its refill
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r ? key1 : key0;
    if (key >= seq) continue;
    const int64_t off = ((static_cast<int64_t>(b) * seq + key) * heads + h) * D
                        + 2 * t4;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + n * 8) =
          tc::pack_bf16(dk_acc[n][2 * r], dk_acc[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + n * 8) =
          tc::pack_bf16(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

template <int D>
constexpr size_t dq_tc_smem_bytes() {
  // q, dO [64][D + 8] once; K, V [64][D + 8] in two stages each
  return sizeof(bf16) * 6 * kTile * (D + 8);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dq_tc(Inputs in, bf16* __restrict__ dq, int heads, int seq,
                float scale, int causal) {
  constexpr int LDS = D + 8;     // padded shared row, in bf16
  constexpr int KD = D / 16;     // 16-deep steps over the head dimension
  constexpr int ND = D / 8;      // 8-wide column blocks of dQ
  constexpr int NK = kTile / 8;  // 8-key column blocks of S
  constexpr int kTileElems = kTile * LDS;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* dos = qs + kTileElems;
  bf16* ks = dos + kTileElems;         // [2][kTileElems]
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
  const bf16* qb = static_cast<const bf16*>(in.q) + b * in.sq.b + h * in.sq.h;
  const bf16* kb = static_cast<const bf16*>(in.k) + b * in.sk.b + h * in.sk.h;
  const bf16* vb = static_cast<const bf16*>(in.v) + b * in.sv.b + h * in.sv.h;
  const bf16* db = static_cast<const bf16*>(in.dout) + b * in.sd.b + h * in.sd.h;
  const int64_t row_base = (static_cast<int64_t>(b) * heads + h) * seq;
  // the two rows of this thread's C fragments, their lse (base 2) and delta
  const int row0 = q0 + warp * 16 + g;
  const int row1 = row0 + 8;
  const float lse0 = row0 < seq ? in.lse[row_base + row0] * kLog2e : 0.f;
  const float lse1 = row1 < seq ? in.lse[row_base + row1] * kLog2e : 0.f;
  const float delta0 = row0 < seq ? in.delta[row_base + row0] : 0.f;
  const float delta1 = row1 < seq ? in.delta[row_base + row1] : 0.f;

  // causal: key tile jk is live iff jk <= iq (K2's `_live` rule)
  const int nk = causal ? iq + 1 : n_tiles;
  tc::copy_rows<D, kTile, kTcThreads>(qs, qb, in.sq.t, q0, seq);
  tc::copy_rows<D, kTile, kTcThreads>(dos, db, in.sd.t, q0, seq);
  tc::cp_async_commit();
  tc::copy_rows<D, kTile, kTcThreads>(ks, kb, in.sk.t, 0, seq);
  tc::copy_rows<D, kTile, kTcThreads>(vs, vb, in.sv.t, 0, seq);
  tc::cp_async_commit();

  // this warp's 16 rows of q and dO, as A fragments for the whole loop
  uint32_t qa[KD][4], oa[KD][4];
  tc::cp_async_wait<1>();
  __syncthreads();
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    const int off = (warp * 16 + (lane & 15)) * LDS + kd * 16 + (lane >> 4) * 8;
    tc::ldmatrix_x4(qa[kd], qs + off);
    tc::ldmatrix_x4(oa[kd], dos + off);
  }
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float scale_log2 = scale * kLog2e;

  for (int jk = 0; jk < nk; ++jk) {
    const int stage = jk & 1;
    if (jk + 1 < nk) {   // the next tile's copy overlaps this tile's work
      const int next = (stage ^ 1) * kTileElems;
      tc::copy_rows<D, kTile, kTcThreads>(ks + next, kb, in.sk.t,
                                          (jk + 1) * kTile, seq);
      tc::copy_rows<D, kTile, kTcThreads>(vs + next, vb, in.sv.t,
                                          (jk + 1) * kTile, seq);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = ks + stage * kTileElems;
    const bf16* vt = vs + stage * kTileElems;

    // S = q.K^T and dP = dO.V^T: this warp's 16 rows by the tile's 64 keys
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
      for (int p = 0; p < NK / 2; ++p) {
        const int off = (p * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS
                        + kd * 16 + ((lane >> 3) & 1) * 8;
        uint32_t bk[4], bv[4];
        tc::ldmatrix_x4(bk, kt + off);
        tc::mma_bf16(s[2 * p], qa[kd], bk[0], bk[1]);
        tc::mma_bf16(s[2 * p + 1], qa[kd], bk[2], bk[3]);
        tc::ldmatrix_x4(bv, vt + off);
        tc::mma_bf16(dp[2 * p], oa[kd], bv[0], bv[1]);
        tc::mma_bf16(dp[2 * p + 1], oa[kd], bv[2], bv[3]);
      }
    }

    // P and dS in f32, dS packed to bf16 as A fragments
    const int k0 = jk * kTile;
    const bool diag = causal && jk == iq;
    const bool ragged = q0 + kTile > seq || k0 + kTile > seq;
    uint32_t dsa[NK / 2][4];
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * t4 + (e & 1);
        const int row = e < 2 ? row0 : row1;
        float x = s[n][e] * scale_log2;
        if ((diag && key > row) || (ragged && key >= seq)) x = kNegInf;
        float p = exp2f(x - (e < 2 ? lse0 : lse1));
        if (ragged && row >= seq) p = 0.f;
        s[n][e] = p * (dp[n][e] - (e < 2 ? delta0 : delta1)) * scale;
      }
      dsa[n >> 1][(n & 1) * 2] = tc::pack_bf16(s[n][0], s[n][1]);
      dsa[n >> 1][(n & 1) * 2 + 1] = tc::pack_bf16(s[n][2], s[n][3]);
    }

    // dQ += dS.K, K's [key][d] tile read transposed as the B operand
#pragma unroll
    for (int kk = 0; kk < NK / 2; ++kk) {
#pragma unroll
      for (int p = 0; p < ND / 2; ++p) {
        uint32_t bk[4];
        tc::ldmatrix_x4_trans(
            bk, kt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS
                    + p * 16 + (lane >> 4) * 8);
        tc::mma_bf16(acc[2 * p], dsa[kk], bk[0], bk[1]);
        tc::mma_bf16(acc[2 * p + 1], dsa[kk], bk[2], bk[3]);
      }
    }
    __syncthreads();   // every warp is done with this stage before its refill
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
    if (row >= seq) continue;
    bf16* o = dq + ((static_cast<int64_t>(b) * seq + row) * heads + h) * D
              + 2 * t4;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(o + n * 8) =
          tc::pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem, bool* done) {
  if (*done) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  *done = true;
  return 0;
}

template <typename T, int D>
int launch_dq(const Inputs& in, void* dq, int batch, int seq, int heads,
              float scale, int causal, cudaStream_t stream) {
  const dim3 grid(batch * heads, (seq + kTile - 1) / kTile);
  static bool attr_set = false;   // once per instantiation
  if constexpr (std::is_same_v<T, bf16>) {
    constexpr size_t smem = dq_tc_smem_bytes<D>();
    if (int err = allow_smem(flash_bwd_dq_tc<D>, smem, &attr_set)) return err;
    flash_bwd_dq_tc<D><<<grid, kTcThreads, smem, stream>>>(
        in, static_cast<bf16*>(dq), heads, seq, scale, causal);
  } else {
    constexpr size_t smem = dq_smem_bytes<D>();
    if (int err = allow_smem(flash_bwd_dq<D>, smem, &attr_set)) return err;
    flash_bwd_dq<D><<<grid, kThreads, smem, stream>>>(
        in, static_cast<float*>(dq), heads, seq, scale, causal);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const Inputs& in, void* dk, void* dv, int batch, int seq,
               int heads, float scale, int causal, cudaStream_t stream) {
  const dim3 grid(batch * heads, (seq + kTile - 1) / kTile);
  static bool attr_set = false;   // once per instantiation
  if constexpr (std::is_same_v<T, bf16>) {
    constexpr size_t smem = dkv_tc_smem_bytes<D>();
    if (int err = allow_smem(flash_bwd_dkv_tc<D>, smem, &attr_set)) return err;
    flash_bwd_dkv_tc<D><<<grid, kTcThreads, smem, stream>>>(
        in, static_cast<bf16*>(dk), static_cast<bf16*>(dv), heads, seq,
        scale, causal);
  } else {
    constexpr size_t smem = dkv_smem_bytes<D>();
    if (int err = allow_smem(flash_bwd_dkv<D>, smem, &attr_set)) return err;
    flash_bwd_dkv<D><<<grid, kThreads, smem, stream>>>(
        in, static_cast<float*>(dk), static_cast<float*>(dv), heads, seq,
        scale, causal);
  }
  return static_cast<int>(cudaGetLastError());
}

// the variants the training path uses, K2's set: f32 and bf16, D 32 or 64
// (bf16 on the tensor cores, f32 on the CUDA cores)
template <typename T>
int dispatch(bool want_dq, const Inputs& in, void* out0, void* out1,
             int batch, int seq, int heads, int head_dim, float scale,
             int causal, cudaStream_t s) {
  switch (head_dim) {
    case 32:
      return want_dq ? launch_dq<T, 32>(in, out0, batch, seq, heads, scale, causal, s)
                     : launch_dkv<T, 32>(in, out0, out1, batch, seq, heads, scale, causal, s);
    case 64:
      return want_dq ? launch_dq<T, 64>(in, out0, batch, seq, heads, scale, causal, s)
                     : launch_dkv<T, 64>(in, out0, out1, batch, seq, heads, scale, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int run(bool want_dq, const Inputs& in, void* out0, void* out1, int batch,
        int seq, int heads, int head_dim, int dtype, float scale, int causal,
        void* stream) {
  if (batch < 0 || seq < 0 || heads <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || seq == 0) return 0;
  if (seq > 65535 * kTile) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch<float>(want_dq, in, out0, out1, batch, seq, heads,
                             head_dim, scale, causal, s);
    case 1:
      return dispatch<__nv_bfloat16>(want_dq, in, out0, out1, batch, seq,
                                     heads, head_dim, scale, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v, dout: [batch, seq, heads, head_dim] on the device, last axis
// contiguous, the other axes at the given element strides; dtype 0 = f32,
// 1 = bf16. lse and delta: contiguous f32 [batch, heads, seq]. dq (K4), dk
// and dv (K5): contiguous [batch, seq, heads, head_dim] in the inputs'
// dtype. head_dim is 32 or 64. Each launches on `stream` and returns the
// launch's cudaError_t (0 = success); neither synchronizes nor allocates.
extern "C" int idunno_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int batch, int seq,
    int heads, int head_dim, int dtype, int64_t q_sb, int64_t q_st,
    int64_t q_sh, int64_t k_sb, int64_t k_st, int64_t k_sh, int64_t v_sb,
    int64_t v_st, int64_t v_sh, int64_t d_sb, int64_t d_st, int64_t d_sh,
    float scale, int causal, void* stream) {
  const Inputs in{q, k, v, dout, static_cast<const float*>(lse),
                  static_cast<const float*>(delta), {q_sb, q_st, q_sh},
                  {k_sb, k_st, k_sh}, {v_sb, v_st, v_sh}, {d_sb, d_st, d_sh}};
  return run(true, in, dq, nullptr, batch, seq, heads, head_dim, dtype,
             scale, causal, stream);
}

extern "C" int idunno_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int batch,
    int seq, int heads, int head_dim, int dtype, int64_t q_sb, int64_t q_st,
    int64_t q_sh, int64_t k_sb, int64_t k_st, int64_t k_sh, int64_t v_sb,
    int64_t v_st, int64_t v_sh, int64_t d_sb, int64_t d_st, int64_t d_sh,
    float scale, int causal, void* stream) {
  const Inputs in{q, k, v, dout, static_cast<const float*>(lse),
                  static_cast<const float*>(delta), {q_sb, q_st, q_sh},
                  {k_sb, k_st, k_sh}, {v_sb, v_st, v_sh}, {d_sb, d_st, d_sh}};
  return run(false, in, dk, dv, batch, seq, heads, head_dim, dtype, scale,
             causal, stream);
}
