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
// (34.4 GFLOP, 35 us) and moves 101.7 MB (30 us). A tensor-core kernel
// would be bound by its operations. These first kernels keep the TPU
// kernels' f32 arithmetic on the CUDA cores, with every operand staged
// in shared memory as f32, so they are bound by shared-memory reads and
// f32 FMAs, like K2: `mma`/`wgmma` on bf16 tiles, TMA loads and a
// pipelined tile ring are the way to the bound.
//
// Design. The TPU kernels carry an accumulator in VMEM scratch across a
// sequential innermost grid axis; here a CTA loops over that axis itself
// and keeps its accumulators in registers (f32):
// - K4: one CTA per (batch*head, 64-row query tile). q and dO rows stay
//   in shared memory; the CTA walks the key tiles up to the causal
//   diagonal, staging K and V.
// - K5: one CTA per (batch*head, 64-key tile). K and V rows stay in
//   shared memory; the CTA walks the query tiles from the first live one
//   (the diagonal) to the last, staging q, dO, lse and delta.
// Two kernels and no atomics, as in the JAX package: every gradient
// element is summed by one thread in a fixed order, so gradients are the
// same from run to run. FlashAttention-2 fuses both into one kernel that
// adds dQ with atomics; that saves recomputing p once, but the sum's
// order then changes between runs.
// Threads form a 16 x 16 grid, as in K2: thread (ty, tx) owns rows
// 4ty..4ty+3 of the accumulators and columns tx + 16c, and computes the
// score tile's entries (4ty + r, tx + 16j). The ds (and p) tile passes
// through shared memory to the second product. Rows of shared tiles are
// padded to D + 1 floats, so column reads are free of bank conflicts.
// q, k, v and dO are read through their [B, T, H, D] strides; lse and
// delta are f32 [B, H, T]; dQ, dK and dV are written contiguous
// [B, T, H, D]. Rows and keys past T are masked (p = 0 for a query row
// past T), never padded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;        // query rows and keys per tile
constexpr int kThreads = 256;    // 16 x 16
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* x, int64_t st,
                                          int t0, int seq) {
  constexpr int LD = D + 1;
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    const int t = t0 + r;
    dst[r * LD + c] = t < seq ? to_f32(x[t * st + c]) : 0.f;
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(Inputs in, T* __restrict__ dq, int heads, int seq, float scale,
             int causal) {
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
  const T* qb = static_cast<const T*>(in.q) + b * in.sq.b + h * in.sq.h;
  const T* kb = static_cast<const T*>(in.k) + b * in.sk.b + h * in.sk.h;
  const T* vb = static_cast<const T*>(in.v) + b * in.sv.b + h * in.sv.h;
  const T* db = static_cast<const T*>(in.dout) + b * in.sd.b + h * in.sd.h;
  const int64_t row_base = (static_cast<int64_t>(b) * heads + h) * seq;

  load_tile<T, D>(qs, qb, in.sq.t, q0, seq);
  load_tile<T, D>(dos, db, in.sd.t, q0, seq);
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
    load_tile<T, D>(ks, kb, in.sk.t, k0, seq);
    load_tile<T, D>(vs, vb, in.sv.t, k0, seq);
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
    T* o = dq + ((static_cast<int64_t>(b) * seq + row) * heads + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[tx + 16 * c] = from_f32<T>(acc[r][c]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv(Inputs in, T* __restrict__ dk, T* __restrict__ dv, int heads,
              int seq, float scale, int causal) {
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
  const T* qb = static_cast<const T*>(in.q) + b * in.sq.b + h * in.sq.h;
  const T* kb = static_cast<const T*>(in.k) + b * in.sk.b + h * in.sk.h;
  const T* vb = static_cast<const T*>(in.v) + b * in.sv.b + h * in.sv.h;
  const T* db = static_cast<const T*>(in.dout) + b * in.sd.b + h * in.sd.h;
  const int64_t row_base = (static_cast<int64_t>(b) * heads + h) * seq;

  load_tile<T, D>(ks, kb, in.sk.t, k0, seq);
  load_tile<T, D>(vs, vb, in.sv.t, k0, seq);
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
    load_tile<T, D>(qs, qb, in.sq.t, q0, seq);
    load_tile<T, D>(dos, db, in.sd.t, q0, seq);
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
      dk[off + tx + 16 * c] = from_f32<T>(dk_acc[r][c]);
      dv[off + tx + 16 * c] = from_f32<T>(dv_acc[r][c]);
    }
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
  constexpr size_t smem = dq_smem_bytes<D>();
  static bool attr_set = false;   // once per instantiation
  if (int err = allow_smem(flash_bwd_dq<T, D>, smem, &attr_set)) return err;
  const dim3 grid(batch * heads, (seq + kTile - 1) / kTile);
  flash_bwd_dq<T, D><<<grid, kThreads, smem, stream>>>(
      in, static_cast<T*>(dq), heads, seq, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const Inputs& in, void* dk, void* dv, int batch, int seq,
               int heads, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  static bool attr_set = false;
  if (int err = allow_smem(flash_bwd_dkv<T, D>, smem, &attr_set)) return err;
  const dim3 grid(batch * heads, (seq + kTile - 1) / kTile);
  flash_bwd_dkv<T, D><<<grid, kThreads, smem, stream>>>(
      in, static_cast<T*>(dk), static_cast<T*>(dv), heads, seq, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

// the variants the training path uses, K2's set: f32 and bf16, D 32 or 64
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
