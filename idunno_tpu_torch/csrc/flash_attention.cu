// Blockwise online-softmax attention forward for Hopper (sm_90a): K2.
//
// Replaces the TPU kernel `idunno_tpu/ops/flash_attention.py:_flash_kernel`
// (driven by `_flash_core`). Same numbers: scores are q.k in f32 times
// 1/sqrt(D); in the causal case key tiles wholly above the diagonal are
// skipped and the in-tile triangle is masked at -1e30; keys at or beyond T
// are masked at -1e30; a row whose running sum is 0 divides by 1; the
// output is in q's dtype and lse = m + log(l) is f32.
//
// What bounds it: at the LM prefill shape (bf16 q/k/v [4, 1024, 16, 64],
// causal) the least bytes are q, k, v and out, 33.6 MB (10.0 us at
// 3.35 TB/s), and the work is about 9 GFLOP (9 us at the 989 TFLOP/s bf16
// tensor-core rate), so a tensor-core kernel would be bound by bytes.
// This first kernel keeps the TPU kernel's f32 arithmetic on the CUDA
// cores instead (every operand cast to f32, f32 products and sums), so it
// is bound by its shared-memory reads and f32 FMAs; `wgmma` with bf16
// operands, TMA loads and a pipelined K/V ring are the way to the bound.
//
// Design: one CTA per (batch*head, 64-row query tile), 256 threads as a
// 16 x 16 grid. The CTA reads its rows of q straight from the [B, T, H, D]
// layout through the given strides (no transpose to [B*H, T, D], no
// padding of T: rows and keys past T are masked here), stages them in
// shared memory as f32, then streams 64-key tiles of K and V through
// shared memory. Thread (ty, tx) owns query rows 4ty..4ty+3, key columns
// tx + 16j of the score tile and output columns tx + 16c; the running max
// and sum of a row are reduced over the 16 threads of a half-warp with
// shuffles, and the probabilities pass through shared memory to the P.V
// product. Rows of shared tiles are padded to D + 1 floats so that the
// column reads of K are free of bank conflicts.
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

template <int D>
constexpr size_t smem_bytes() {
  // q, k, v tiles [64][D + 1] and the probabilities [64][65], all f32
  return sizeof(float) * (3 * kTile * (D + 1) + kTile * (kTile + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out,
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
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  for (int i = tid; i < kTile * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    const int t = q0 + r;
    qs[r * LD + c] = t < seq ? to_f32(qb[t * sq.t + c]) : 0.f;
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
      ks[r * LD + c] = ok ? to_f32(kb[t * sk.t + c]) : 0.f;
      vs[r * LD + c] = ok ? to_f32(vb[t * sv.t + c]) : 0.f;
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
    T* o = out + ((static_cast<int64_t>(b) * seq + row) * heads + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[tx + 16 * c] = from_f32<T>(acc[r][c] / l_safe);
    if (tx == 0) {
      lse[(static_cast<int64_t>(b) * heads + h) * seq + row] = m[r] + logf(l_safe);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int batch, int seq, int heads, Strides sq, Strides sk, Strides sv,
           float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool attr_set = false;   // once per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid(batch * heads, (seq + kTile - 1) / kTile);
  flash_fwd<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), heads, seq, sq, sk, sv, scale, causal);
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
