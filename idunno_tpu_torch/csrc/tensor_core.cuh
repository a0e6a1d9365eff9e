// Hopper tensor-core building blocks shared by the bf16 attention kernels
// (K2 forward in `flash_attention.cu`, K5 dK/dV in
// `flash_attention_bwd.cu`): asynchronous 16-byte copies into shared
// memory, `ldmatrix` fragment loads and the bf16 `mma.sync` m16n8k16 with
// f32 accumulators, all as inline PTX for sm_90a.
//
// Fragment layouts of `mma.sync.aligned.m16n8k16.row.col` (PTX ISA), for
// lane = 4 g + t (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major), four b32 registers of two bf16 each:
//     a0 = A[g][2t..2t+1], a1 = A[g+8][2t..], a2 = A[g][2t+8..],
//     a3 = A[g+8][2t+8..]
//   B (16 x 8, k x n), two registers: b0 = B[2t..2t+1][g], b1 = B[2t+8..][g]
//   C (16 x 8, f32), four floats: c0, c1 = C[g][2t..2t+1],
//     c2, c3 = C[g+8][2t..2t+1]
// So the C fragments of two neighbouring 8-column blocks, packed to bf16
// pairs, are exactly the A fragment of one 16-deep step: the probabilities
// of one product become the left operand of the next without leaving the
// registers.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory without passing through registers.
// With `valid` false nothing is read and the 16 bytes are zero-filled
// (source size 0), which is how rows past the sequence end are masked
// rather than padded; `src` must still be a mapped address.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes (one f32), zero-filled when `valid` is false
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and register i receives matrix i's elements [g][2t..2t+1]
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the same, transposed: register i receives matrix i's [2t..2t+1][g]
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a . b on the tensor cores: bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [t0, t0 + ROWS) of one head of x (row stride `st` elements) into a
// [ROWS][D + 8] bf16 tile in shared memory, 16 bytes a copy spread over
// THREADS threads; rows at or past `seq` are zero-filled
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* x, int64_t st,
                                          int t0, int seq) {
  constexpr int kChunks = D / 8;   // 16-byte chunks a row
  for (int i = threadIdx.x; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks;
    const int c = (i - r * kChunks) * 8;
    const bool ok = t0 + r < seq;
    cp_async16(dst + r * (D + 8) + c, ok ? x + (t0 + r) * st + c : x, ok);
  }
}

// two floats rounded to nearest-even bf16, `lo` in the low half (the
// element with the smaller column index)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace tc
