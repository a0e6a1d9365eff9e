// Fused center-crop + uint8 -> normalized bfloat16 for Hopper (sm_90a).
//
// Replaces the TPU kernel `idunno_tpu/ops/pallas_preprocess.py:_norm_kernel`
// (launched from `preprocess_batch_pallas`), which normalizes an already
// cropped batch viewed as [B*crop, crop*3] u8 rows:
//     out = bf16((x * (1/255) - mean[c]) * inv_std[c]),  c = lane % 3.
// The TPU version leaves the crop to an XLA slice in front of the kernel;
// here the kernel reads the `crop` rows of each image straight from the
// uncropped NHWC batch and writes the contiguous NHWC [B, crop, crop, 3]
// result, so the crop costs no pass of its own.
//
// What bounds it: memory bandwidth alone. Per element it reads one byte and
// writes two, with four flops in between. At B = 256, 256^2 -> 224^2 that is
// 38.5 MB read + 77.1 MB written = 115.6 MB, 34.5 us at 3.35 TB/s.
//
// Design: one thread per 16 input bytes of a cropped row. A 224 crop of a
// 256-wide image is 672 bytes a row (42 x 16) starting at byte 48 of the
// row, so every load is one aligned 16-byte `ld.global.nc` and every store
// two aligned 16-byte stores of 8 packed bf16 pairs; neighbouring threads
// touch neighbouring addresses. The channel of each byte is its column in
// the flat row mod 3: the thread rotates the three (mean, inv_std) pairs
// once by (first column mod 3), after which every element's channel is a
// compile-time index. Shapes whose rows are not 16-byte aligned (e.g. a
// 240^2 input, row start at byte 24) take a one-byte-per-thread kernel with
// the same arithmetic.
//
// Arithmetic: the multiply, subtract and multiply are spelled __fmul_rn /
// __fsub_rn, so nvcc cannot contract them into an FMA, and the result is
// rounded to bf16 to nearest-even. That is exactly the plain version in
// `ops/preprocess_kernel.py:preprocess_batch_plain`, so the two agree bit
// for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Affine {
  float scale;                 // 1/255 in f32
  float mean0, mean1, mean2;   // per-channel mean
  float istd0, istd1, istd2;   // per-channel 1/std (f32 division)
};

__device__ __forceinline__ float normalize(uint32_t byte, float scale,
                                           float mean, float inv_std) {
  const float x = __fmul_rn(static_cast<float>(byte), scale);
  return __fmul_rn(__fsub_rn(x, mean), inv_std);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);   // .x = lo at the lower address
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float pick(int c, float v0, float v1, float v2) {
  return c == 0 ? v0 : (c == 1 ? v1 : v2);
}

// One thread per 16-byte vector of a cropped row. Output vector v lands at
// dst[16 v .. 16 v + 15], since the output rows are contiguous.
__global__ void __launch_bounds__(kThreads)
crop_normalize_vec16(const uint8_t* __restrict__ src,
                     __nv_bfloat16* __restrict__ dst, int64_t n_vec,
                     int vec_per_row, int crop, int64_t img_stride,
                     int64_t row_stride, int64_t src_base, Affine a) {
  const int64_t v = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (v >= n_vec) return;
  const int64_t row = v / vec_per_row;              // b * crop + y
  const int col_v = static_cast<int>(v - row * vec_per_row);
  const int64_t b = row / crop;
  const int64_t y = row - b * crop;
  const uint8_t* p = src + src_base + b * img_stride + y * row_stride +
                     static_cast<int64_t>(col_v) * 16;
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));

  // rotate the channel constants so that element i has channel (c0 + i) % 3
  const int c0 = (col_v * 16) % 3;
  const float m[3] = {pick(c0, a.mean0, a.mean1, a.mean2),
                      pick(c0, a.mean1, a.mean2, a.mean0),
                      pick(c0, a.mean2, a.mean0, a.mean1)};
  const float s[3] = {pick(c0, a.istd0, a.istd1, a.istd2),
                      pick(c0, a.istd1, a.istd2, a.istd0),
                      pick(c0, a.istd2, a.istd0, a.istd1)};

  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
  float f[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const uint32_t byte = (words[i >> 2] >> (8 * (i & 3))) & 0xFFu;
    f[i] = normalize(byte, a.scale, m[i % 3], s[i % 3]);
  }
  uint4 lo, hi;
  lo.x = pack_bf16x2(f[0], f[1]);
  lo.y = pack_bf16x2(f[2], f[3]);
  lo.z = pack_bf16x2(f[4], f[5]);
  lo.w = pack_bf16x2(f[6], f[7]);
  hi.x = pack_bf16x2(f[8], f[9]);
  hi.y = pack_bf16x2(f[10], f[11]);
  hi.z = pack_bf16x2(f[12], f[13]);
  hi.w = pack_bf16x2(f[14], f[15]);
  uint4* q = reinterpret_cast<uint4*>(dst + v * 16);
  q[0] = lo;
  q[1] = hi;
}

// One thread per output element: any crop offset and row length.
__global__ void __launch_bounds__(kThreads)
crop_normalize_scalar(const uint8_t* __restrict__ src,
                      __nv_bfloat16* __restrict__ dst, int64_t n,
                      int row_len, int crop, int64_t img_stride,
                      int64_t row_stride, int64_t src_base, Affine a) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t row = i / row_len;
  const int col = static_cast<int>(i - row * row_len);
  const int64_t b = row / crop;
  const int64_t y = row - b * crop;
  const uint32_t byte = src[src_base + b * img_stride + y * row_stride + col];
  const int c = col % 3;
  dst[i] = __float2bfloat16_rn(
      normalize(byte, a.scale, pick(c, a.mean0, a.mean1, a.mean2),
                pick(c, a.istd0, a.istd1, a.istd2)));
}

}  // namespace

// src: contiguous u8 [batch, height, width, 3] on the device.
// dst: contiguous bf16 [batch, crop, crop, 3] on the device.
// Launches on `stream` and returns the launch's cudaError_t (0 = success);
// it neither synchronizes nor allocates.
extern "C" int idunno_crop_normalize_u8_bf16(
    const void* src, void* dst, int batch, int height, int width, int crop,
    float scale, float mean0, float mean1, float mean2, float istd0,
    float istd1, float istd2, void* stream) {
  if (batch < 0 || crop <= 0 || height < crop || width < crop) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Affine a{scale, mean0, mean1, mean2, istd0, istd1, istd2};
  const int top = (height - crop) / 2;
  const int left = (width - crop) / 2;
  const int64_t row_stride = static_cast<int64_t>(width) * 3;
  const int64_t img_stride = row_stride * height;
  const int64_t src_base = top * row_stride + static_cast<int64_t>(left) * 3;
  const int row_len = crop * 3;
  const int64_t n = static_cast<int64_t>(batch) * crop * row_len;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = row_len % 16 == 0 && row_stride % 16 == 0 &&
                       src_base % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  const auto* in = static_cast<const uint8_t*>(src);
  auto* out = static_cast<__nv_bfloat16*>(dst);
  if (aligned) {
    const int64_t n_vec = n / 16;
    const unsigned blocks = static_cast<unsigned>((n_vec + kThreads - 1) / kThreads);
    crop_normalize_vec16<<<blocks, kThreads, 0, s>>>(
        in, out, n_vec, row_len / 16, crop, img_stride, row_stride, src_base, a);
  } else {
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    crop_normalize_scalar<<<blocks, kThreads, 0, s>>>(
        in, out, n, row_len, crop, img_stride, row_stride, src_base, a);
  }
  return static_cast<int>(cudaGetLastError());
}
