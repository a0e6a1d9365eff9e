// Native host-side image staging (the data-loader hot path).
//
// The reference's host pipeline is a per-image Python loop with PIL
// transforms (`alexnet_resnet.py:46-66`). The engine consumes canonical
// uint8 [N, S, S, 3] batches; producing them from decoded frames is pure
// memory-bandwidth + interpolation work that belongs in native code:
//   - resize_bilinear_u8: decoded RGB frame -> target size (OpenMP across
//     rows, auto-vectorized inner loop; fixed-point weights)
//   - stage_batch_u8: K decoded frames -> one contiguous batch buffer with
//     shortest-side-resize + center-crop semantics (OpenMP across frames)
//
// Built on demand with `g++ -O3 -march=native -fopenmp -shared -fPIC` by
// idunno_tpu_torch.native (ctypes binding, graceful numpy fallback).

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// Bilinear resize of an interleaved RGB u8 image. Fixed-point (16.16),
// half-pixel convention: sx = (x + 0.5) * sw/dw - 0.5, clamped. The numpy
// fallback in idunno_tpu/native/__init__.py implements the exact same
// fixed-point math so native and fallback staging are pixel-identical
// (cross-host determinism does not depend on the toolchain being present).
static inline int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

void resize_bilinear_u8(const uint8_t* src, int sh, int sw,
                        uint8_t* dst, int dh, int dw) {
    const int64_t x_step = ((int64_t)sw << 16) / dw;
    const int64_t y_step = ((int64_t)sh << 16) / dh;
#pragma omp parallel for schedule(static)
    for (int y = 0; y < dh; ++y) {
        const int64_t sy = clamp64(
            y * y_step + y_step / 2 - (1LL << 15), 0, (int64_t)(sh - 1) << 16);
        const int y0 = (int)(sy >> 16);
        const int y1 = std::min(y0 + 1, sh - 1);
        const int fy = (int)(sy & 0xffff);
        const uint8_t* row0 = src + (int64_t)y0 * sw * 3;
        const uint8_t* row1 = src + (int64_t)y1 * sw * 3;
        uint8_t* out = dst + (int64_t)y * dw * 3;
        for (int x = 0; x < dw; ++x) {
            const int64_t sx = clamp64(
                x * x_step + x_step / 2 - (1LL << 15), 0,
                (int64_t)(sw - 1) << 16);
            const int x0 = (int)(sx >> 16);
            const int x1 = std::min(x0 + 1, sw - 1);
            const int fx = (int)(sx & 0xffff);
            for (int c = 0; c < 3; ++c) {
                const int p00 = row0[x0 * 3 + c], p01 = row0[x1 * 3 + c];
                const int p10 = row1[x0 * 3 + c], p11 = row1[x1 * 3 + c];
                const int64_t top = ((int64_t)p00 << 16)
                                    + (int64_t)(p01 - p00) * fx;
                const int64_t bot = ((int64_t)p10 << 16)
                                    + (int64_t)(p11 - p10) * fx;
                const int64_t val = (top << 16) + (bot - top) * (int64_t)fy;
                out[x * 3 + c] = (uint8_t)((val + (1LL << 31)) >> 32);
            }
        }
    }
}

// Stage K independently-sized decoded frames into one contiguous
// [k, size, size, 3] batch: shortest-side resize to `size`, center crop.
// frames: array of k pointers; dims: [k][2] = (h, w) per frame.
void stage_batch_u8(const uint8_t* const* frames, const int32_t* dims,
                    int k, int size, uint8_t* dst) {
#pragma omp parallel for schedule(dynamic)
    for (int i = 0; i < k; ++i) {
        const int sh = dims[i * 2], sw = dims[i * 2 + 1];
        // shortest-side target dims, rounded division (matches the
        // fallback's (d * size + s / 2) / s exactly)
        int rh, rw;
        if (sw <= sh) {
            rw = size;
            rh = std::max((int64_t)size,
                          ((int64_t)sh * size + sw / 2) / sw);
        } else {
            rh = size;
            rw = std::max((int64_t)size,
                          ((int64_t)sw * size + sh / 2) / sh);
        }
        uint8_t* tmp = new uint8_t[(int64_t)rh * rw * 3];
        resize_bilinear_u8(frames[i], sh, sw, tmp, rh, rw);
        const int top = (rh - size) / 2, left = (rw - size) / 2;
        uint8_t* out = dst + (int64_t)i * size * size * 3;
        for (int y = 0; y < size; ++y) {
            std::memcpy(out + (int64_t)y * size * 3,
                        tmp + ((int64_t)(y + top) * rw + left) * 3,
                        (size_t)size * 3);
        }
        delete[] tmp;
    }
}

}  // extern "C"
