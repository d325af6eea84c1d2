// Native host data-plane kernels: quantize / deinterleave.
//
// The host side of the reference's pinned-memory transport layer
// (/root/reference/effex/effex.py:105-110 moved bytes with cuSignal
// pinned buffers + CUDA streams; here the equivalent hot loops are the
// CPU passes between the SDR byte stream and jax.device_put).
// numpy does each of these as a multi-pass strided ufunc chain — the
// complex64 -> int8 quantize alone measures ~240 MS/s single-thread,
// capping the whole >=100 MS/s streaming pipeline.  These single-pass
// loops auto-vectorize (AVX-512 on the build host) and are bound by
// ctypes from fxtpu/runtime/native.py with transparent numpy fallback.
//
// All functions are single-threaded by design: the production pipeline
// already runs one feeder thread per channel, so parallelism comes from
// the caller and these loops stay allocation- and lock-free.

#include <cmath>
#include <cstdint>

namespace {

inline int8_t quant1(float x, float inv) {
    float v = std::nearbyintf(x * inv);
    if (v != v) return 0;  // NaN: defined result matching the numpy
                           // fallback's cast (float->int8 of NaN is UB)
    if (v > 127.f) v = 127.f;
    if (v < -127.f) v = -127.f;
    return static_cast<int8_t>(v);
}

}  // namespace

extern "C" {

// complex64 block (interleaved re,im float pairs) -> int8 [n, 2]
// quantized round(x/step) clipped to [-127, 127] — the
// QuantizedSource._quantize contract (fxtpu/sources/base.py).
void fx_quant_c64_i8(const float* src, int8_t* dst, int64_t n,
                     float inv_step) {
    for (int64_t i = 0; i < 2 * n; ++i) {
        dst[i] = quant1(src[i], inv_step);
    }
}

// int8 [n, 2] interleaved -> separate re / im planes.
void fx_split_i8(const int8_t* src, int8_t* re, int8_t* im, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        re[i] = src[2 * i];
        im[i] = src[2 * i + 1];
    }
}

// complex64 (interleaved float pairs) -> separate f32 re / im planes.
void fx_split_c64(const float* src, float* re, float* im, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        re[i] = src[2 * i];
        im[i] = src[2 * i + 1];
    }
}

}  // extern "C"
