// The separable Gaussian FIR taps the smoothing kernels take by value
// (normalized_conv.cu, features8_sweep.cu), or, in the multi-scale kernels
// (features8_sweep.cu's multi entry, features8_ys_multi.cu), as a device
// array of kMaxTaps floats per scale and axis that a block copies to shared
// memory and reads through a TapsView. Each output of a pass is
// sum_k t[k] * in[clamp(i + k - r)], accumulated in tap order k = 0..2r with
// f32 taps rounded once from the f64 numpy taps: the association of the plain
// twin's shifted-slice sum (ops/stencil.py kernel_smooth_axis).
#pragma once

#include <algorithm>

constexpr int kMaxTaps = 257;  // radius <= 128 voxels

struct Taps {
    int r;  // radius; 2r+1 taps
    float t[kMaxTaps];
};

// taps that live in shared or global memory: the same members as Taps
struct TapsView {
    int r;
    const float* t;
};

constexpr int kMaxScales = 8;  // scales one multi-scale launch takes

static inline bool make_taps(const float* t, long long n, Taps* out) {
    if (n < 1 || n > kMaxTaps || n % 2 == 0) return false;
    out->r = (int)(n / 2);
    std::copy(t, t + n, out->t);
    return true;
}

__device__ __forceinline__ int clamp_index(int i, int n) {
    return min(max(i, 0), n - 1);
}

// one float from global to shared memory without passing a register
// (cp.async); visible to the issuing thread after cp_async_wait_all, to the
// block after a barrier that follows it
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// kRun consecutive outputs of a tap-ordered FIR, for kArrays arrays at once,
// from ONE walk over the 2r + kRun inputs they share: load(i, v) sets v[a] to
// input i of array a, and input i feeds output u with tap i - u where that
// is a tap. Each output is still summed in tap order, tap 0's product first,
// so it equals out = sum_k t[k] * in[k] evaluated one output at a time; an
// input is read once for kRun outputs. Edge steps (the first kRun and the
// last kRun - 1 inputs) test the tap's range; the steps between feed all
// kRun outputs, none with tap 0. TapsT: Taps or TapsView.
template <int kRun, int kArrays, class TapsT, class Load>
__device__ __forceinline__ void fir_walk_by(const Load& load,
                                            const TapsT& taps,
                                            float (&acc)[kArrays][kRun]) {
    const int nt = 2 * taps.r + 1;
#pragma unroll
    for (int a = 0; a < kArrays; ++a)
#pragma unroll
        for (int u = 0; u < kRun; ++u) acc[a][u] = 0.0f;
    auto step = [&](int i, bool edge) {
        float v[kArrays];
        load(i, v);
#pragma unroll
        for (int u = 0; u < kRun; ++u) {
            const int k = i - u;
            if (edge && (k < 0 || k >= nt)) continue;
            const float w = taps.t[k];
#pragma unroll
            for (int a = 0; a < kArrays; ++a)
                acc[a][u] = edge && k == 0 ? w * v[a] : acc[a][u] + w * v[a];
        }
    };
    const int hi = max(kRun, nt);
    for (int i = 0; i < kRun; ++i) step(i, true);
    for (int i = kRun; i < hi; ++i) step(i, false);
    for (int i = hi; i < nt + kRun - 1; ++i) step(i, true);
}

// fir_walk_by over shared memory: col[a] points at the input of the first
// output's tap 0, inputs lie `stride` floats apart.
template <int kRun, int kArrays, class TapsT>
__device__ __forceinline__ void fir_walk(const float* const (&col)[kArrays],
                                         int stride, const TapsT& taps,
                                         float (&acc)[kArrays][kRun]) {
    fir_walk_by<kRun, kArrays>(
        [&](int i, float (&v)[kArrays]) {
#pragma unroll
            for (int a = 0; a < kArrays; ++a) v[a] = col[a][i * stride];
        },
        taps, acc);
}
