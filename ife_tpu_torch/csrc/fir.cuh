// The separable Gaussian FIR taps the smoothing kernels take by value
// (normalized_conv.cu, features8_sweep.cu). Each output of a pass is
// sum_k t[k] * in[clamp(i + k - r)], accumulated in tap order k = 0..2r with
// f32 taps rounded once from the f64 numpy taps: the association of the plain
// twin's shifted-slice sum (ops/stencil.py gaussian_smooth_axis).
#pragma once

#include <algorithm>

constexpr int kMaxTaps = 257;  // radius <= 128 voxels

struct Taps {
    int r;  // radius; 2r+1 taps
    float t[kMaxTaps];
};

static inline bool make_taps(const float* t, long long n, Taps* out) {
    if (n < 1 || n > kMaxTaps || n % 2 == 0) return false;
    out->r = (int)(n / 2);
    std::copy(t, t + n, out->t);
    return true;
}

__device__ __forceinline__ int clamp_index(int i, int n) {
    return min(max(i, 0), n - 1);
}
