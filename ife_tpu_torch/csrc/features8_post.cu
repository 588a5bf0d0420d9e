// The post-smoothing features8 pass: smoothed volume s + mask -> the 8
// masked channels {s, |grad s|, e1, e2, e3, LoG, Gaussian curvature,
// Frobenius norm}.
//
// Replaces ife_tpu/kernels/fused.py:fused_features8_post_stream (kernel
// _features8_post_stream_kernel), plain mode (the pre_padded / x_halo
// shard modes wait for the port of parallel/).
//
// What bounds it on the H100: bytes — 2 floats read (s and the mask; the
// stencil's neighbours come from L1/L2) and 8 written per voxel, 40 B of
// HBM traffic against ~160 FLOPs. Same design as hessian_eig.cu: one
// thread per voxel, z fastest for coalescing, the shared tail of
// features8_tail.cuh in registers, exact shape with true-face clamps.
//
// Masking is a select, never a multiply: s is NaN outside the certainty
// support (the no-epsilon normalized-convolution divide), and NaN * 0 is
// NaN (ife_tpu/ops/features.py:21-25).
#include <cuda_runtime.h>

#include "features8_tail.cuh"

__global__ void __launch_bounds__(kStencilBlockZ * kStencilBlockY)
features8_post_kernel(const float* __restrict__ s,
                      const float* __restrict__ mask,
                      float* __restrict__ out, int X, int Y, int Z,
                      StencilRecip k) {
    const int z = blockIdx.x * kStencilBlockZ + threadIdx.x;
    const int y = blockIdx.y * kStencilBlockY + threadIdx.y;
    const int xi = blockIdx.z;
    if (z >= Z || y >= Y) return;
    const long long n = (long long)X * Y * Z;
    const long long i = ((long long)xi * Y + y) * Z + z;
    float v[3][3][3];
    load_neighbourhood(s, X, Y, Z, xi, y, z, v);
    float gm, h[6], f[6];
    features8_tail(v, k, gm, h, f);
    const bool inside = __ldg(mask + i) != 0.0f;
    out[i] = inside ? v[1][1][1] : 0.0f;
    out[n + i] = inside ? gm : 0.0f;
#pragma unroll
    for (int c = 0; c < 6; ++c) out[(c + 2) * n + i] = inside ? f[c] : 0.0f;
}

// s, mask: contiguous (X, Y, Z) float32; out: contiguous (8, X, Y, Z).
extern "C" int ife_features8_post(const float* s, const float* mask,
                                  float* out, long long X, long long Y,
                                  long long Z, float r2x, float r2y, float r2z,
                                  float rxx, float ryy, float rzz,
                                  cudaStream_t stream) {
    const StencilRecip k{r2x, r2y, r2z, rxx, ryy, rzz};
    features8_post_kernel<<<stencil_grid(X, Y, Z),
                            dim3(kStencilBlockZ, kStencilBlockY), 0, stream>>>(
        s, mask, out, (int)X, (int)Y, (int)Z, k);
    return (int)cudaGetLastError();
}
