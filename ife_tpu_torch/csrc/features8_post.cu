// The post-smoothing features8 pass: smoothed volume s + mask -> the 8
// masked channels {s, |grad s|, e1, e2, e3, LoG, Gaussian curvature,
// Frobenius norm}.
//
// Replaces ife_tpu/kernels/fused.py:fused_features8_post_stream (kernel
// _features8_post_stream_kernel), with its shard modes x_halo and pre_padded
// as StencilModes of the one kernel (features8_tail.cuh): only the core is
// read through the mask and written.
//
// What bounds it on the H100: bytes — 2 floats read (s and the mask; the
// stencil's neighbours come from L1/L2) and 8 written per voxel, 40 B of
// HBM traffic against ~160 FLOPs. Same design as hessian_eig.cu: one
// thread per voxel, z fastest for coalescing, the shared tail of
// features8_tail.cuh in registers, exact shape with true-face clamps.
//
// ife_features8_post_windowed (features8_post_windowed_kernel) replaces
// ife_tpu/kernels/fused.py:fused_features8_post (kernel _features8_kernel),
// the 2-D-grid form whose grid step owned a block of (bx, by) x-y rows and
// copied its halo window into VMEM by hand. The window has no counterpart
// here (the neighbours come through L1/L2); what carries over is the
// ownership: a thread block owns bx planes of by rows of its 32-voxel z
// strip, and each thread marches along x through its bx planes, carrying
// the two planes behind the new one in registers, so a step loads the 9
// values of one plane instead of the 19 of the whole stencil. Same tail,
// same clamps, same result to the bit.
//
// Masking is a select, never a multiply: s is NaN outside the certainty
// support (the no-epsilon normalized-convolution divide), and NaN * 0 is
// NaN (ife_tpu/ops/features.py:21-25).
#include <cuda_runtime.h>

#include "features8_tail.cuh"

template <int kMode>
__global__ void __launch_bounds__(kStencilBlockZ * kStencilBlockY)
features8_post_kernel(StencilSource src, const float* __restrict__ mask,
                      float* __restrict__ out, int X, int Y, int Z,
                      StencilRecip k) {
    const int z = blockIdx.x * kStencilBlockZ + threadIdx.x;
    const int y = blockIdx.y * kStencilBlockY + threadIdx.y;
    const int xi = blockIdx.z;
    if (z >= Z || y >= Y) return;
    const long long n = (long long)X * Y * Z;
    const long long i = ((long long)xi * Y + y) * Z + z;
    float v[3][3][3];
    load_neighbourhood_from<kMode>(src, X, Y, Z, xi, y, z, v);
    float gm, h[6], f[6];
    features8_tail(v, k, gm, h, f);
    const bool inside = __ldg(mask + i) != 0.0f;
    out[i] = inside ? v[1][1][1] : 0.0f;
    out[n + i] = inside ? gm : 0.0f;
#pragma unroll
    for (int c = 0; c < 6; ++c) out[(c + 2) * n + i] = inside ? f[c] : 0.0f;
}

// mask: contiguous (X, Y, Z) float32, the core's; out: contiguous
// (8, X, Y, Z). mode 0: s is the contiguous core; mode 1 (x_halo): so, with
// lo and hi its (1, Y, Z) rows -1 and X; mode 2 (pre_padded): s is
// (X + 2, Y + 2, Z), the core and a one-voxel layer on x and y. lo, hi are
// read in mode 1 only.
extern "C" int ife_features8_post(const float* s, const float* lo,
                                  const float* hi, const float* mask,
                                  float* out, long long X, long long Y,
                                  long long Z, long long mode, float r2x,
                                  float r2y, float r2z, float rxx, float ryy,
                                  float rzz, cudaStream_t stream) {
    const StencilRecip k{r2x, r2y, r2z, rxx, ryy, rzz};
    const StencilSource src{s, lo, hi};
    const dim3 grid = stencil_grid(X, Y, Z);
    const dim3 block(kStencilBlockZ, kStencilBlockY);
    if (mode == kWholeVolume)
        features8_post_kernel<kWholeVolume><<<grid, block, 0, stream>>>(
            src, mask, out, (int)X, (int)Y, (int)Z, k);
    else if (mode == kXHalo && lo != nullptr && hi != nullptr)
        features8_post_kernel<kXHalo><<<grid, block, 0, stream>>>(
            src, mask, out, (int)X, (int)Y, (int)Z, k);
    else if (mode == kPrePadded)
        features8_post_kernel<kPrePadded><<<grid, block, 0, stream>>>(
            src, mask, out, (int)X, (int)Y, (int)Z, k);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

// kPadded: s is (X + 2, Y + 2, Z) around the (X, Y, Z) core (pre_padded).
template <bool kPadded>
__global__ void __launch_bounds__(kStencilBlockZ * kStencilBlockY)
features8_post_windowed_kernel(const float* __restrict__ s,
                               const float* __restrict__ mask,
                               float* __restrict__ out, int X, int Y, int Z,
                               int bx, int by, StencilRecip k) {
    const int z = blockIdx.x * kStencilBlockZ + threadIdx.x;
    if (z >= Z) return;
    const int zs[3] = {max(z - 1, 0), z, min(z + 1, Z - 1)};
    const long long plane = (long long)Y * Z;
    const long long n = (long long)X * plane;
    const StencilSource src{s, nullptr, nullptr};
    const int xa = blockIdx.z * bx, xb = min(xa + bx, X);
    const int ya = blockIdx.y * by, yb = min(ya + by, Y);
    for (int y = ya + threadIdx.y; y < yb; y += kStencilBlockY) {
        // v[a] is the 3 x 3 (y, z) neighbourhood in plane x + a - 1
        // (clamped, or a plane of the boundary layer)
        float v[3][3][3];
        auto load_plane = [&](int x, float (&w)[3][3]) {
#pragma unroll
            for (int b = 0; b < 3; ++b) {
                const float* row =
                    stencil_row<kPadded ? kPrePadded : kWholeVolume>(
                        src, X, Y, Z, x, y + b - 1);
#pragma unroll
                for (int c = 0; c < 3; ++c) w[b][c] = __ldg(row + zs[c]);
            }
        };
        load_plane(xa - 1, v[1]);
        load_plane(xa, v[2]);
        for (int x = xa; x < xb; ++x) {
#pragma unroll
            for (int b = 0; b < 3; ++b)
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    v[0][b][c] = v[1][b][c];
                    v[1][b][c] = v[2][b][c];
                }
            load_plane(x + 1, v[2]);
            float gm, h[6], f[6];
            features8_tail(v, k, gm, h, f);
            const long long i = x * plane + (long long)y * Z + z;
            const bool inside = __ldg(mask + i) != 0.0f;
            out[i] = inside ? v[1][1][1] : 0.0f;
            out[n + i] = inside ? gm : 0.0f;
#pragma unroll
            for (int c = 0; c < 6; ++c)
                out[(c + 2) * n + i] = inside ? f[c] : 0.0f;
        }
    }
}

// As ife_features8_post in mode 0 or 2 (pre_padded != 0); a thread block owns
// bx planes of by rows (>= 1 each).
extern "C" int ife_features8_post_windowed(const float* s, const float* mask,
                                           float* out, long long X, long long Y,
                                           long long Z, long long bx,
                                           long long by, long long pre_padded,
                                           float r2x, float r2y,
                                           float r2z, float rxx, float ryy,
                                           float rzz, cudaStream_t stream) {
    if (bx < 1 || by < 1) return (int)cudaErrorInvalidValue;
    const StencilRecip k{r2x, r2y, r2z, rxx, ryy, rzz};
    const dim3 grid((unsigned)((Z + kStencilBlockZ - 1) / kStencilBlockZ),
                    (unsigned)((Y + by - 1) / by), (unsigned)((X + bx - 1) / bx));
    const dim3 block(kStencilBlockZ, kStencilBlockY);
    if (pre_padded)
        features8_post_windowed_kernel<true><<<grid, block, 0, stream>>>(
            s, mask, out, (int)X, (int)Y, (int)Z, (int)bx, (int)by, k);
    else
        features8_post_windowed_kernel<false><<<grid, block, 0, stream>>>(
            s, mask, out, (int)X, (int)Y, (int)Z, (int)bx, (int)by, k);
    return (int)cudaGetLastError();
}
