// Hessian + eigen features of the unsmoothed volume, one pass.
//
// Replaces ife_tpu/kernels/fused.py:fused_hessian_eig_stream (kernel
// _stream_kernel) and fused_hessian_eig (kernel _kernel, the same math
// through manual-DMA windows): the central-difference Hessian (cascaded
// cross terms, edge clamp) of x and its six eigen features
// {e1, e2, e3, LoG, Gaussian curvature, Frobenius norm}.
//
// What bounds it on the H100: bytes. Per voxel it reads 1 float (its 19
// clamped neighbours come from L1/L2: rows and planes adjacent in x, y, z
// are read by neighbouring threads and blocks) and writes 6, i.e. 28 B of
// HBM traffic against ~150 FLOPs — far below the ~20 FLOP/B at which the
// card turns compute-bound in f32. The design therefore spends nothing on
// data reuse machinery: one thread per voxel, z fastest so every load and
// store of a warp is one coalesced 128-byte line, the tail in registers.
// The TPU kernel's x-slab halo streaming and Y->8 / Z->128 padding were
// VMEM/lane-tiling artefacts and are not carried over: the kernel runs on
// the exact (X, Y, Z) shape and clamps at the true faces.
#include <cuda_runtime.h>

#include "features8_tail.cuh"

__global__ void __launch_bounds__(kStencilBlockZ * kStencilBlockY)
hessian_eig_kernel(const float* __restrict__ x, float* __restrict__ out,
                   int X, int Y, int Z, StencilRecip k) {
    const int z = blockIdx.x * kStencilBlockZ + threadIdx.x;
    const int y = blockIdx.y * kStencilBlockY + threadIdx.y;
    const int xi = blockIdx.z;
    if (z >= Z || y >= Y) return;
    float v[3][3][3];
    load_neighbourhood(x, X, Y, Z, xi, y, z, v);
    float gm, h[6], f[6];
    features8_tail(v, k, gm, h, f);
    const long long n = (long long)X * Y * Z;
    const long long i = ((long long)xi * Y + y) * Z + z;
#pragma unroll
    for (int c = 0; c < 6; ++c) out[c * n + i] = f[c];
}

// x: contiguous (X, Y, Z) float32; out: contiguous (6, X, Y, Z) float32.
extern "C" int ife_hessian_eig(const float* x, float* out, long long X,
                               long long Y, long long Z, float r2x, float r2y,
                               float r2z, float rxx, float ryy, float rzz,
                               cudaStream_t stream) {
    const StencilRecip k{r2x, r2y, r2z, rxx, ryy, rzz};
    hessian_eig_kernel<<<stencil_grid(X, Y, Z),
                         dim3(kStencilBlockZ, kStencilBlockY), 0, stream>>>(
        x, out, (int)X, (int)Y, (int)Z, k);
    return (int)cudaGetLastError();
}

extern "C" const char* ife_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
