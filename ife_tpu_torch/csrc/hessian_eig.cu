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
//
// The shard modes of the TPU kernels (x_halo = _stream_kernel's ext_halo,
// pre_padded) are StencilModes of the same kernel (features8_tail.cuh): the
// neighbour rows come from two extra row pointers or from a block that
// already carries its boundary layer, and only the core is written.
#include <cuda_runtime.h>

#include "features8_tail.cuh"

template <int kMode>
__global__ void __launch_bounds__(kStencilBlockZ * kStencilBlockY)
hessian_eig_kernel(StencilSource src, float* __restrict__ out, int X, int Y,
                   int Z, StencilRecip k) {
    const int z = blockIdx.x * kStencilBlockZ + threadIdx.x;
    const int y = blockIdx.y * kStencilBlockY + threadIdx.y;
    const int xi = blockIdx.z;
    if (z >= Z || y >= Y) return;
    float v[3][3][3];
    load_neighbourhood_from<kMode>(src, X, Y, Z, xi, y, z, v);
    float gm, h[6], f[6];
    features8_tail(v, k, gm, h, f);
    const long long n = (long long)X * Y * Z;
    const long long i = ((long long)xi * Y + y) * Z + z;
#pragma unroll
    for (int c = 0; c < 6; ++c) out[c * n + i] = f[c];
}

// out: contiguous (6, X, Y, Z) float32 for the (X, Y, Z) core. mode 0: x is
// the contiguous core; mode 1 (x_halo): so, with lo and hi its (1, Y, Z)
// rows -1 and X; mode 2 (pre_padded): x is (X + 2, Y + 2, Z), the core and a
// one-voxel layer on x and y. lo, hi are read in mode 1 only.
extern "C" int ife_hessian_eig(const float* x, const float* lo, const float* hi,
                               float* out, long long X, long long Y,
                               long long Z, long long mode, float r2x,
                               float r2y, float r2z, float rxx, float ryy,
                               float rzz, cudaStream_t stream) {
    const StencilRecip k{r2x, r2y, r2z, rxx, ryy, rzz};
    const StencilSource src{x, lo, hi};
    const dim3 grid = stencil_grid(X, Y, Z);
    const dim3 block(kStencilBlockZ, kStencilBlockY);
    if (mode == kWholeVolume)
        hessian_eig_kernel<kWholeVolume><<<grid, block, 0, stream>>>(
            src, out, (int)X, (int)Y, (int)Z, k);
    else if (mode == kXHalo && lo != nullptr && hi != nullptr)
        hessian_eig_kernel<kXHalo><<<grid, block, 0, stream>>>(
            src, out, (int)X, (int)Y, (int)Z, k);
    else if (mode == kPrePadded)
        hessian_eig_kernel<kPrePadded><<<grid, block, 0, stream>>>(
            src, out, (int)X, (int)Y, (int)Z, k);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

extern "C" const char* ife_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
