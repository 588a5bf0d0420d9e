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
//
// The probe outputs (HessianOutput) are the same kernel, grid, neighbourhood
// load and store loop with another function of the loaded neighbourhood, for
// the roofline probes of the TPU kernel: kCopyFloor replaces
// ife_tpu/kernels/fused.py:472-478 (_kernel's variant="copyfloor") and
// benchmarks/probe11.py:99 floor_window, which compute the same function;
// kCopy6 and kStencil6 replace benchmarks/probe_fused.py:29
// _variant_kernel's "copy6" and "stencil6". Whole-volume mode only.
#include <cuda_runtime.h>

#include <limits>

#include "features8_tail.cuh"

// What the kernel writes per voxel, six channels:
//   kFeatures   the six eigen features (the kernel's function);
//   kCopyFloor  s + k, channel k = 0..5: the copy floor of this kernel shape;
//   kCopy6      s, six times;
//   kStencil6   Dxx, Dyy, Dzz, Dxy, Dxz, Dyz, the stencil without the eigen
//               solve.
enum HessianOutput { kFeatures = 0, kCopyFloor = 1, kCopy6 = 2, kStencil6 = 3 };

template <int kMode, int kOut>
__global__ void __launch_bounds__(kStencilBlockZ * kStencilBlockY)
hessian_eig_kernel(StencilSource src, float* __restrict__ out, int X, int Y,
                   int Z, StencilRecip k, float never) {
    const int z = blockIdx.x * kStencilBlockZ + threadIdx.x;
    const int y = blockIdx.y * kStencilBlockY + threadIdx.y;
    const int xi = blockIdx.z;
    if (z >= Z || y >= Y) return;
    float v[3][3][3];
    load_neighbourhood_from<kMode>(src, X, Y, Z, xi, y, z, v);
    float o[6];
    if (kOut == kFeatures) {
        float gm, h[6];
        features8_tail(v, k, gm, h, o);
    } else if (kOut == kStencil6) {
        float gm, h[6];
        hessian_stencil(v, k, gm, h);
        const int order[6] = {0, 3, 5, 1, 2, 4};  // from the packed order
#pragma unroll
        for (int c = 0; c < 6; ++c) o[c] = h[order[c]];
    } else {
        // only the centre is written: keep the other 18 loads live, as the
        // TPU kernel's window DMA moved them, by a select on their sum that
        // is never taken (`never` is NaN at run time, unknown to the
        // compiler)
        float sum = 0.0f;
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int b = 0; b < 3; ++b)
#pragma unroll
                for (int c = 0; c < 3; ++c)
                    if (a == 1 || b == 1 || c == 1) sum += v[a][b][c];
        const float s0 = sum == never ? sum : v[1][1][1];
#pragma unroll
        for (int c = 0; c < 6; ++c)
            o[c] = kOut == kCopyFloor ? s0 + (float)c : s0;
    }
    const long long n = (long long)X * Y * Z;
    const long long i = ((long long)xi * Y + y) * Z + z;
#pragma unroll
    for (int c = 0; c < 6; ++c) out[c * n + i] = o[c];
}

template <int kMode, int kOut>
static void launch_hessian(const StencilSource& src, float* out, long long X,
                           long long Y, long long Z, const StencilRecip& k,
                           cudaStream_t stream) {
    hessian_eig_kernel<kMode, kOut>
        <<<stencil_grid(X, Y, Z), dim3(kStencilBlockZ, kStencilBlockY), 0,
           stream>>>(src, out, (int)X, (int)Y, (int)Z, k,
                     std::numeric_limits<float>::quiet_NaN());
}

// out: contiguous (6, X, Y, Z) float32 for the (X, Y, Z) core. mode 0: x is
// the contiguous core; mode 1 (x_halo): so, with lo and hi its (1, Y, Z)
// rows -1 and X; mode 2 (pre_padded): x is (X + 2, Y + 2, Z), the core and a
// one-voxel layer on x and y. lo, hi are read in mode 1 only. output: a
// HessianOutput; the probe outputs take mode 0 alone.
extern "C" int ife_hessian_eig(const float* x, const float* lo, const float* hi,
                               float* out, long long X, long long Y,
                               long long Z, long long mode, long long output,
                               float r2x, float r2y, float r2z, float rxx,
                               float ryy, float rzz, cudaStream_t stream) {
    const StencilRecip k{r2x, r2y, r2z, rxx, ryy, rzz};
    const StencilSource src{x, lo, hi};
    if (output != kFeatures && mode != kWholeVolume)
        return (int)cudaErrorInvalidValue;
    if (mode == kWholeVolume && output == kFeatures)
        launch_hessian<kWholeVolume, kFeatures>(src, out, X, Y, Z, k, stream);
    else if (mode == kWholeVolume && output == kCopyFloor)
        launch_hessian<kWholeVolume, kCopyFloor>(src, out, X, Y, Z, k, stream);
    else if (mode == kWholeVolume && output == kCopy6)
        launch_hessian<kWholeVolume, kCopy6>(src, out, X, Y, Z, k, stream);
    else if (mode == kWholeVolume && output == kStencil6)
        launch_hessian<kWholeVolume, kStencil6>(src, out, X, Y, Z, k, stream);
    else if (mode == kXHalo && lo != nullptr && hi != nullptr)
        launch_hessian<kXHalo, kFeatures>(src, out, X, Y, Z, k, stream);
    else if (mode == kPrePadded)
        launch_hessian<kPrePadded, kFeatures>(src, out, X, Y, Z, k, stream);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

extern "C" const char* ife_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
