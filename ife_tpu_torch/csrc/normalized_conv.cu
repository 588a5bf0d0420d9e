// Normalized Gaussian convolution: out = G*(c*f) / G*c, separable FIR with
// edge-clamped (ZeroFluxNeumann) indices, the certainty c used RAW, and the
// divide without epsilon (NaN = 0/0 outside the certainty support, as in the
// reference NormalizedGaussianConvolutionImageFilter.hxx:40-63).
//
// Replaces ife_tpu/kernels/fused.py:fused_normalized_conv_sweep (kernel
// _nc_sweep_kernel). The TPU kernel swept x with a VMEM ring of input rows
// whose size capped the radius (and sent large sigma to an MXU band-einsum
// path); here there is no such cap below kMaxTaps.
//
// Three separable passes in the order of ops/stencil.py gaussian_smooth —
// x, then y, then z — each for the numerator (c*f) and the denominator (c),
// through two scratch volumes S1, S2 and the output O:
//   x: (f, c) -> S1 = G_x*(c*f)      x: c  -> S2 = G_x*c
//   y: S1     -> O                   y: S2 -> S1
//   z: (O, S1) -> O = G_z*O / G_z*S1 (in place: a block owns whole z rows)
// Each output is sum_k t[k] * in[clamp(i + k - r)] in tap order, f32 taps
// rounded once from the f64 numpy taps.
//
// What bounds it on the H100: the arithmetic of the taps, 2 * (2r+1)
// multiplies and adds per voxel, pass and array, unfused to match the twin
// (at r = 28 that is above the 7 volume reads + 5 writes of HBM traffic).
// Every pass stages its inputs in shared memory: the x and y passes a tile
// extended by the radius (fir_axis_kernel), the z pass each whole row of
// numerator and denominator.
//
// ife_smooth_yz runs the y and z passes alone (no divide), for the
// features8_xs_stream branch of ops/features.py, where the x pass, the
// divide and the feature tail follow in one kernel (features8_sweep.cu).
//
// ife_smooth_xz runs the x and z passes alone, per scale ahead of the
// multi-scale kernel (features8_ys_multi.cu), which adds the y pass, the
// divide and the tail; ife_tpu smooths x and z there with XLA band einsums
// (ife_tpu/ops/features.py multiscale_features8_fused).
#include <cuda_runtime.h>

#include "fir.cuh"

constexpr int kRowThreads = 128;

// out = G_axis * (a [* w]) along axis 0 (x) or 1 (y) of an (X, Y, Z) volume.
// A block owns kFirTileA outputs along the axis for kFirTileZ columns of z at
// one position of the third axis. It stages its inputs (the tile extended by
// the radius at both ends, at clamped positions, c*f already multiplied) in
// shared memory, then each thread makes kFirRun consecutive outputs of one
// column from one walk over the inputs they share (fir_walk): a tap's input
// comes from shared memory, once for four outputs, where a thread per voxel
// fetched all 2r+1 through L1/L2. The halo is read (kFirTileA + 2r) /
// kFirTileA times (1.44 at r = 28).
// Blocks are numbered so that those resident together read neighbouring
// memory: z tiles fastest, then for the x pass y (blockIdx.z is the x tile),
// for the y pass the y tile (blockIdx.z is x).
constexpr int kFirTileA = 128;
constexpr int kFirTileZ = 32;
constexpr int kFirRun = 4;  // divides kFirTileA
constexpr int kFirThreads = 256;

template <bool kWeighted>
__global__ void __launch_bounds__(kFirThreads)
fir_axis_kernel(const float* __restrict__ a, const float* __restrict__ w,
                float* __restrict__ out, int X, int Y, int Z, int axis,
                Taps taps) {
    extern __shared__ float tile[];  // [kFirTileA + 2r][kFirTileZ]
    constexpr int TA = kFirTileA, TZ = kFirTileZ, RUN = kFirRun;
    const int r = taps.r;
    const int n = axis == 0 ? X : Y;
    const int z0 = blockIdx.x * TZ;
    const int a0 = (axis == 0 ? blockIdx.z : blockIdx.y) * TA;
    const int other = axis == 0 ? blockIdx.y : blockIdx.z;
    const long long stride = axis == 0 ? (long long)Y * Z : (long long)Z;
    // offset of position 0 along the axis, column 0 of z
    const long long base = axis == 0 ? (long long)other * Z
                                     : (long long)other * Y * Z;
    for (int idx = threadIdx.x; idx < (TA + 2 * r) * TZ; idx += blockDim.x) {
        const int z = z0 + idx % TZ;
        float v = 0.0f;
        if (z < Z) {
            const long long off =
                base + clamp_index(a0 - r + idx / TZ, n) * stride + z;
            v = __ldg(a + off);
            if (kWeighted) v *= __ldg(w + off);  // c*f rounded, as plain
        }
        tile[idx] = v;
    }
    __syncthreads();
    for (int item = threadIdx.x; item < (TA / RUN) * TZ; item += blockDim.x) {
        const int i0 = (item / TZ) * RUN, z = z0 + item % TZ;
        if (a0 + i0 >= n || z >= Z) continue;
        const float* const col[1] = {tile + i0 * TZ + item % TZ};
        float acc[1][RUN];
        fir_walk<RUN, 1>(col, TZ, taps, acc);
#pragma unroll
        for (int u = 0; u < RUN; ++u)
            if (a0 + i0 + u < n)
                out[base + (long long)(a0 + i0 + u) * stride + z] = acc[0][u];
    }
}

template <bool kWeighted>
static cudaError_t launch_fir_axis(const float* a, const float* w, float* out,
                                   long long X, long long Y, long long Z,
                                   int axis, const Taps& taps,
                                   cudaStream_t stream) {
    const size_t smem =
        (size_t)(kFirTileA + 2 * taps.r) * kFirTileZ * sizeof(float);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            fir_axis_kernel<kWeighted>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    const unsigned gz = (unsigned)((Z + kFirTileZ - 1) / kFirTileZ);
    const dim3 grid =
        axis == 0 ? dim3(gz, (unsigned)Y, (unsigned)((X + kFirTileA - 1) / kFirTileA))
                  : dim3(gz, (unsigned)((Y + kFirTileA - 1) / kFirTileA), (unsigned)X);
    fir_axis_kernel<kWeighted><<<grid, kFirThreads, smem, stream>>>(
        a, w, out, (int)X, (int)Y, (int)Z, axis, taps);
    return cudaSuccess;
}

// out = G_z*num / G_z*den per z row (kDivide), else num = G_z*num and
// den = G_z*den in place; one block per (x, y) row with the row staged in
// shared memory, so out may alias num or den
template <bool kDivide>
__global__ void __launch_bounds__(kRowThreads)
fir_z_kernel(float* num, float* den, float* out, int Z, Taps taps) {
    extern __shared__ float rows[];  // [0, Z): num row, [Z, 2Z): den row
    float* sn = rows;
    float* sd = rows + Z;
    const long long row = (long long)blockIdx.y * gridDim.x + blockIdx.x;
    const long long off = row * Z;
    for (int z = threadIdx.x; z < Z; z += blockDim.x) {
        sn[z] = num[off + z];
        sd[z] = den[off + z];
    }
    __syncthreads();
    for (int z = threadIdx.x; z < Z; z += blockDim.x) {
        float an = 0.0f, ad = 0.0f;
        for (int k = 0; k <= 2 * taps.r; ++k) {
            const int j = clamp_index(z + k - taps.r, Z);
            an = k == 0 ? taps.t[0] * sn[j] : an + taps.t[k] * sn[j];
            ad = k == 0 ? taps.t[0] * sd[j] : ad + taps.t[k] * sd[j];
        }
        if (kDivide) {
            out[off + z] = an / ad;  // no epsilon: 0/0 = NaN off the support
        } else {
            num[off + z] = an;
            den[off + z] = ad;
        }
    }
}

template <bool kDivide>
static cudaError_t launch_fir_z(float* num, float* den, float* out,
                                long long X, long long Y, long long Z,
                                const Taps& tz, cudaStream_t stream) {
    const size_t smem = 2 * (size_t)Z * sizeof(float);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            fir_z_kernel<kDivide>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return e;
    }
    fir_z_kernel<kDivide><<<dim3((unsigned)Y, (unsigned)X), kRowThreads, smem,
                            stream>>>(num, den, out, (int)Z, tz);
    return cudaSuccess;
}

// image, cert, out, s1, s2: contiguous (X, Y, Z) float32 on the device (s1,
// s2 are scratch); taps_*: host arrays of 2r+1 floats per axis.
extern "C" int ife_normalized_conv(const float* image, const float* cert,
                                   float* out, float* s1, float* s2,
                                   long long X, long long Y, long long Z,
                                   const float* taps_x, long long ntx,
                                   const float* taps_y, long long nty,
                                   const float* taps_z, long long ntz,
                                   cudaStream_t stream) {
    Taps tx, ty, tz;
    if (!make_taps(taps_x, ntx, &tx) || !make_taps(taps_y, nty, &ty)
        || !make_taps(taps_z, ntz, &tz))
        return (int)cudaErrorInvalidValue;
    cudaError_t e = launch_fir_axis<true>(image, cert, s1, X, Y, Z, 0, tx, stream);
    if (e == cudaSuccess)
        e = launch_fir_axis<false>(cert, nullptr, s2, X, Y, Z, 0, tx, stream);
    if (e == cudaSuccess)
        e = launch_fir_axis<false>(s1, nullptr, out, X, Y, Z, 1, ty, stream);
    if (e == cudaSuccess)
        e = launch_fir_axis<false>(s2, nullptr, s1, X, Y, Z, 1, ty, stream);
    if (e == cudaSuccess)
        e = launch_fir_z<true>(out, s1, out, X, Y, Z, tz, stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// num = G_z*G_a*(cert*image), den = G_z*G_a*cert for a = axis (0: x, 1: y)
static int smooth_pair(int axis, const float* image, const float* cert,
                       float* num, float* den, long long X, long long Y,
                       long long Z, const float* taps_a, long long nta,
                       const float* taps_z, long long ntz,
                       cudaStream_t stream) {
    Taps ta, tz;
    if (!make_taps(taps_a, nta, &ta) || !make_taps(taps_z, ntz, &tz))
        return (int)cudaErrorInvalidValue;
    cudaError_t e = launch_fir_axis<true>(image, cert, num, X, Y, Z, axis, ta, stream);
    if (e == cudaSuccess)
        e = launch_fir_axis<false>(cert, nullptr, den, X, Y, Z, axis, ta, stream);
    if (e == cudaSuccess)
        e = launch_fir_z<false>(num, den, nullptr, X, Y, Z, tz, stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// num = G_z*G_y*(cert*image), den = G_z*G_y*cert: contiguous (X, Y, Z)
// float32 on the device; taps_*: host arrays of 2r+1 floats.
extern "C" int ife_smooth_yz(const float* image, const float* cert,
                             float* num, float* den,
                             long long X, long long Y, long long Z,
                             const float* taps_y, long long nty,
                             const float* taps_z, long long ntz,
                             cudaStream_t stream) {
    return smooth_pair(1, image, cert, num, den, X, Y, Z, taps_y, nty, taps_z,
                       ntz, stream);
}

// num = G_z*G_x*(cert*image), den = G_z*G_x*cert: as ife_smooth_yz, along x
// instead of y.
extern "C" int ife_smooth_xz(const float* image, const float* cert,
                             float* num, float* den,
                             long long X, long long Y, long long Z,
                             const float* taps_x, long long ntx,
                             const float* taps_z, long long ntz,
                             cudaStream_t stream) {
    return smooth_pair(0, image, cert, num, den, X, Y, Z, taps_x, ntx, taps_z,
                       ntz, stream);
}
