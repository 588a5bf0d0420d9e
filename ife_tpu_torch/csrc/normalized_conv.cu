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
// What bounds it on the H100: bytes and, at large radii, L2 bandwidth.
// The x and y passes are one thread per voxel, z fastest (coalesced); their
// 2r+1 tap reads per output come from L1/L2 (neighbouring rows and planes
// are read by neighbouring blocks), so HBM sees ~7 volume reads + 5 writes
// per call while L2 serves (2r+1) reads per voxel and pass. The z pass
// stages each whole row of numerator and denominator in shared memory.
//
// ife_smooth_yz runs the y and z passes alone (no divide), for the
// features8_xs_stream branch of ops/features.py, where the x pass, the
// divide and the feature tail follow in one kernel (features8_sweep.cu).
#include <cuda_runtime.h>

#include "fir.cuh"

constexpr int kBlockZ = 32;
constexpr int kBlockY = 4;
constexpr int kRowThreads = 128;

// out = G_axis * (a [* w]) along axis 0 (x) or 1 (y) of an (X, Y, Z) volume
template <bool kWeighted>
__global__ void __launch_bounds__(kBlockZ * kBlockY)
fir_axis_kernel(const float* __restrict__ a, const float* __restrict__ w,
                float* __restrict__ out, int X, int Y, int Z, int axis,
                Taps taps) {
    const int z = blockIdx.x * kBlockZ + threadIdx.x;
    const int y = blockIdx.y * kBlockY + threadIdx.y;
    const int xi = blockIdx.z;
    if (z >= Z || y >= Y) return;
    const long long i = ((long long)xi * Y + y) * Z + z;
    const int n = axis == 0 ? X : Y;
    const int pos = axis == 0 ? xi : y;
    const long long stride = axis == 0 ? (long long)Y * Z : (long long)Z;
    const long long base = i - pos * stride;
    float acc = 0.0f;
    for (int k = 0; k <= 2 * taps.r; ++k) {
        const int j = clamp_index(pos + k - taps.r, n);
        const long long idx = base + j * stride;
        float val = __ldg(a + idx);
        if (kWeighted) val *= __ldg(w + idx);  // c*f rounded, as plain
        acc = k == 0 ? taps.t[0] * val : acc + taps.t[k] * val;
    }
    out[i] = acc;
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
    const int x = (int)X, y = (int)Y, z = (int)Z;
    const dim3 grid((unsigned)((Z + kBlockZ - 1) / kBlockZ),
                    (unsigned)((Y + kBlockY - 1) / kBlockY), (unsigned)X);
    const dim3 block(kBlockZ, kBlockY);
    fir_axis_kernel<true><<<grid, block, 0, stream>>>(image, cert, s1, x, y, z, 0, tx);
    fir_axis_kernel<false><<<grid, block, 0, stream>>>(cert, nullptr, s2, x, y, z, 0, tx);
    fir_axis_kernel<false><<<grid, block, 0, stream>>>(s1, nullptr, out, x, y, z, 1, ty);
    fir_axis_kernel<false><<<grid, block, 0, stream>>>(s2, nullptr, s1, x, y, z, 1, ty);
    const cudaError_t e = launch_fir_z<true>(out, s1, out, X, Y, Z, tz, stream);
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
    Taps ty, tz;
    if (!make_taps(taps_y, nty, &ty) || !make_taps(taps_z, ntz, &tz))
        return (int)cudaErrorInvalidValue;
    const int x = (int)X, y = (int)Y, z = (int)Z;
    const dim3 grid((unsigned)((Z + kBlockZ - 1) / kBlockZ),
                    (unsigned)((Y + kBlockY - 1) / kBlockY), (unsigned)X);
    const dim3 block(kBlockZ, kBlockY);
    fir_axis_kernel<true><<<grid, block, 0, stream>>>(image, cert, num, x, y, z, 1, ty);
    fir_axis_kernel<false><<<grid, block, 0, stream>>>(cert, nullptr, den, x, y, z, 1, ty);
    const cudaError_t e = launch_fir_z<false>(num, den, nullptr, X, Y, Z, tz, stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}
