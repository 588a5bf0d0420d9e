// The windowed features8 kernels: every thread block owns a core of the
// volume, builds the halo window it needs in shared memory, and depends on
// no other block.
//
// ife_features8_tap (features8_tap_kernel) replaces
// ife_tpu/kernels/fused.py:fused_features8_tap (kernel _features8_tap_kernel):
// the whole features8 pass in one launch from the raw image f and mask. For
// the numerator c*f and the denominator c (c the mask clamped to [0, 1]), one
// after the other, a block
//   1. loads the field on its core extended by (r + 1) voxels per side and
//      axis, at edge-clamped positions (the ZeroFluxNeumann pad);
//   2. runs the separable Gaussian FIR in the TPU kernel's order, x, then y,
//      then z, each pass shrinking the window to the extent the next needs;
// then divides (no epsilon) into s on the core plus a one-voxel halo and
// emits the eight masked channels through the one tail (s_ring.cuh,
// features8_tail.cuh). The mask is read from the mask input itself: there is
// no third input.
//
// ife_features8_xs (features8_xs_kernel) replaces
// ife_tpu/kernels/fused.py:fused_features8_xs (kernel _features8_xs_kernel):
// the numerator and denominator arrive smoothed along y and z (ife_smooth_yz
// in normalized_conv.cu, where ife_tpu ran XLA einsums); a block loads a
// window of bx + 2 + 2 rx planes of its (y, z) tile plus one, runs the x FIR
// of both fields in one walk, divides, and emits through the same tail.
//
// What differs from the TPU kernels. They tiled (x, y) and kept all of Z in
// VMEM; a thread block has 227 KB of shared memory, so all three axes are
// tiled and the z halo is part of the window. They re-clamped the smoothed
// phantom rows and columns (s(-1) := s(0)) by global index after smoothing
// window positions outside the volume; here the tail looks its neighbours up
// at clamped indices, so a window cell that stands for a position outside the
// volume is smoothed but never read, which is the same clamp. The TPU
// kernels' lane padding of Z (and the limitation it brought for Z % 128 != 0)
// has no counterpart: the kernels run on the exact shape.
//
// The taps are applied in tap order through fir_walk (fir.cuh), in the pass
// order of the plain twins, and the library is built without FMA contraction:
// each kernel equals its twin to the bit.
//
// What bounds them on the H100: the tap kernel by shared-memory traffic and
// by the halo it re-reads, (8 + 2 + 2r)^2 (32 + 2 + 2r) / (8 * 8 * 32) window
// cells per core voxel and field (5.0 at r = 3, 10.9 at r = 6), served by L2;
// the xs kernel by HBM bytes plus an x halo of (16 + 2 + 2 rx) / 16. HBM sees
// the inputs once per block that needs them and the 8 channels written once.
#include <cuda_runtime.h>

#include "features8_tail.cuh"
#include "fir.cuh"
#include "s_ring.cuh"

constexpr int kWinTileY = 8;
constexpr int kWinTileZ = 32;
constexpr int kWinSY = kWinTileY + 2;  // s region: the tile + 1 halo
constexpr int kWinSZ = kWinTileZ + 2;
constexpr int kWinCells = kWinSY * kWinSZ;
constexpr int kWinThreads = 256;
constexpr int kWinMaxSmem = 227 * 1024;

// Emit the planes [xa, xb) of a block whose s window holds plane x0w + i in
// s + i * kWinCells (every plane clamp(x +- 1) of an emitted x is inside it).
template <bool kClampMask>
__device__ __forceinline__ void window_emit(const float* s, int x0w, int xa,
                                            int xb, int X, int Y, int Z, int y0,
                                            int z0, const float* mask,
                                            float* out, const StencilRecip& k) {
    for (int x = xa; x < xb; ++x) {
        const float* const s3[3] = {
            s + (clamp_index(x - 1, X) - x0w) * kWinCells,
            s + (x - x0w) * kWinCells,
            s + (clamp_index(x + 1, X) - x0w) * kWinCells};
        emit_features8_planes<kWinTileY, kWinTileZ, kClampMask>(
            s3, x, X, Y, Z, y0, z0, mask, out, k, 0, Y - 1);
    }
}

// ---------------------------------------------------------------------------
// tap: image + mask -> 8 channels, x, y, z FIR in the block
// ---------------------------------------------------------------------------

constexpr int kTapTileX = 8;
constexpr int kTapSX = kTapTileX + 2;
constexpr int kTapS = kTapSX * kWinCells;  // the s region of a block

// Shared memory, in floats: the raw window (reused by the y pass's output),
// the x pass's output, and the smoothed numerator and denominator.
__host__ __device__ inline size_t tap_smem_floats(int rx, int ry, int rz) {
    const size_t wy = kWinSY + 2 * ry, wz = kWinSZ + 2 * rz;
    return (size_t)(kTapSX + 2 * rx) * wy * wz + (size_t)kTapSX * wy * wz
        + 2 * (size_t)kTapS;
}

// kCopyFloor: the roofline probe of ife_tpu/kernels/fused.py:638-645
// (_features8_tap_kernel's variant="copyfloor"). The block loads both fields'
// windows at the scale's radii exactly as the tap does, skips the FIR passes,
// the divide and the tail, and writes channel k of its core as c + k (k even)
// or c*f + k (k odd) from the loaded windows: the floor of the tap's loads
// and stores at that sigma. The shared memory, and so the blocks an SM
// holds, is the tap's.
template <bool kCopyFloor>
__global__ void __launch_bounds__(kWinThreads)
features8_tap_kernel(const float* __restrict__ image,
                     const float* __restrict__ mask, float* __restrict__ out,
                     int X, int Y, int Z, Taps tx, Taps ty, Taps tz,
                     StencilRecip k) {
    extern __shared__ float smem[];
    const int rx = tx.r, ry = ty.r, rz = tz.r;
    const int WX = kTapSX + 2 * rx, WY = kWinSY + 2 * ry, WZ = kWinSZ + 2 * rz;
    const int WYZ = WY * WZ;
    float* win = smem;                 // [WX][WY][WZ] raw, then [SX][SY][WZ]
    float* xp = win + WX * WYZ;        // [SX][WY][WZ] after the x pass
    float* sm = xp + kTapSX * WYZ;     // [2][SX][SY][SZ] num, den after z

    const int z0 = blockIdx.x * kWinTileZ;
    const int y0 = blockIdx.y * kWinTileY;
    const int x0 = blockIdx.z * kTapTileX;
    const long long plane = (long long)Y * Z;

    for (int field = 0; field < 2; ++field) {
        // window cell (i, j, l) is (x0 - 1 - rx + i, y0 - 1 - ry + j,
        // z0 - 1 - rz + l), clamped
        for (int idx = threadIdx.x; idx < WX * WYZ; idx += blockDim.x) {
            const int i = idx / WYZ, rem = idx % WYZ;
            const int gx = clamp_index(x0 - 1 - rx + i, X);
            const int gy = clamp_index(y0 - 1 - ry + rem / WZ, Y);
            const int gz = clamp_index(z0 - 1 - rz + rem % WZ, Z);
            const long long off = gx * plane + (long long)gy * Z + gz;
            const float c = clamp_unit_mask(__ldg(mask + off));
            win[idx] = field == 0 ? __ldg(image + off) * c : c;
        }
        __syncthreads();
        if (kCopyFloor) {
            // field's core cells, [TileX][TileY][TileZ], into its s region
            float* dst = sm + field * kTapS;
            for (int idx = threadIdx.x; idx < kTapTileX * kWinTileY * kWinTileZ;
                 idx += blockDim.x) {
                const int i = idx / (kWinTileY * kWinTileZ);
                const int j = idx / kWinTileZ % kWinTileY, l = idx % kWinTileZ;
                dst[idx] = win[((i + 1 + rx) * WY + j + 1 + ry) * WZ + l + 1 + rz];
            }
            __syncthreads();  // the next field's load overwrites win
            continue;
        }
        // x pass: the SX planes of column (j, l) from one walk
        for (int idx = threadIdx.x; idx < WYZ; idx += blockDim.x) {
            const float* const col[1] = {win + idx};
            float acc[1][kTapSX];
            fir_walk<kTapSX, 1>(col, WYZ, tx, acc);
#pragma unroll
            for (int u = 0; u < kTapSX; ++u) xp[u * WYZ + idx] = acc[0][u];
        }
        __syncthreads();
        // y pass: the SY rows of column (i, l), into the raw window's space
        for (int idx = threadIdx.x; idx < kTapSX * WZ; idx += blockDim.x) {
            const int i = idx / WZ, l = idx % WZ;
            const float* const col[1] = {xp + i * WYZ + l};
            float acc[1][kWinSY];
            fir_walk<kWinSY, 1>(col, WZ, ty, acc);
#pragma unroll
            for (int u = 0; u < kWinSY; ++u)
                win[(i * kWinSY + u) * WZ + l] = acc[0][u];
        }
        __syncthreads();
        // z pass
        float* dst = sm + field * kTapS;
        for (int idx = threadIdx.x; idx < kTapS; idx += blockDim.x) {
            const float* src = win + (idx / kWinSZ) * WZ + idx % kWinSZ;
            float a = 0.0f;
            for (int t = 0; t <= 2 * rz; ++t)
                a = t == 0 ? tz.t[0] * src[0] : a + tz.t[t] * src[t];
            dst[idx] = a;
        }
        __syncthreads();  // the next field's load overwrites win
    }
    if (kCopyFloor) {
        const long long n = (long long)X * plane;
        for (int idx = threadIdx.x; idx < kTapTileX * kWinTileY * kWinTileZ;
             idx += blockDim.x) {
            const int x = x0 + idx / (kWinTileY * kWinTileZ);
            const int y = y0 + idx / kWinTileZ % kWinTileY;
            const int z = z0 + idx % kWinTileZ;
            if (x >= X || y >= Y || z >= Z) continue;
            const long long off = x * plane + (long long)y * Z + z;
#pragma unroll
            for (int c = 0; c < 8; ++c)
                out[c * n + off] = sm[(c & 1) ? idx : kTapS + idx] + (float)c;
        }
        return;
    }
    for (int idx = threadIdx.x; idx < kTapS; idx += blockDim.x)
        sm[idx] = sm[idx] / sm[kTapS + idx];  // no epsilon: 0/0 = NaN
    __syncthreads();
    window_emit<true>(sm, x0 - 1, x0, min(x0 + kTapTileX, X), X, Y, Z, y0, z0,
                      mask, out, k);
}

// image, mask: contiguous (X, Y, Z) float32 (the mask raw, clamped to [0, 1]
// here); out: contiguous (8, X, Y, Z); taps_*: host arrays of 2r+1 floats;
// copy_floor: 1 for the copy-floor probe, 0 for the features.
extern "C" int ife_features8_tap(const float* image, const float* mask,
                                 float* out, long long X, long long Y,
                                 long long Z,
                                 const float* taps_x, long long ntx,
                                 const float* taps_y, long long nty,
                                 const float* taps_z, long long ntz,
                                 float r2x, float r2y, float r2z,
                                 float rxx, float ryy, float rzz,
                                 long long copy_floor, cudaStream_t stream) {
    Taps tx, ty, tz;
    if (!make_taps(taps_x, ntx, &tx) || !make_taps(taps_y, nty, &ty)
        || !make_taps(taps_z, ntz, &tz))
        return (int)cudaErrorInvalidValue;
    const size_t smem = tap_smem_floats(tx.r, ty.r, tz.r) * sizeof(float);
    if (smem > (size_t)kWinMaxSmem) return (int)cudaErrorInvalidValue;
    if (copy_floor != 0 && copy_floor != 1) return (int)cudaErrorInvalidValue;
    const auto kernel = copy_floor ? &features8_tap_kernel<true>
                                   : &features8_tap_kernel<false>;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const long long gx = (X + kTapTileX - 1) / kTapTileX;
    if (gx > 65535) return (int)cudaErrorInvalidValue;
    const StencilRecip k{r2x, r2y, r2z, rxx, ryy, rzz};
    const dim3 grid((unsigned)((Z + kWinTileZ - 1) / kWinTileZ),
                    (unsigned)((Y + kWinTileY - 1) / kWinTileY), (unsigned)gx);
    kernel<<<grid, kWinThreads, smem, stream>>>(
        image, mask, out, (int)X, (int)Y, (int)Z, tx, ty, tz, k);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// xs: y/z-smoothed numerator and denominator + mask -> 8 channels, x FIR in
// the block
// ---------------------------------------------------------------------------

constexpr int kXsTileX = 16;
constexpr int kXsSX = kXsTileX + 2;

// Shared memory, in floats: the two x windows and the s region.
__host__ __device__ inline size_t xs_smem_floats(int rx) {
    return (2 * (size_t)(kXsSX + 2 * rx) + kXsSX) * kWinCells;
}

__global__ void __launch_bounds__(kWinThreads)
features8_xs_kernel(const float* __restrict__ num, const float* __restrict__ den,
                    const float* __restrict__ mask, float* __restrict__ out,
                    int X, int Y, int Z, Taps tx, StencilRecip k) {
    extern __shared__ float smem[];
    const int rx = tx.r;
    const int WX = kXsSX + 2 * rx;
    float* wn = smem;                  // [WX][cells]
    float* wd = wn + WX * kWinCells;
    float* s = wd + WX * kWinCells;    // [SX][cells]

    const int z0 = blockIdx.x * kWinTileZ;
    const int y0 = blockIdx.y * kWinTileY;
    const int x0 = blockIdx.z * kXsTileX;
    const long long plane = (long long)Y * Z;

    // window cell (i, c) is plane x0 - 1 - rx + i, tile position c, clamped
    for (int idx = threadIdx.x; idx < WX * kWinCells; idx += blockDim.x) {
        const int c = idx % kWinCells;
        const int gx = clamp_index(x0 - 1 - rx + idx / kWinCells, X);
        const int gy = clamp_index(y0 - 1 + c / kWinSZ, Y);
        const int gz = clamp_index(z0 - 1 + c % kWinSZ, Z);
        const long long off = gx * plane + (long long)gy * Z + gz;
        wn[idx] = __ldg(num + off);
        wd[idx] = __ldg(den + off);
    }
    __syncthreads();
    for (int c = threadIdx.x; c < kWinCells; c += blockDim.x) {
        const float* const col[2] = {wn + c, wd + c};
        float acc[2][kXsSX];
        fir_walk<kXsSX, 2>(col, kWinCells, tx, acc);
#pragma unroll
        for (int u = 0; u < kXsSX; ++u)  // no epsilon: 0/0 = NaN off the support
            s[u * kWinCells + c] = acc[0][u] / acc[1][u];
    }
    __syncthreads();
    window_emit<false>(s, x0 - 1, x0, min(x0 + kXsTileX, X), X, Y, Z, y0, z0,
                       mask, out, k);
}

// num_yz, den_yz: the y/z-smoothed numerator and denominator; mask: the
// clamped {0, 1} mask; all contiguous (X, Y, Z) float32; out: (8, X, Y, Z).
extern "C" int ife_features8_xs(const float* num_yz, const float* den_yz,
                                const float* mask, float* out, long long X,
                                long long Y, long long Z,
                                const float* taps_x, long long ntx,
                                float r2x, float r2y, float r2z,
                                float rxx, float ryy, float rzz,
                                cudaStream_t stream) {
    Taps tx;
    if (!make_taps(taps_x, ntx, &tx)) return (int)cudaErrorInvalidValue;
    const size_t smem = xs_smem_floats(tx.r) * sizeof(float);
    if (smem > (size_t)kWinMaxSmem) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            features8_xs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const long long gx = (X + kXsTileX - 1) / kXsTileX;
    if (gx > 65535) return (int)cudaErrorInvalidValue;
    const StencilRecip k{r2x, r2y, r2z, rxx, ryy, rzz};
    const dim3 grid((unsigned)((Z + kWinTileZ - 1) / kWinTileZ),
                    (unsigned)((Y + kWinTileY - 1) / kWinTileY), (unsigned)gx);
    features8_xs_kernel<<<grid, kWinThreads, smem, stream>>>(
        num_yz, den_yz, mask, out, (int)X, (int)Y, (int)Z, tx, k);
    return (int)cudaGetLastError();
}
