// The last step of every kernel that holds smoothed planes in shared memory
// (a ring of three while sweeping x: features8_sweep.cu,
// features8_ys_multi.cu; a block's window of planes: features8_tap.cu's xs
// kernel; a ring of three rows while sweeping y: its tap kernel): emit the
// eight masked channels of plane x on the block's (y, z) tile, or of row y on
// its (x, z) tile, through the one tail of features8_tail.cuh.
//
// A ring holds s on the tile plus a one-voxel halo: plane p lives in slot
// p % 3, and cell (i, j) of a plane is s at the CLAMPED position
// (clamp(y0 - 1 + i), clamp(z0 - 1 + j)). The tail's neighbours are looked up
// at clamped indices in all three axes, so at a true face the phantom
// neighbour is s at the face itself; a halo cell that stands for a position
// outside the volume is never read. A voxel outside the mask gets its eight
// zeros without the tail being run: every channel is masked by a select, so
// the bits are the same, and a warp with no voxel inside skips the tail.
#pragma once

#include "features8_tail.cuh"
#include "fir.cuh"

__device__ __forceinline__ float clamp_unit_mask(float m) {
    return m < 0.0f ? 0.0f : (m > 1.0f ? 1.0f : m);
}

// The faces at which the stencil's phantom neighbour clamps to the smoothed
// field itself: (0, X - 1, 0, Y - 1) for a whole volume. For a halo-extended
// shard block (ife_tpu/parallel/features.py:_features8_block_sweep, the
// clamp_ref of ife_tpu/kernels/fused.py:_features8_sweep_kernel) they are the
// kept core's faces on the sides that are true volume faces and -/+2^30 on
// the sides where the halo holds a neighbour's real data, which the stencil
// then reads as data. A row at or below x_lo takes itself as its x - 1
// neighbour, a row at or above x_hi itself as its x + 1 neighbour; y alike.
// The array's own ends always clamp.
struct FaceClamps {
    int x_lo, x_hi, y_lo, y_hi;
};

__host__ __device__ inline FaceClamps whole_volume_faces(int X, int Y) {
    return FaceClamps{0, X - 1, 0, Y - 1};
}

__device__ __forceinline__ int lower_neighbour(int i, int lo) {
    return i <= lo ? i : max(i - 1, 0);
}

__device__ __forceinline__ int upper_neighbour(int i, int hi, int n) {
    return i >= hi ? i : min(i + 1, n - 1);
}

// The tail at voxel i (its offset in a channel of n voxels) from its
// neighbourhood v, into the eight channels of out.
__device__ __forceinline__ void store_features8(const float (&v)[3][3][3],
                                                const StencilRecip& k,
                                                float* __restrict__ out,
                                                long long n, long long i) {
    float gm, h[6], f[6];
    features8_tail(v, k, gm, h, f);
    out[i] = v[1][1][1];
    out[n + i] = gm;
#pragma unroll
    for (int c = 0; c < 6; ++c) out[(c + 2) * n + i] = f[c];
}

// Emit plane x from the three planes s3 = {s at the x - 1 neighbour, s at x,
// s at the x + 1 neighbour} (the caller resolved the x faces), each
// [(kTileY + 2) * (kTileZ + 2)] floats: cell (i, j) is s at the CLAMPED
// position (clamp(y0 - 1 + i), clamp(z0 - 1 + j)). mask: the (X, Y, Z) mask,
// clamped to [0, 1] first when kClampMask; out: (8, X, Y, Z).
template <int kTileY, int kTileZ, bool kClampMask>
__device__ __forceinline__ void emit_features8_planes(
    const float* const (&s3)[3], int x, int X, int Y, int Z, int y0, int z0,
    const float* __restrict__ mask, float* __restrict__ out,
    const StencilRecip& k, int y_lo, int y_hi) {
    constexpr int SZ = kTileZ + 2;
    const long long plane = (long long)Y * Z;
    const long long n = (long long)X * plane;
    for (int idx = threadIdx.x; idx < kTileY * kTileZ; idx += blockDim.x) {
        const int y = y0 + idx / kTileZ;
        const int z = z0 + idx % kTileZ;
        if (y >= Y || z >= Z) continue;
        const long long i = x * plane + (long long)y * Z + z;
        const float m = __ldg(mask + i);
        if ((kClampMask ? clamp_unit_mask(m) : m) == 0.0f) {
            // outside the mask every channel is 0 whatever s is: the tail is
            // not run (a warp with no voxel inside skips it altogether)
#pragma unroll
            for (int c = 0; c < 8; ++c) out[c * n + i] = 0.0f;
            continue;
        }
        // rows/columns of the clamped neighbours
        const int iy[3] = {lower_neighbour(y, y_lo) - y0 + 1, y - y0 + 1,
                           upper_neighbour(y, y_hi, Y) - y0 + 1};
        const int iz[3] = {clamp_index(z - 1, Z) - z0 + 1, z - z0 + 1,
                           clamp_index(z + 1, Z) - z0 + 1};
        float v[3][3][3];
#pragma unroll
        for (int da = 0; da < 3; ++da)
#pragma unroll
            for (int db = 0; db < 3; ++db)
#pragma unroll
                for (int dc = 0; dc < 3; ++dc) {
                    if (da != 1 && db != 1 && dc != 1) continue;
                    v[da][db][dc] = s3[da][iy[db] * SZ + iz[dc]];
                }
        store_features8(v, k, out, n, i);
    }
}

// Emit row y of an (x, z) tile from the three rows s3 = {s at the y - 1
// neighbour, s at y, s at the y + 1 neighbour} (the caller resolved the y
// faces), each [(kTileX + 2) * (kTileZ + 2)] floats: cell (i, j) is s at the
// CLAMPED position (clamp(x0 - 1 + i), clamp(z0 - 1 + j)). The row sweep of
// features8_tap.cu emits through it; x and z clamp at the array's faces.
template <int kTileX, int kTileZ, bool kClampMask>
__device__ __forceinline__ void emit_features8_row(
    const float* const (&s3)[3], int y, int X, int Y, int Z, int x0, int z0,
    const float* __restrict__ mask, float* __restrict__ out,
    const StencilRecip& k) {
    constexpr int SZ = kTileZ + 2;
    const long long plane = (long long)Y * Z;
    const long long n = (long long)X * plane;
    for (int idx = threadIdx.x; idx < kTileX * kTileZ; idx += blockDim.x) {
        const int x = x0 + idx / kTileZ;
        const int z = z0 + idx % kTileZ;
        if (x >= X || z >= Z) continue;
        const long long i = x * plane + (long long)y * Z + z;
        const float m = __ldg(mask + i);
        if ((kClampMask ? clamp_unit_mask(m) : m) == 0.0f) {
#pragma unroll
            for (int c = 0; c < 8; ++c) out[c * n + i] = 0.0f;
            continue;
        }
        const int ix[3] = {clamp_index(x - 1, X) - x0 + 1, x - x0 + 1,
                           clamp_index(x + 1, X) - x0 + 1};
        const int iz[3] = {clamp_index(z - 1, Z) - z0 + 1, z - z0 + 1,
                           clamp_index(z + 1, Z) - z0 + 1};
        float v[3][3][3];
#pragma unroll
        for (int da = 0; da < 3; ++da)
#pragma unroll
            for (int db = 0; db < 3; ++db)
#pragma unroll
                for (int dc = 0; dc < 3; ++dc) {
                    if (da != 1 && db != 1 && dc != 1) continue;
                    v[da][db][dc] = s3[db][ix[da] * SZ + iz[dc]];
                }
        store_features8(v, k, out, n, i);
    }
}

// ring: [3][(kTileY + 2) * (kTileZ + 2)] floats; the planes of x and of its
// two neighbours under `fc` must be in their slots.
template <int kTileY, int kTileZ, bool kClampMask>
__device__ __forceinline__ void emit_features8_plane(
    const float* ring, int x, int X, int Y, int Z, int y0, int z0,
    const float* __restrict__ mask, float* __restrict__ out,
    const StencilRecip& k, const FaceClamps& fc) {
    constexpr int NC = (kTileY + 2) * (kTileZ + 2);
    const float* const s3[3] = {
        ring + (lower_neighbour(x, fc.x_lo) % 3) * NC, ring + (x % 3) * NC,
        ring + (upper_neighbour(x, fc.x_hi, X) % 3) * NC};
    emit_features8_planes<kTileY, kTileZ, kClampMask>(
        s3, x, X, Y, Z, y0, z0, mask, out, k, fc.y_lo, fc.y_hi);
}

// a whole volume: the true faces are the array's
template <int kTileY, int kTileZ, bool kClampMask>
__device__ __forceinline__ void emit_features8_plane(
    const float* ring, int x, int X, int Y, int Z, int y0, int z0,
    const float* __restrict__ mask, float* __restrict__ out,
    const StencilRecip& k) {
    emit_features8_plane<kTileY, kTileZ, kClampMask>(
        ring, x, X, Y, Z, y0, z0, mask, out, k, whole_volume_faces(X, Y));
}
