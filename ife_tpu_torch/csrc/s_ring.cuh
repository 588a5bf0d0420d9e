// The last step of every kernel that sweeps x with a ring of three smoothed
// planes in shared memory (features8_sweep.cu, features8_ys_multi.cu): emit
// the eight masked channels of plane x on the block's (y, z) tile through
// the one tail of features8_tail.cuh.
//
// The ring holds s on the tile plus a one-voxel halo: plane p lives in slot
// p % 3, and cell (i, j) of a plane is s at the CLAMPED position
// (clamp(y0 - 1 + i), clamp(z0 - 1 + j)). The tail's neighbours are looked up
// at clamped indices in all three axes, so at a true face the phantom
// neighbour is s at the face itself; a halo cell that stands for a position
// outside the volume is never read.
#pragma once

#include "features8_tail.cuh"
#include "fir.cuh"

__device__ __forceinline__ float clamp_unit_mask(float m) {
    return m < 0.0f ? 0.0f : (m > 1.0f ? 1.0f : m);
}

// ring: [3][(kTileY + 2) * (kTileZ + 2)] floats; planes x - 1, x, x + 1
// (clamped to the volume) must be in their slots. mask: the (X, Y, Z) mask,
// clamped to [0, 1] first when kClampMask; out: (8, X, Y, Z).
template <int kTileY, int kTileZ, bool kClampMask>
__device__ __forceinline__ void emit_features8_plane(
    const float* ring, int x, int X, int Y, int Z, int y0, int z0,
    const float* __restrict__ mask, float* __restrict__ out,
    const StencilRecip& k) {
    constexpr int SZ = kTileZ + 2;
    constexpr int NC = (kTileY + 2) * SZ;
    const long long plane = (long long)Y * Z;
    const long long n = (long long)X * plane;
    const float* s3[3] = {ring + (clamp_index(x - 1, X) % 3) * NC,
                          ring + (x % 3) * NC,
                          ring + (clamp_index(x + 1, X) % 3) * NC};
    for (int idx = threadIdx.x; idx < kTileY * kTileZ; idx += blockDim.x) {
        const int y = y0 + idx / kTileZ;
        const int z = z0 + idx % kTileZ;
        if (y >= Y || z >= Z) continue;
        // ring rows/columns of the clamped neighbours
        const int iy[3] = {clamp_index(y - 1, Y) - y0 + 1, y - y0 + 1,
                           clamp_index(y + 1, Y) - y0 + 1};
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
        float gm, h[6], f[6];
        features8_tail(v, k, gm, h, f);
        const long long i = x * plane + (long long)y * Z + z;
        const float m = __ldg(mask + i);
        const bool inside = (kClampMask ? clamp_unit_mask(m) : m) != 0.0f;
        out[i] = inside ? v[1][1][1] : 0.0f;
        out[n + i] = inside ? gm : 0.0f;
#pragma unroll
        for (int c = 0; c < 6; ++c)
            out[(c + 2) * n + i] = inside ? f[c] : 0.0f;
    }
}
