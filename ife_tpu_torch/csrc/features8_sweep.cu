// The whole features8 pass as one line sweep along x: normalized Gaussian
// smoothing s = G*(c*f) / G*c of the image f with the clamped mask c, then
// the shared tail (|grad s|, Hessian, eigen features), masked by a select.
//
// Replaces ife_tpu/kernels/fused.py:fused_features8_sweep (kernel
// _features8_sweep_kernel) and, in its kSmoothYZ = false form,
// fused_features8_xs_stream (kernel _features8_xs_stream_kernel), whose
// input arrives already smoothed along y and z (ife_smooth_yz in
// normalized_conv.cu) and which adds only the x pass and the divide before
// the tail. Both TPU kernels swept x with a VMEM ring of input rows; here a
// block sweeps a chunk of x for one (y, z) tile with a shared-memory ring.
//
// Per input plane q a block
//   1. (kSmoothYZ) loads c*f and c on its tile extended by the y and z
//      radii plus one, and runs the y pass, then the z pass, in shared
//      memory; (otherwise) loads the pre-smoothed numerator and
//      denominator on the tile plus one;
//   2. keeps the result, on the tile plus a one-voxel halo, in a ring of
//      the last 2rx+1 planes;
// and once the ring holds planes p - rx .. p + rx, runs the x pass and the
// no-epsilon divide into a ring of the last three s planes, then emits the
// features of plane p - 1 through features8_tail.cuh, the one copy of the
// tail every stencil kernel includes. Every input voxel is loaded once per
// block (plus the halo its neighbours share), every tap is read from
// shared memory. The passes run y, z, then x, in the order and tap
// association of the plain twin (smooth_yz_plain, then the x pass of
// features8_xs_stream_plain), and the library is built without FMA
// contraction, so the kernel agrees with its twin to the bit.
//
// True faces: s is computed at clamped positions but read only at
// positions inside the volume: the tail looks its neighbours up at clamped
// indices, so at a face the phantom neighbour is s at the face itself, not
// the smoothing evaluated at a virtual position (the round-5 bug family of
// the TPU kernels). The y/z halo of the extended tile holds the clamped
// input rows, which is the ZeroFluxNeumann pad of the plain passes.
//
// What bounds it on the H100: shared-memory traffic, ~(2ry+1 + 2rz+1 +
// 2rx+1) * 2 reads per voxel, and the x ring's size, which caps the blocks
// per SM. HBM sees the image and mask once and the 8 channels written once
// (40 B per voxel, against 116 B for the staged nc + post kernels).
#include <cuda_runtime.h>

#include "features8_tail.cuh"
#include "fir.cuh"

constexpr int kSweepTileY = 14;
constexpr int kSweepTileZ = 32;
constexpr int kSweepSY = kSweepTileY + 2;  // s region: the tile + 1 halo
constexpr int kSweepSZ = kSweepTileZ + 2;
constexpr int kSweepCells = kSweepSY * kSweepSZ;
constexpr int kSweepThreads = 512;  // 256: 1.08x / 1.18x slower at sigma 0.6 / 1.2
constexpr int kSweepMaxSmem = 227 * 1024;

__device__ __forceinline__ float clamp_unit_mask(float m) {
    return m < 0.0f ? 0.0f : (m > 1.0f ? 1.0f : m);
}

// Shared memory, in floats: the x ring of numerator and denominator
// (2 * (2rx+1) * cells), the ring of three s planes, and (kSmoothYZ) the
// loaded extended plane (2 * PY * PZ) and its y pass (2 * SY * PZ).
__host__ __device__ inline size_t sweep_smem_floats(bool smooth_yz, int rx,
                                                    int ry, int rz) {
    size_t f = 2 * (size_t)(2 * rx + 1) * kSweepCells + 3 * kSweepCells;
    if (smooth_yz) {
        const size_t py = kSweepSY + 2 * ry, pz = kSweepSZ + 2 * rz;
        f += 2 * py * pz + 2 * kSweepSY * pz;
    }
    return f;
}

// x planes per block: enough that re-reading the 2rx+2 planes of overlap
// with the next chunk costs ~1/8 of the work
__host__ inline int sweep_chunk_x(long long X, int rx) {
    return (int)std::min<long long>(X, std::max(64, 16 * (rx + 1)));
}

// kSmoothYZ: a = image f, b = raw mask (clamped here to the certainty c and
// used as the output mask); y, z and x passes.
// !kSmoothYZ: a, b = G_z G_y (c*f), G_z G_y c; mask = the clamped mask; the
// x pass alone (ty, tz unused).
template <bool kSmoothYZ>
__global__ void __launch_bounds__(kSweepThreads)
features8_sweep_kernel(const float* __restrict__ a, const float* __restrict__ b,
                       const float* __restrict__ mask, float* __restrict__ out,
                       int X, int Y, int Z, int chunk_x, Taps tx, Taps ty,
                       Taps tz, StencilRecip k) {
    extern __shared__ float smem[];
    constexpr int SY = kSweepSY, SZ = kSweepSZ, NC = kSweepCells;
    const int rx = tx.r;
    const int W = 2 * rx + 1;  // x ring planes
    const int ry = kSmoothYZ ? ty.r : 0;
    const int rz = kSmoothYZ ? tz.r : 0;
    const int PY = SY + 2 * ry, PZ = SZ + 2 * rz;
    float* rn = smem;             // [W][NC] x ring, numerator
    float* rd = rn + W * NC;      // [W][NC] x ring, denominator
    float* ring = rd + W * NC;    // [3][NC] s planes
    float* pn = ring + 3 * NC;    // [PY][PZ] (kSmoothYZ)
    float* pd = pn + PY * PZ;
    float* qn = pd + PY * PZ;     // [SY][PZ] (kSmoothYZ)
    float* qd = qn + SY * PZ;

    const int z0 = blockIdx.x * kSweepTileZ;
    const int y0 = blockIdx.y * kSweepTileY;
    const int xa = blockIdx.z * chunk_x;
    const int xb = min(xa + chunk_x, X);
    const long long plane = (long long)Y * Z;
    const long long n = (long long)X * plane;
    // s planes this block needs, and the input planes (clamped) behind them
    const int p_lo = max(xa - 1, 0);
    const int p_hi = min(xb, X - 1);

    for (int q = p_lo - rx; q <= p_hi + rx; ++q) {
        const long long src = (long long)clamp_index(q, X) * plane;
        const int slot = ((q % W) + W) % W;
        float* xn = rn + slot * NC;
        float* xd = rd + slot * NC;
        if (kSmoothYZ) {
            // extended cell (i, j) is global (y0 - 1 - ry + i, z0 - 1 - rz + j)
            for (int idx = threadIdx.x; idx < PY * PZ; idx += blockDim.x) {
                const int gy = clamp_index(y0 - 1 - ry + idx / PZ, Y);
                const int gz = clamp_index(z0 - 1 - rz + idx % PZ, Z);
                const long long off = src + (long long)gy * Z + gz;
                const float c = clamp_unit_mask(__ldg(b + off));
                pn[idx] = __ldg(a + off) * c;  // c*f rounded, as plain
                pd[idx] = c;
            }
            __syncthreads();
            for (int idx = threadIdx.x; idx < SY * PZ; idx += blockDim.x) {
                const int i = idx / PZ, j = idx % PZ;
                float an = 0.0f, ad = 0.0f;
                for (int t = 0; t <= 2 * ry; ++t) {
                    const int e = (i + t) * PZ + j;
                    an = t == 0 ? ty.t[0] * pn[e] : an + ty.t[t] * pn[e];
                    ad = t == 0 ? ty.t[0] * pd[e] : ad + ty.t[t] * pd[e];
                }
                qn[idx] = an;
                qd[idx] = ad;
            }
            __syncthreads();
            for (int idx = threadIdx.x; idx < NC; idx += blockDim.x) {
                const int i = idx / SZ, j = idx % SZ;
                float an = 0.0f, ad = 0.0f;
                for (int t = 0; t <= 2 * rz; ++t) {
                    const int e = i * PZ + j + t;
                    an = t == 0 ? tz.t[0] * qn[e] : an + tz.t[t] * qn[e];
                    ad = t == 0 ? tz.t[0] * qd[e] : ad + tz.t[t] * qd[e];
                }
                xn[idx] = an;
                xd[idx] = ad;
            }
        } else {
            for (int idx = threadIdx.x; idx < NC; idx += blockDim.x) {
                const int gy = clamp_index(y0 - 1 + idx / SZ, Y);
                const int gz = clamp_index(z0 - 1 + idx % SZ, Z);
                const long long off = src + (long long)gy * Z + gz;
                xn[idx] = __ldg(a + off);
                xd[idx] = __ldg(b + off);
            }
        }
        __syncthreads();

        const int p = q - rx;  // the ring now holds planes p - rx .. p + rx
        if (p < p_lo) continue;
        float* sp = ring + (p % 3) * NC;
        const int first = ((p - rx) % W + W) % W;  // ring slot of plane p - rx
        for (int idx = threadIdx.x; idx < NC; idx += blockDim.x) {
            float an = 0.0f, ad = 0.0f;
            for (int t = 0, sl = first; t < W; ++t, sl = sl + 1 == W ? 0 : sl + 1) {
                const int e = sl * NC + idx;
                an = t == 0 ? tx.t[0] * rn[e] : an + tx.t[t] * rn[e];
                ad = t == 0 ? tx.t[0] * rd[e] : ad + tx.t[t] * rd[e];
            }
            sp[idx] = an / ad;  // no epsilon: 0/0 = NaN off the support
        }
        __syncthreads();

        // emit plane p - 1 (its x + 1 neighbour is p), and at the last true
        // plane also plane p itself (x + 1 clamps to p)
        for (int x = max(p - 1, xa); x <= (p == X - 1 ? p : p - 1); ++x) {
            if (x >= xb) break;
            const float* s3[3] = {
                ring + (clamp_index(x - 1, X) % 3) * NC,
                ring + (x % 3) * NC,
                ring + (clamp_index(x + 1, X) % 3) * NC};
            for (int idx = threadIdx.x; idx < kSweepTileY * kSweepTileZ;
                 idx += blockDim.x) {
                const int y = y0 + idx / kSweepTileZ;
                const int z = z0 + idx % kSweepTileZ;
                if (y >= Y || z >= Z) continue;
                // s region rows/columns of the clamped neighbours
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
                const bool inside =
                    (kSmoothYZ ? clamp_unit_mask(m) : m) != 0.0f;
                out[i] = inside ? v[1][1][1] : 0.0f;
                out[n + i] = inside ? gm : 0.0f;
#pragma unroll
                for (int c = 0; c < 6; ++c)
                    out[(c + 2) * n + i] = inside ? f[c] : 0.0f;
            }
        }
        // the next plane overwrites a ring slot the x pass read and, two
        // planes on, the s slot the tail read: the syncs after its loads
        // order those writes after these reads
    }
}

template <bool kSmoothYZ>
static int launch_sweep(const float* a, const float* b, const float* mask,
                        float* out, long long X, long long Y, long long Z,
                        const Taps& tx, const Taps& ty, const Taps& tz,
                        const StencilRecip& k, cudaStream_t stream) {
    const size_t smem =
        sweep_smem_floats(kSmoothYZ, tx.r, ty.r, tz.r) * sizeof(float);
    if (smem > (size_t)kSweepMaxSmem) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            features8_sweep_kernel<kSmoothYZ>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int chunk = sweep_chunk_x(X, tx.r);
    const dim3 grid((unsigned)((Z + kSweepTileZ - 1) / kSweepTileZ),
                    (unsigned)((Y + kSweepTileY - 1) / kSweepTileY),
                    (unsigned)((X + chunk - 1) / chunk));
    features8_sweep_kernel<kSmoothYZ><<<grid, kSweepThreads, smem, stream>>>(
        a, b, mask, out, (int)X, (int)Y, (int)Z, chunk, tx, ty, tz, k);
    return (int)cudaGetLastError();
}

// image, mask: contiguous (X, Y, Z) float32 (the mask raw, clamped to [0, 1]
// here); out: contiguous (8, X, Y, Z); taps_*: host arrays of 2r+1 floats.
extern "C" int ife_features8_sweep(const float* image, const float* mask,
                                   float* out, long long X, long long Y,
                                   long long Z,
                                   const float* taps_x, long long ntx,
                                   const float* taps_y, long long nty,
                                   const float* taps_z, long long ntz,
                                   float r2x, float r2y, float r2z,
                                   float rxx, float ryy, float rzz,
                                   cudaStream_t stream) {
    Taps tx, ty, tz;
    if (!make_taps(taps_x, ntx, &tx) || !make_taps(taps_y, nty, &ty)
        || !make_taps(taps_z, ntz, &tz))
        return (int)cudaErrorInvalidValue;
    const StencilRecip k{r2x, r2y, r2z, rxx, ryy, rzz};
    return launch_sweep<true>(image, mask, mask, out, X, Y, Z, tx, ty, tz, k,
                              stream);
}

// num_yz, den_yz: the y/z-smoothed numerator and denominator; mask: the
// clamped {0, 1} mask; all contiguous (X, Y, Z) float32; out: (8, X, Y, Z).
extern "C" int ife_features8_xs_stream(const float* num_yz,
                                       const float* den_yz, const float* mask,
                                       float* out, long long X, long long Y,
                                       long long Z,
                                       const float* taps_x, long long ntx,
                                       float r2x, float r2y, float r2z,
                                       float rxx, float ryy, float rzz,
                                       cudaStream_t stream) {
    Taps tx, unit;
    const float one = 1.0f;
    if (!make_taps(taps_x, ntx, &tx) || !make_taps(&one, 1, &unit))
        return (int)cudaErrorInvalidValue;
    const StencilRecip k{r2x, r2y, r2z, rxx, ryy, rzz};
    return launch_sweep<false>(num_yz, den_yz, mask, out, X, Y, Z, tx, unit,
                               unit, k, stream);
}
