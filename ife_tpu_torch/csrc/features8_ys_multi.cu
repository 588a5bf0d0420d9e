// The last stage of the multi-scale features8 pass, all S scales in one
// launch: from the numerator and denominator of each scale already smoothed
// along x and z, the y Gaussian of both, the no-epsilon divide
// s = G_y num / G_y den, and the shared tail (|grad s|, Hessian, eigen
// features), masked by a select.
//
// Replaces ife_tpu/kernels/fused.py:fused_features8_ys_multi (kernel
// _features8_ys_multi_kernel). The TPU kernel did the y Gaussian as a banded
// matrix product on the MXU inside its body, one full (Y, Z) row of x per grid
// step, with the edge clamp folded into the band matrix. Here the y Gaussian
// is a tap-ordered FIR over shared memory, in this kernel's own code:
// out[y] = sum_k t[k] * in[clamp(y + k - r)], the same numbers as a row of
// that band matrix times the column, in the association of the plain twin
// (ops/stencil.py gaussian_smooth_axis), so the kernel equals its twin to the
// bit (the library is built without FMA contraction).
//
// A block owns one scale (blockIdx.z carries scale and x chunk), a (y, z)
// tile of 30 x 32 voxels and a chunk of x, and sweeps x. Per plane p it
//   1. loads num and den on the tile plus a one-voxel halo, extended by the y
//      radius, at clamped positions (the ZeroFluxNeumann pad of the y pass);
//   2. runs the y FIR and the divide for the 32 x 34 cells of the tile plus
//      halo into a ring of three s planes. Each thread makes four
//      consecutive y outputs of one z column from one walk over the 2r + 4
//      inputs they share (fir_walk in fir.cuh), so an input leaves shared
//      memory once for four outputs, each still summed in tap order;
//   3. emits the features of plane p - 1 through s_ring.cuh (the one tail of
//      features8_tail.cuh). The first and last plane of the volume stand in
//      for their missing x neighbours: the tail clamps x as it clamps y and z,
//      to the smoothed field, never to a smoothing at a virtual position.
//
// The y halo: a 30-row tile with ry = 28 reads (32 + 56) / 30 = 2.9 times
// its input rows, a full-Y strip would read each once. The strip needs
// 5 * Y * (TZ + 2) floats of shared memory (348 KB at Y = 512, TZ = 32: over a
// block's 227 KB; 102 KB at TZ = 8, with 40-byte runs along z), caps Y, and
// leaves one or two blocks on an SM. The tile keeps the runs along z at 136
// bytes and several blocks per SM; its re-reads are of rows a neighbouring
// block loads at about the same time, so L2 serves most of them, and the
// inputs are 2 of the 10 volumes a scale moves.
//
// What bounds it on the H100: not HBM. The bytes (2 inputs and 8 outputs per
// scale, the mask) are a third of its time at 512^3; the rest is arithmetic
// and address work in the SMs: per cell the FIR's 2 * (2r + 1) multiplies and adds
// (unfused, to match the twin), the index arithmetic of the clamped loads,
// and the tail, in three phases a plane separated by barriers.
#include <cuda_runtime.h>

#include "features8_tail.cuh"
#include "fir.cuh"
#include "s_ring.cuh"

constexpr int kYsTileY = 30;
constexpr int kYsTileZ = 32;
constexpr int kYsSY = kYsTileY + 2;  // s region: the tile + 1 halo
constexpr int kYsSZ = kYsTileZ + 2;
constexpr int kYsCells = kYsSY * kYsSZ;
constexpr int kYsRun = 4;  // consecutive y outputs per thread; divides kYsSY
// 272 FIR items a plane: one round of 288 threads. 320 threads (the tile's
// 960 voxels in three rounds of the tail) measured 4% slower at 512^3, a
// 62-row tile, 8 outputs a thread or a 14-row tile 0-10% slower: the time is
// nearly flat in the tiling.
constexpr int kYsThreads = 288;
constexpr int kYsMaxSmem = 227 * 1024;
constexpr int kYsChunkX = 64;  // two planes of overlap per chunk: 3%

struct YsScales {
    int S;
    int r[kMaxScales];             // y radius per scale
    const float* num[kMaxScales];  // G_z G_x (c*f)
    const float* den[kMaxScales];  // G_z G_x c
};

// Shared memory, in floats, of a block whose scale has y radius ry: the
// taps, the extended numerator and denominator planes, three s planes.
__host__ __device__ inline size_t ys_smem_floats(int ry) {
    return (size_t)(2 * ry + 1) + 2 * (size_t)(kYsSY + 2 * ry) * kYsSZ
           + 3 * kYsCells;
}

__global__ void __launch_bounds__(kYsThreads)
features8_ys_multi_kernel(YsScales sc, const float* __restrict__ taps,
                          const float* __restrict__ mask,
                          float* __restrict__ out, int X, int Y, int Z,
                          int n_chunks, StencilRecip k) {
    extern __shared__ float smem[];
    constexpr int SY = kYsSY, SZ = kYsSZ, NC = kYsCells, RUN = kYsRun;
    const int s = blockIdx.z / n_chunks;
    const int ry = sc.r[s];
    const int NT = 2 * ry + 1;
    const int PY = SY + 2 * ry;
    float* st = smem;            // [NT] taps
    float* pn = st + NT;         // [PY][SZ] numerator
    float* pd = pn + PY * SZ;    // [PY][SZ] denominator
    float* ring = pd + PY * SZ;  // [3][NC] s planes
    const float* __restrict__ num = sc.num[s];
    const float* __restrict__ den = sc.den[s];

    for (int i = threadIdx.x; i < NT; i += blockDim.x)
        st[i] = taps[(size_t)s * kMaxTaps + i];
    // ordered before the first FIR by the sync after the first load

    const int z0 = blockIdx.x * kYsTileZ;
    const int y0 = blockIdx.y * kYsTileY;
    const int xa = (blockIdx.z % n_chunks) * kYsChunkX;
    const int xb = min(xa + kYsChunkX, X);
    const long long plane = (long long)Y * Z;
    const long long n = (long long)X * plane;
    float* const out_s = out + (long long)s * 8 * n;

    // s planes this block needs: its chunk and one plane each side
    for (int p = max(xa - 1, 0); p <= min(xb, X - 1); ++p) {
        const long long src = (long long)p * plane;
        // extended cell (i, j) is global (y0 - 1 - ry + i, z0 - 1 + j), clamped
        for (int idx = threadIdx.x; idx < PY * SZ; idx += blockDim.x) {
            const int gy = clamp_index(y0 - 1 - ry + idx / SZ, Y);
            const int gz = clamp_index(z0 - 1 + idx % SZ, Z);
            const long long off = src + (long long)gy * Z + gz;
            pn[idx] = __ldg(num + off);
            pd[idx] = __ldg(den + off);
        }
        __syncthreads();

        // s rows i0 .. i0 + RUN - 1 of column j from one walk (fir.cuh)
        float* sp = ring + (p % 3) * NC;
        const TapsView ty{ry, st};
        for (int item = threadIdx.x; item < (SY / RUN) * SZ; item += blockDim.x) {
            const int i0 = (item / SZ) * RUN, j = item % SZ;
            const float* const col[2] = {pn + i0 * SZ + j, pd + i0 * SZ + j};
            float acc[2][RUN];
            fir_walk<RUN, 2>(col, SZ, ty, acc);
#pragma unroll
            for (int u = 0; u < RUN; ++u)  // no epsilon: 0/0 = NaN off the support
                sp[(i0 + u) * SZ + j] = acc[0][u] / acc[1][u];
        }
        __syncthreads();

        // emit plane p - 1 (its x + 1 neighbour is p), and at the last true
        // plane also plane p itself (x + 1 clamps to p)
        for (int x = max(p - 1, xa); x <= (p == X - 1 ? p : p - 1); ++x) {
            if (x >= xb) break;
            emit_features8_plane<kYsTileY, kYsTileZ, false>(
                ring, x, X, Y, Z, y0, z0, mask, out_s, k);
        }
        // the next load overwrites pn, pd, which the FIR read before the sync
        // above; the next FIR overwrites the s slot of plane p - 2, which the
        // tail read before the sync after that load
    }
}

// num_ptrs, den_ptrs: HOST arrays of S (<= kMaxScales) device pointers to
// contiguous (X, Y, Z) float32 volumes; mask: the clamped {0, 1} mask, same
// shape; out: contiguous (S, 8, X, Y, Z); taps: DEVICE array [S][kMaxTaps]
// of float32 (2r+1 used per row); radii: HOST array of the S y radii.
extern "C" int ife_features8_ys_multi(const void* const* num_ptrs,
                                      const void* const* den_ptrs, long long S,
                                      const float* mask, float* out,
                                      long long X, long long Y, long long Z,
                                      const float* taps,
                                      const long long* radii,
                                      float r2x, float r2y, float r2z,
                                      float rxx, float ryy, float rzz,
                                      cudaStream_t stream) {
    if (S < 1 || S > kMaxScales) return (int)cudaErrorInvalidValue;
    YsScales sc{};
    sc.S = (int)S;
    int ry_max = 0;
    for (int s = 0; s < S; ++s) {
        if (radii[s] < 0 || 2 * radii[s] + 1 > kMaxTaps)
            return (int)cudaErrorInvalidValue;
        sc.r[s] = (int)radii[s];
        ry_max = std::max(ry_max, sc.r[s]);
        sc.num[s] = static_cast<const float*>(num_ptrs[s]);
        sc.den[s] = static_cast<const float*>(den_ptrs[s]);
    }
    const size_t smem = ys_smem_floats(ry_max) * sizeof(float);
    if (smem > (size_t)kYsMaxSmem) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            features8_ys_multi_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const long long n_chunks = (X + kYsChunkX - 1) / kYsChunkX;
    if (S * n_chunks > 65535) return (int)cudaErrorInvalidValue;
    const StencilRecip k{r2x, r2y, r2z, rxx, ryy, rzz};
    const dim3 grid((unsigned)((Z + kYsTileZ - 1) / kYsTileZ),
                    (unsigned)((Y + kYsTileY - 1) / kYsTileY),
                    (unsigned)(S * n_chunks));
    features8_ys_multi_kernel<<<grid, kYsThreads, smem, stream>>>(
        sc, taps, mask, out, (int)X, (int)Y, (int)Z, (int)n_chunks, k);
    return (int)cudaGetLastError();
}
