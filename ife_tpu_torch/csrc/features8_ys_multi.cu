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
// (ops/stencil.py kernel_smooth_axis), so the kernel equals its twin to the
// bit (the library is built without FMA contraction).
//
// A block owns one scale (blockIdx.z carries scale and x chunk), a (y, z)
// tile of 30 x 32 voxels and a chunk of x, and sweeps x. It first finds the
// planes of its chunk on which its tile holds a voxel inside the mask
// (tile_mask_span of sweep_passes.cuh), stores zeros on the others
// (tile_zero_planes) and sweeps only the s planes from one before the first
// to one after the last. Per s plane p it
//   1. loads plane p's numerator and denominator on the tile plus a
//      one-voxel halo, extended by the y radius, at clamped positions (the
//      ZeroFluxNeumann pad of the y pass), each thread a fixed column of
//      rows kYsLoadRows apart (one clamp and one multiply an element);
//   2. runs the y FIR and the divide (sweep_divide: den == 0 stepped
//      around, the same bits) for the 32 x 34 cells of the tile plus halo
//      into a ring of three s planes. Each thread makes four consecutive y
//      outputs of one z column from one walk over the 2r + 4 inputs they
//      share (fir_walk in fir.cuh), so an input leaves shared memory once for
//      four outputs, each still summed in tap order;
//   3. after a barrier, emits the features of plane p - 1 through
//      s_ring.cuh (the one tail of features8_tail.cuh), skipping the tail of
//      every voxel outside the mask. The first and last plane of the volume
//      stand in for their missing x neighbours: the tail clamps x as it
//      clamps y and z, to the smoothed field, never to a smoothing at a
//      virtual position;
//
// One buffer, not two: with the next plane in flight in a second buffer (61
// KB of shared memory at ry 28 against 37) an SM holds half the blocks, and
// at 512^3 the launch measured 6.6-6.8 ms under the sphere mask against
// 6.3-6.5 with one buffer, 9.9-10.1 against 8.6-8.8 under a mask of ones
// (S = 2, sigma 2.4 and 4.8 at 0.78 mm; NVIDIA H100 80GB HBM3, 700 W). Four
// to six blocks of nine warps hide the loads' latency; x chunks of 128
// planes in place of 64 measured the same to 2%.
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
// scale, the mask) are a third of its time at 512^3 with a mask of ones; the
// rest is arithmetic and address work in the SMs: per cell the FIR's
// 2 * (2r + 1) multiplies and adds (unfused, to match the twin), the index
// arithmetic of the clamped loads, and the tail. Under a lung-like mask
// most planes of most tiles hold no voxel inside and are not swept.
#include <cuda_runtime.h>

#include "features8_tail.cuh"
#include "fir.cuh"
#include "s_ring.cuh"
#include "sweep_passes.cuh"

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
// rows of the extended plane one load step covers: thread t loads column
// t % kYsSZ of rows t / kYsSZ + k * kYsLoadRows
constexpr int kYsLoadRows = kYsThreads / kYsSZ;

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
    const int n_ext = PY * SZ;        // cells of an extended plane
    float* st = smem;                 // [NT] taps
    float* pn = st + NT;              // [PY][SZ] numerator
    float* pd = pn + n_ext;           // [PY][SZ] denominator
    float* ring = pd + n_ext;         // [3][NC] s planes
    const float* __restrict__ num = sc.num[s];
    const float* __restrict__ den = sc.den[s];

    for (int i = threadIdx.x; i < NT; i += blockDim.x)
        st[i] = taps[(size_t)s * kMaxTaps + i];
    // ordered before the first FIR by the barrier after the first load

    const int z0 = blockIdx.x * kYsTileZ;
    const int y0 = blockIdx.y * kYsTileY;
    const int xa = (blockIdx.z % n_chunks) * kYsChunkX;
    const int xb = min(xa + kYsChunkX, X);
    const long long plane = (long long)Y * Z;
    const long long n = (long long)X * plane;
    float* const out_s = out + (long long)s * 8 * n;

    __shared__ int span[2];
    int x_first, x_last;
    tile_mask_span<kYsTileY, kYsTileZ, kYsThreads>(
        mask, xa, xb, y0, z0, Y, Z, span, x_first, x_last);
    tile_zero_planes<kYsTileY, kYsTileZ, kYsThreads>(
        out_s, xa, xb, x_first, x_last, X, Y, Z, y0, z0);
    if (x_first > x_last) return;  // the same for every thread of the block
    const int p_lo = max(x_first - 1, 0);
    const int p_hi = min(x_last + 1, X - 1);

    // extended cell (i, j) is global (y0 - 1 - ry + i, z0 - 1 + j), clamped;
    // this thread loads column lj of rows li, li + kYsLoadRows, ...
    const int lj = threadIdx.x % SZ, li = threadIdx.x / SZ;
    const long long gz = clamp_index(z0 - 1 + lj, Z);
    const TapsView ty{ry, st};
    for (int p = p_lo; p <= p_hi; ++p) {
        if (li < kYsLoadRows) {
            const long long src = (long long)p * plane + gz;
            for (int i = li; i < PY; i += kYsLoadRows) {
                const long long off =
                    src + (long long)clamp_index(y0 - 1 - ry + i, Y) * Z;
                cp_async_f32(pn + i * SZ + lj, num + off);
                cp_async_f32(pd + i * SZ + lj, den + off);
            }
        }
        cp_async_wait_all();
        __syncthreads();

        // s rows i0 .. i0 + RUN - 1 of column j from one walk (fir.cuh)
        float* sp = ring + (p % 3) * NC;
        for (int item = threadIdx.x; item < (SY / RUN) * SZ; item += blockDim.x) {
            const int i0 = (item / SZ) * RUN, j = item % SZ;
            const float* const col[2] = {pn + i0 * SZ + j, pd + i0 * SZ + j};
            float acc[2][RUN];
            fir_walk<RUN, 2>(col, SZ, ty, acc);
#pragma unroll
            for (int u = 0; u < RUN; ++u)  // no epsilon: 0/0 = NaN off the support
                sp[(i0 + u) * SZ + j] = sweep_divide(acc[0][u], acc[1][u]);
        }
        __syncthreads();

        // emit plane p - 1 (its x + 1 neighbour is p), and at the last true
        // plane also plane p itself (x + 1 clamps to p)
        for (int x = max(p - 1, x_first); x <= (p == X - 1 ? p : p - 1); ++x) {
            if (x > x_last) break;
            emit_features8_plane<kYsTileY, kYsTileZ, false>(
                ring, x, X, Y, Z, y0, z0, mask, out_s, k);
        }
        // The next load overwrites pn, pd, which this FIR read before the
        // barrier after it; the next FIR overwrites the s slot of plane
        // p - 2, which this tail read before the next load's barrier.
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
