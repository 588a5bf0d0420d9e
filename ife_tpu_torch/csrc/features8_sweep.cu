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
// Shard blocks: both sweep entries take the four face clamps of s_ring.cuh
// (the clamp_ref operand of the TPU kernels). On a halo-extended shard block
// the smoothing reads the halo as data, and the tail's phantom clamps to the
// smoothed field at the kept core's true faces only; the default, the
// array's own faces, is the whole-volume kernel to the bit.
//
// ife_features8_sweep_multi (features8_sweep_multi_kernel) replaces
// ife_tpu/kernels/fused.py:fused_features8_sweep_multi: S scales of the sweep
// in one launch. A block loads each extended raw plane (c*f and c, extended
// by the LARGEST y and z radii) once and every scale runs its own y and z
// passes from it into its own x ring, so the image and the mask leave HBM
// once for all S scales. (The TPU kernel shared rings of raw rows and ran x
// first; here the rings hold y/z-smoothed planes, which differ per scale, so
// the raw plane is what is shared and the passes keep the single sweep's
// order y, z, x: each scale equals fused_features8_sweep, and its plain twin,
// to the bit.) Scale s emits plane q - rx_s when raw plane q arrives. The
// taps come as a device array, copied to shared memory by each block.
//
// What bounds it on the H100: shared-memory traffic, ~(2ry+1 + 2rz+1 +
// 2rx+1) * 2 reads per voxel, and the x ring's size, which caps the blocks
// per SM. HBM sees the image and mask once and the 8 channels written once
// (40 B per voxel, against 116 B for the staged nc + post kernels).
#include <cuda_runtime.h>

#include "features8_tail.cuh"
#include "fir.cuh"
#include "s_ring.cuh"

constexpr int kSweepTileY = 14;
constexpr int kSweepTileZ = 32;
constexpr int kSweepSY = kSweepTileY + 2;  // s region: the tile + 1 halo
constexpr int kSweepSZ = kSweepTileZ + 2;
constexpr int kSweepCells = kSweepSY * kSweepSZ;
constexpr int kSweepThreads = 512;  // 256: 1.08x / 1.18x slower at sigma 0.6 / 1.2
constexpr int kSweepMaxSmem = 227 * 1024;

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

// The passes of one plane, shared by the single- and the multi-scale kernel.
// TapsT is Taps (kernel parameter) or TapsView (shared memory).

// Load c*f and c of plane `src` on the tile extended by ry + 1 rows and
// rz + 1 columns each side, at clamped positions (the ZeroFluxNeumann pad).
__device__ __forceinline__ void sweep_load_raw(
    const float* __restrict__ image, const float* __restrict__ mask,
    long long src, int y0, int z0, int Y, int Z, int ry, int rz, float* pn,
    float* pd) {
    const int PY = kSweepSY + 2 * ry, PZ = kSweepSZ + 2 * rz;
    // extended cell (i, j) is global (y0 - 1 - ry + i, z0 - 1 - rz + j)
    for (int idx = threadIdx.x; idx < PY * PZ; idx += blockDim.x) {
        const int gy = clamp_index(y0 - 1 - ry + idx / PZ, Y);
        const int gz = clamp_index(z0 - 1 - rz + idx % PZ, Z);
        const long long off = src + (long long)gy * Z + gz;
        const float c = clamp_unit_mask(__ldg(mask + off));
        pn[idx] = __ldg(image + off) * c;  // c*f rounded, as plain
        pd[idx] = c;
    }
}

// q[i][j] = sum_t ty[t] * p[row0 + i + t][col0 + j] for the SY x PZ cells
// the z pass needs; p has rows of src_pz floats (row0 = col0 = 0 when p was
// loaded with this scale's own radii).
template <class TapsT>
__device__ __forceinline__ void sweep_y_pass(
    const float* pn, const float* pd, int src_pz, int row0, int col0, int PZ,
    const TapsT& ty, float* qn, float* qd) {
    for (int idx = threadIdx.x; idx < kSweepSY * PZ; idx += blockDim.x) {
        const int i = idx / PZ, j = idx % PZ;
        float an = 0.0f, ad = 0.0f;
        for (int t = 0; t <= 2 * ty.r; ++t) {
            const int e = (row0 + i + t) * src_pz + col0 + j;
            an = t == 0 ? ty.t[0] * pn[e] : an + ty.t[t] * pn[e];
            ad = t == 0 ? ty.t[0] * pd[e] : ad + ty.t[t] * pd[e];
        }
        qn[idx] = an;
        qd[idx] = ad;
    }
}

template <class TapsT>
__device__ __forceinline__ void sweep_z_pass(const float* qn, const float* qd,
                                             int PZ, const TapsT& tz,
                                             float* xn, float* xd) {
    for (int idx = threadIdx.x; idx < kSweepCells; idx += blockDim.x) {
        const int i = idx / kSweepSZ, j = idx % kSweepSZ;
        float an = 0.0f, ad = 0.0f;
        for (int t = 0; t <= 2 * tz.r; ++t) {
            const int e = i * PZ + j + t;
            an = t == 0 ? tz.t[0] * qn[e] : an + tz.t[t] * qn[e];
            ad = t == 0 ? tz.t[0] * qd[e] : ad + tz.t[t] * qd[e];
        }
        xn[idx] = an;
        xd[idx] = ad;
    }
}

// s plane = G_x num / G_x den from the x ring ([2rx+1][cells] each), whose
// slot `first` holds the plane of tap 0
template <class TapsT>
__device__ __forceinline__ void sweep_x_pass_divide(
    const float* rn, const float* rd, int first, const TapsT& tx, float* sp) {
    const int W = 2 * tx.r + 1;
    for (int idx = threadIdx.x; idx < kSweepCells; idx += blockDim.x) {
        float an = 0.0f, ad = 0.0f;
        for (int t = 0, sl = first; t < W; ++t, sl = sl + 1 == W ? 0 : sl + 1) {
            const int e = sl * kSweepCells + idx;
            an = t == 0 ? tx.t[0] * rn[e] : an + tx.t[t] * rn[e];
            ad = t == 0 ? tx.t[0] * rd[e] : ad + tx.t[t] * rd[e];
        }
        sp[idx] = an / ad;  // no epsilon: 0/0 = NaN off the support
    }
}

// Emit plane p - 1 (its x + 1 neighbour is p) of the chunk [xa, xb), and at
// the last true plane also plane p itself (x + 1 clamps to p).
template <bool kClampMask>
__device__ __forceinline__ void sweep_emit(const float* ring, int p, int xa,
                                           int xb, int X, int Y, int Z, int y0,
                                           int z0, const float* mask,
                                           float* out, const StencilRecip& k,
                                           const FaceClamps& fc) {
    for (int x = max(p - 1, xa); x <= (p == X - 1 ? p : p - 1); ++x) {
        if (x >= xb) break;
        emit_features8_plane<kSweepTileY, kSweepTileZ, kClampMask>(
            ring, x, X, Y, Z, y0, z0, mask, out, k, fc);
    }
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
                       Taps tz, StencilRecip k, FaceClamps fc) {
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
    // s planes this block needs, and the input planes (clamped) behind them
    const int p_lo = max(xa - 1, 0);
    const int p_hi = min(xb, X - 1);

    for (int q = p_lo - rx; q <= p_hi + rx; ++q) {
        const long long src = (long long)clamp_index(q, X) * plane;
        const int slot = ((q % W) + W) % W;
        float* xn = rn + slot * NC;
        float* xd = rd + slot * NC;
        if (kSmoothYZ) {
            sweep_load_raw(a, b, src, y0, z0, Y, Z, ry, rz, pn, pd);
            __syncthreads();
            sweep_y_pass(pn, pd, PZ, 0, 0, PZ, ty, qn, qd);
            __syncthreads();
            sweep_z_pass(qn, qd, PZ, tz, xn, xd);
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
        // ring slot of plane p - rx: tap 0
        sweep_x_pass_divide(rn, rd, ((p - rx) % W + W) % W, tx,
                            ring + (p % 3) * NC);
        __syncthreads();
        sweep_emit<kSmoothYZ>(ring, p, xa, xb, X, Y, Z, y0, z0, mask, out, k,
                              fc);
        // the next plane overwrites a ring slot the x pass read and, two
        // planes on, the s slot the tail read: the syncs after its loads
        // order those writes after these reads
    }
}

template <bool kSmoothYZ>
static int launch_sweep(const float* a, const float* b, const float* mask,
                        float* out, long long X, long long Y, long long Z,
                        const Taps& tx, const Taps& ty, const Taps& tz,
                        const StencilRecip& k, const FaceClamps& fc,
                        cudaStream_t stream) {
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
        a, b, mask, out, (int)X, (int)Y, (int)Z, chunk, tx, ty, tz, k, fc);
    return (int)cudaGetLastError();
}

static bool make_faces(long long x_lo, long long x_hi, long long y_lo,
                       long long y_hi, FaceClamps* fc) {
    const long long lim = 1LL << 30;  // the "no true face" sentinels
    const long long v[4] = {x_lo, x_hi, y_lo, y_hi};
    for (int i = 0; i < 4; ++i)
        if (v[i] < -lim || v[i] > lim) return false;
    *fc = FaceClamps{(int)x_lo, (int)x_hi, (int)y_lo, (int)y_hi};
    return true;
}

// image, mask: contiguous (X, Y, Z) float32 (the mask raw, clamped to [0, 1]
// here); out: contiguous (8, X, Y, Z); taps_*: host arrays of 2r+1 floats;
// x_lo .. y_hi: the face clamps (0, X - 1, 0, Y - 1 for a whole volume).
extern "C" int ife_features8_sweep(const float* image, const float* mask,
                                   float* out, long long X, long long Y,
                                   long long Z,
                                   const float* taps_x, long long ntx,
                                   const float* taps_y, long long nty,
                                   const float* taps_z, long long ntz,
                                   long long x_lo, long long x_hi,
                                   long long y_lo, long long y_hi,
                                   float r2x, float r2y, float r2z,
                                   float rxx, float ryy, float rzz,
                                   cudaStream_t stream) {
    FaceClamps fc;
    if (!make_faces(x_lo, x_hi, y_lo, y_hi, &fc))
        return (int)cudaErrorInvalidValue;
    Taps tx, ty, tz;
    if (!make_taps(taps_x, ntx, &tx) || !make_taps(taps_y, nty, &ty)
        || !make_taps(taps_z, ntz, &tz))
        return (int)cudaErrorInvalidValue;
    const StencilRecip k{r2x, r2y, r2z, rxx, ryy, rzz};
    return launch_sweep<true>(image, mask, mask, out, X, Y, Z, tx, ty, tz, k,
                              fc, stream);
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
                               unit, k, whole_volume_faces((int)X, (int)Y),
                               stream);
}

// ---------------------------------------------------------------------------
// S scales in one launch
// ---------------------------------------------------------------------------

struct SweepScales {
    int S;
    int r[kMaxScales][3];  // x, y, z radius per scale
};

// Shared memory, in floats: every scale's taps, x rings and three s planes,
// then one extended raw plane at the largest y and z radii and its y pass.
__host__ __device__ inline size_t sweep_multi_smem_floats(const SweepScales& sc) {
    size_t f = 0;
    int ry = 0, rz = 0;
    for (int s = 0; s < sc.S; ++s) {
        f += 2 * (size_t)(sc.r[s][0] + sc.r[s][1] + sc.r[s][2]) + 3;
        f += 2 * (size_t)(2 * sc.r[s][0] + 1) * kSweepCells + 3 * kSweepCells;
        ry = sc.r[s][1] > ry ? sc.r[s][1] : ry;
        rz = sc.r[s][2] > rz ? sc.r[s][2] : rz;
    }
    const size_t py = kSweepSY + 2 * ry, pz = kSweepSZ + 2 * rz;
    return f + 2 * py * pz + 2 * kSweepSY * pz;
}

// image, mask as in the single sweep; out: (S, 8, X, Y, Z); taps: device
// array [S][3][kMaxTaps] (x, y, z per scale, 2r+1 floats used of each row).
__global__ void __launch_bounds__(kSweepThreads)
features8_sweep_multi_kernel(const float* __restrict__ image,
                             const float* __restrict__ mask,
                             float* __restrict__ out, int X, int Y, int Z,
                             int chunk_x, SweepScales sc,
                             const float* __restrict__ taps, StencilRecip k,
                             FaceClamps fc) {
    extern __shared__ float smem[];
    constexpr int SY = kSweepSY, SZ = kSweepSZ, NC = kSweepCells;
    int rx_max = 0, ry_max = 0, rz_max = 0;
    size_t tap_floats = 0, ring_floats = 0;
    for (int s = 0; s < sc.S; ++s) {
        rx_max = max(rx_max, sc.r[s][0]);
        ry_max = max(ry_max, sc.r[s][1]);
        rz_max = max(rz_max, sc.r[s][2]);
        tap_floats += 2 * (sc.r[s][0] + sc.r[s][1] + sc.r[s][2]) + 3;
        ring_floats += (2 * (2 * sc.r[s][0] + 1) + 3) * NC;
    }
    const int PY = SY + 2 * ry_max, PZ = SZ + 2 * rz_max;
    float* st = smem;                    // the taps, scale by scale: x, y, z
    float* rings = st + tap_floats;      // per scale: rn, rd [W][NC], s [3][NC]
    float* pn = rings + ring_floats;     // [PY][PZ] raw c*f
    float* pd = pn + PY * PZ;            // [PY][PZ] raw c
    float* qn = pd + PY * PZ;            // [SY][<= PZ] y pass
    float* qd = qn + SY * PZ;

    {
        float* dst = st;
        for (int s = 0; s < sc.S; ++s)
            for (int a = 0; a < 3; ++a) {
                const int nt = 2 * sc.r[s][a] + 1;
                const float* src = taps + (size_t)(s * 3 + a) * kMaxTaps;
                for (int i = threadIdx.x; i < nt; i += blockDim.x)
                    dst[i] = src[i];
                dst += nt;
            }
    }
    // ordered before the first y pass by the sync after the first raw load

    const int z0 = blockIdx.x * kSweepTileZ;
    const int y0 = blockIdx.y * kSweepTileY;
    const int xa = blockIdx.z * chunk_x;
    const int xb = min(xa + chunk_x, X);
    const long long plane = (long long)Y * Z;
    const long long n = (long long)X * plane;
    const int p_lo = max(xa - 1, 0);
    const int p_hi = min(xb, X - 1);

    for (int q = p_lo - rx_max; q <= p_hi + rx_max; ++q) {
        sweep_load_raw(image, mask, (long long)clamp_index(q, X) * plane, y0,
                       z0, Y, Z, ry_max, rz_max, pn, pd);
        __syncthreads();
        const float* t = st;
        float* rn = rings;
        for (int s = 0; s < sc.S; ++s) {
            const int rx = sc.r[s][0], ry = sc.r[s][1], rz = sc.r[s][2];
            const int W = 2 * rx + 1;
            const TapsView tx{rx, t};
            const TapsView ty{ry, t + W};
            const TapsView tz{rz, t + W + 2 * ry + 1};
            float* rd = rn + W * NC;
            float* ring = rd + W * NC;
            t += W + 2 * ry + 1 + 2 * rz + 1;
            float* const rn_s = rn;
            rn = ring + 3 * NC;  // the next scale's
            // this scale needs raw planes p_lo - rx .. p_hi + rx only (the
            // same for every thread of the block)
            if (q < p_lo - rx || q > p_hi + rx) continue;
            const int slot = ((q % W) + W) % W;
            const int pz = SZ + 2 * rz;
            sweep_y_pass(pn, pd, PZ, ry_max - ry, rz_max - rz, pz, ty, qn, qd);
            __syncthreads();
            sweep_z_pass(qn, qd, pz, tz, rn_s + slot * NC, rd + slot * NC);
            __syncthreads();
            const int p = q - rx;
            if (p < p_lo) continue;
            sweep_x_pass_divide(rn_s, rd, ((p - rx) % W + W) % W, tx,
                                ring + (p % 3) * NC);
            __syncthreads();
            sweep_emit<true>(ring, p, xa, xb, X, Y, Z, y0, z0, mask,
                             out + (long long)s * 8 * n, k, fc);
        }
        // the next raw load overwrites pn, pd, which the last y pass read
        // before at least one sync; every ring hazard is as in the single
        // sweep
    }
}

// image, mask: contiguous (X, Y, Z) float32; out: contiguous (S, 8, X, Y, Z);
// taps: DEVICE array [S][3][kMaxTaps] of float32; radii: HOST array [S][3]
// (x, y, z per scale); x_lo .. y_hi: the face clamps, as in the single sweep.
extern "C" int ife_features8_sweep_multi(const float* image, const float* mask,
                                         float* out, long long X, long long Y,
                                         long long Z, long long S,
                                         const float* taps,
                                         const long long* radii,
                                         long long x_lo, long long x_hi,
                                         long long y_lo, long long y_hi,
                                         float r2x, float r2y, float r2z,
                                         float rxx, float ryy, float rzz,
                                         cudaStream_t stream) {
    if (S < 1 || S > kMaxScales) return (int)cudaErrorInvalidValue;
    FaceClamps fc;
    if (!make_faces(x_lo, x_hi, y_lo, y_hi, &fc))
        return (int)cudaErrorInvalidValue;
    SweepScales sc{};
    sc.S = (int)S;
    int rx_max = 0;
    for (int s = 0; s < S; ++s)
        for (int a = 0; a < 3; ++a) {
            const long long r = radii[s * 3 + a];
            if (r < 0 || 2 * r + 1 > kMaxTaps) return (int)cudaErrorInvalidValue;
            sc.r[s][a] = (int)r;
            if (a == 0) rx_max = std::max(rx_max, (int)r);
        }
    const size_t smem = sweep_multi_smem_floats(sc) * sizeof(float);
    if (smem > (size_t)kSweepMaxSmem) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            features8_sweep_multi_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const StencilRecip k{r2x, r2y, r2z, rxx, ryy, rzz};
    const int chunk = sweep_chunk_x(X, rx_max);
    const dim3 grid((unsigned)((Z + kSweepTileZ - 1) / kSweepTileZ),
                    (unsigned)((Y + kSweepTileY - 1) / kSweepTileY),
                    (unsigned)((X + chunk - 1) / chunk));
    features8_sweep_multi_kernel<<<grid, kSweepThreads, smem, stream>>>(
        image, mask, out, (int)X, (int)Y, (int)Z, chunk, sc, taps, k, fc);
    return (int)cudaGetLastError();
}
