// S scales of the features8 line sweep in one launch: the image and the mask
// leave HBM once for all of them.
//
// Replaces ife_tpu/kernels/fused.py:fused_features8_sweep_multi. (The TPU
// kernel shared rings of raw rows and ran x first; here the raw plane is
// what is shared and the passes keep the single sweep's order y, z, x: each
// scale equals fused_features8_sweep, and its plain twin, to the bit.)
//
// The block and its passes are those of features8_sweep.cu
// (sweep_passes.cuh): one thread per cell of the s region, the raw plane
// loaded asynchronously one plane ahead, extended by the LARGEST y and z
// radii, from which every scale's y pass reads its own sub-window.
//
// How the scales share the block: the same 544 threads run scale after
// scale on the one raw plane, and a thread keeps the x queues of ALL scales
// of its cell in registers. (One warp group per scale, each with its own
// named barrier, would need S * 544 threads, over a block's 1024 for S = 2.)
// Per raw plane the y passes of all scales run back to back into one y pass
// buffer per scale, then ONE barrier, then every scale's z pass, queue push,
// x sum and divide, then ONE barrier, then every scale's tail: two barriers
// a plane whatever S is.
//
// The queues are sized at compile time by RXM, the class of the largest x
// radius (the launcher's list), and hold 2 * RXM + 1 planes for every
// scale. A scale with a smaller radius sums only the newest 2 * rx + 1 of
// them: the slots are walked from the oldest to the newest, at compile
// time, the ages beyond 2 * rx are stepped over at run time, and the tap of
// an age is read from the scale's x taps kept reversed in shared memory.
// That keeps tap order and uses no zero tap (0 * inf would not be 0), so the
// bits are the single sweep's. Scale s
// emits plane q - rx_s when raw plane q arrives. The budget is the registers:
// S * 2 * (2 * RXM + 1) <= 60 queue registers a thread (40 for the smallest
// class, whose four scales need the more registers beside the queue), which
// sweep_multi_fits (kernels/features8_sweep.py) states; the launcher
// refuses what is beyond it.
//
// The taps come as a device array, copied to shared memory by each block.
//
// What bounds it on the H100: as the single sweep, the SMs' instructions;
// against S single sweeps it saves the load of the raw plane and its
// barriers, and pays the run-time tap lookup of the x pass.
#include <cuda_runtime.h>

#include "sweep_passes.cuh"

struct SweepScales {
    int S;
    int r[kMaxScales][3];  // x, y, z radius per scale
};

// taps of one scale in shared memory: x, y, z, each 2r+1 floats
__host__ __device__ inline int sweep_scale_taps(const SweepScales& sc, int s) {
    return 2 * (sc.r[s][0] + sc.r[s][1] + sc.r[s][2]) + 3;
}

// Shared memory, in floats: every scale's taps, y pass buffer (at the
// largest z radius) and three s planes, then two buffers of the raw plane at
// the largest y and z radii.
__host__ __device__ inline size_t sweep_multi_smem_floats(const SweepScales& sc) {
    size_t f = 0;
    int ry = 0, rz = 0;
    for (int s = 0; s < sc.S; ++s) {
        f += sweep_scale_taps(sc, s);
        ry = sc.r[s][1] > ry ? sc.r[s][1] : ry;
        rz = sc.r[s][2] > rz ? sc.r[s][2] : rz;
    }
    f += (size_t)sc.S * (2 * kSweepSY * sweep_ybuf_stride(rz) + 3 * kSweepCells);
    return f + 4 * (size_t)(kSweepSY + 2 * ry) * (kSweepSZ + 2 * rz);
}

// Push (vn, vd) into slot kPhase of a queue of W planes and, when `live`,
// sum its newest 2 * rx + 1 planes in tap order: the plane of age a (a pushes
// ago) lives in slot (kPhase - a) mod W and takes tap 2 * rx - a, which is
// by_age[a]: the block keeps a scale's x taps reversed. The slots are walked
// from the oldest, at compile time; the ages beyond 2 * rx are stepped over.
// The sums start from -0, the identity of IEEE addition for every operand
// (-0 + x is x to the bit, signed zeros, infinities and NaN included), so
// the first product needs no case of its own and the sum is the twin's
// w0 * v0 + w1 * v1 + ... to the bit.
template <int W, int kPhase>
__device__ __forceinline__ void x_queue_step_at(float (&qn)[W], float (&qd)[W],
                                                float vn, float vd, int rx,
                                                const float* by_age, bool live,
                                                float& an, float& ad) {
    qn[kPhase] = vn;
    qd[kPhase] = vd;
    if (!live) return;
    an = ad = -0.0f;
#pragma unroll
    for (int a = W - 1; a >= 0; --a) {
        if (a > 2 * rx) continue;
        const int j = (kPhase + W - a) % W;
        const float w = by_age[a];
        an = an + w * qn[j];
        ad = ad + w * qd[j];
    }
}

template <int W>
__device__ __forceinline__ void x_queue_step(int phase, float (&qn)[W],
                                             float (&qd)[W], float vn,
                                             float vd, int rx,
                                             const float* by_age, bool live,
                                             float& an, float& ad) {
    switch (phase) {
#define IFE_X_CASE(P)                                                     \
    case P:                                                               \
        if constexpr (P < W)                                              \
            x_queue_step_at<W, P>(qn, qd, vn, vd, rx, by_age, live, an,   \
                                  ad);                                    \
        break;
        IFE_QUEUE_CASES(IFE_X_CASE)
#undef IFE_X_CASE
    }
}

// image, mask as in the single sweep; out: (S, 8, X, Y, Z); taps: device
// array [S][3][kMaxTaps] (x, y, z per scale, 2r+1 floats used of each row);
// sc.S == S and every sc.r[s][0] <= RXM.
template <int S, int RXM>
__global__ void __launch_bounds__(kSweepThreads, 1)
features8_sweep_multi_kernel(const float* __restrict__ image,
                             const float* __restrict__ mask,
                             float* __restrict__ out, int X, int Y, int Z,
                             int chunk_x, SweepScales sc,
                             const float* __restrict__ taps, StencilRecip k,
                             FaceClamps fc) {
    extern __shared__ float smem[];
    constexpr int SY = kSweepSY, SZ = kSweepSZ, NC = kSweepCells;
    constexpr int W = 2 * RXM + 1;
    int rx_max = 0, ry_max = 0, rz_max = 0, tap_floats = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
        rx_max = max(rx_max, sc.r[s][0]);
        ry_max = max(ry_max, sc.r[s][1]);
        rz_max = max(rz_max, sc.r[s][2]);
        tap_floats += sweep_scale_taps(sc, s);
    }
    const int z0 = blockIdx.x * kSweepTileZ;
    const int y0 = blockIdx.y * kSweepTileY;
    const RawTile tile = make_raw_tile(y0, z0, ry_max, rz_max, Y, Z);
    const int stride = sweep_ybuf_stride(rz_max);
    const int per_scale = 2 * SY * stride + 3 * NC;
    float* st = smem;                     // the taps, scale by scale: x, y, z
    float* scales = st + tap_floats;      // per scale: y pass n, d; s [3][NC]
    float* raw = scales + S * per_scale;  // [2 buffers][c*f, c][tile.n]

    {
        float* dst = st;
#pragma unroll
        for (int s = 0; s < S; ++s)
            for (int a = 0; a < 3; ++a) {
                const int nt = 2 * sc.r[s][a] + 1;
                const float* src = taps + (size_t)(s * 3 + a) * kMaxTaps;
                // the x taps by age (reversed: x_queue_step_at), y and z
                // taps in tap order
                for (int i = threadIdx.x; i < nt; i += kSweepThreads)
                    dst[i] = src[a == 0 ? nt - 1 - i : i];
                dst += nt;
            }
    }
    // ordered before the first y pass by the barrier after the first load

    const int xa = blockIdx.z * chunk_x;
    const int xb = min(xa + chunk_x, X);
    const long long plane = (long long)Y * Z;
    const long long n = (long long)X * plane;
    // the planes of the chunk that hold a voxel inside the mask: the rest
    // are zeros at every scale, and need no s
    __shared__ int span[2];
    int x_first, x_last;
    const SweepColumns g = sweep_columns(y0, z0, Y, Z);
    column_span(mask, g, xa, xb, span, x_first, x_last);
#pragma unroll
    for (int s = 0; s < S; ++s)
        column_zeros(out + (long long)s * 8 * n, n, g, xa, xb, x_first, x_last);
    if (x_first > x_last) return;  // the same for every thread of the block
    const int p_lo = max(x_first - 1, 0);
    const int p_hi = min(x_last + 1, X - 1);
    const int q_lo = p_lo - rx_max, q_hi = p_hi + rx_max;
    const int cell = (threadIdx.x / SZ) * stride + threadIdx.x % SZ;

    float xn[S][W], xd[S][W];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
        for (int i = 0; i < W; ++i) xn[s][i] = xd[s][i] = 0.0f;

    {
        const long long src = (long long)clamp_index(q_lo, X) * plane;
        sweep_issue_raw(image + src, mask + src, tile, raw, raw + tile.n);
        sweep_finish_raw(tile, raw, raw + tile.n);
    }
    __syncthreads();
    int phase = 0;
    for (int q = q_lo; q <= q_hi; ++q) {
        float* pn = raw + ((q - q_lo) & 1) * 2 * tile.n;  // plane q
        float* nn = raw + ((q - q_lo + 1) & 1) * 2 * tile.n;  // plane q + 1
        if (q < q_hi) {
            const long long src = (long long)clamp_index(q + 1, X) * plane;
            sweep_issue_raw(image + src, mask + src, tile, nn, nn + tile.n);
        }
        // scale s needs raw planes p_lo - rx .. p_hi + rx only (the same
        // for every thread of the block)
        const float* t = st;
#pragma unroll
        for (int s = 0; s < S; ++s) {
            const int rx = sc.r[s][0], ry = sc.r[s][1], rz = sc.r[s][2];
            const TapsView ty{ry, t + 2 * rx + 1};
            t += sweep_scale_taps(sc, s);
            if (q < p_lo - rx || q > p_hi + rx) continue;
            const int pz = SZ + 2 * rz;
            sweep_y_pass(sweep_y_item(sweep_y_first_index(), tile.n, tile.PZ,
                                      ry_max - ry, rz_max - rz, pz, stride),
                         pn, tile.n, tile.PZ, ry_max - ry, rz_max - rz, pz, ty,
                         scales + s * per_scale, stride);
        }
        __syncthreads();

        t = st;
#pragma unroll
        for (int s = 0; s < S; ++s) {
            const int rx = sc.r[s][0], ry = sc.r[s][1], rz = sc.r[s][2];
            const float* tx_by_age = t;
            const TapsView tz{rz, t + 2 * rx + 1 + 2 * ry + 1};
            t += sweep_scale_taps(sc, s);
            if (q < p_lo - rx || q > p_hi + rx) continue;
            const float* qn = scales + s * per_scale;
            float vn, vd, an = 0.0f, ad = 0.0f;
            sweep_z_pass(qn, qn + SY * stride, cell, tz, vn, vd);
            const int p = q - rx;
            const bool live = p >= p_lo;
            x_queue_step<W>(phase, xn[s], xd[s], vn, vd, rx, tx_by_age, live,
                            an, ad);
            if (live)
                scales[s * per_scale + 2 * SY * stride + (p % 3) * NC
                       + threadIdx.x] = sweep_divide(an, ad);
        }
        phase = phase + 1 == W ? 0 : phase + 1;
        if (q < q_hi) sweep_finish_raw(tile, nn, nn + tile.n);
        __syncthreads();
#pragma unroll
        for (int s = 0; s < S; ++s) {
            const int p = q - sc.r[s][0];
            if (p < p_lo || p > p_hi) continue;
            sweep_emit<true>(scales + s * per_scale + 2 * SY * stride, p,
                             x_first, x_last + 1, X, Y, Z, y0, z0, mask,
                             out + (long long)s * 8 * n, k, fc);
        }
        // the hazards are the single sweep's, per scale
    }
}

template <int S, int RXM>
static int launch_sweep_multi(const float* image, const float* mask,
                              float* out, long long X, long long Y,
                              long long Z, const SweepScales& sc,
                              const float* taps, const StencilRecip& k,
                              const FaceClamps& fc, int rx_max,
                              cudaStream_t stream) {
    const size_t smem = sweep_multi_smem_floats(sc) * sizeof(float);
    if (smem > (size_t)kSweepMaxSmem) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            features8_sweep_multi_kernel<S, RXM>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int chunk = sweep_chunk_x(X, rx_max);
    features8_sweep_multi_kernel<S, RXM>
        <<<sweep_grid(X, Y, Z, chunk), kSweepThreads, smem, stream>>>(
            image, mask, out, (int)X, (int)Y, (int)Z, chunk, sc, taps, k, fc);
    return (int)cudaGetLastError();
}

// image, mask: contiguous (X, Y, Z) float32, Y * Z < 2^31; out: contiguous
// (S, 8, X, Y, Z); taps: DEVICE array [S][3][kMaxTaps] of float32; radii:
// HOST array [S][3] (x, y, z per scale); x_lo .. y_hi: the face clamps, as in
// the single sweep.
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
    if (S < 1 || S > kMaxScales || Y * Z >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
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
    const StencilRecip k{r2x, r2y, r2z, rxx, ryy, rzz};
#define IFE_MULTI(S_, RXM_)                                                 \
    if (S == S_ && rx_max <= RXM_)                                          \
        return launch_sweep_multi<S_, RXM_>(image, mask, out, X, Y, Z, sc,  \
                                            taps, k, fc, rx_max, stream);
    // The classes of the largest x radius, (RXM, scales a launch takes):
    // (2, 4), (4, 3), (7, 2), (10, 1), S * 2 * (2 * RXM + 1) <= 60 queue
    // registers a thread (5 and 6 scales at RXM = 2 spilled 156 and 732
    // bytes); per S, the classes from the smallest.
    IFE_MULTI(1, 2) IFE_MULTI(1, 4) IFE_MULTI(1, 7) IFE_MULTI(1, 10)
    IFE_MULTI(2, 2) IFE_MULTI(2, 4) IFE_MULTI(2, 7)
    IFE_MULTI(3, 2) IFE_MULTI(3, 4)
    IFE_MULTI(4, 2)
#undef IFE_MULTI
    return (int)cudaErrorInvalidValue;
}
