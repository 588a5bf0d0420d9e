// The whole features8 pass as one line sweep along x: normalized Gaussian
// smoothing s = G*(c*f) / G*c of the image f with the clamped mask c, then
// the shared tail (|grad s|, Hessian, eigen features), masked by a select.
//
// Replaces ife_tpu/kernels/fused.py:fused_features8_sweep (kernel
// _features8_sweep_kernel) and, in features8_xs_stream_kernel,
// fused_features8_xs_stream (kernel _features8_xs_stream_kernel), whose
// input arrives already smoothed along y and z (ife_smooth_yz in
// normalized_conv.cu) and which adds only the x pass and the divide before
// the tail. Both TPU kernels swept x with a VMEM ring of input rows.
//
// features8_sweep_kernel<RX>: sweep_passes.cuh describes the block and its
// passes. One thread per cell of the s region keeps the x pass's 2 * RX + 1
// numerators and denominators of its cell in registers; the x radius is a
// template parameter so that the queue's slots and the x taps (operands
// straight from the kernel's parameters) are fixed at compile time. A switch
// over the queue's phase, one case per slot, stands in for the rotation.
// The block sweeps the planes of its chunk between the first and the last
// on which its tile holds a voxel inside the mask, and stores zeros on the
// others. Per raw plane q it
//   1. asks for plane q + 1 (cp.async) and runs the y pass of plane q;
//   2. barrier; every thread runs the z pass of its cell, pushes the result
//      into its queue, sums the queue in tap order, divides (no epsilon) and
//      writes s of plane p = q - RX into the ring of three s planes; then it
//      finishes its elements of plane q + 1;
//   3. barrier; the tail emits plane p - 1.
// Two barriers a plane, and the tail of one plane runs into the load and the
// y pass of the next with none between. Shared memory holds two raw planes,
// one y pass and three s planes (37 KB at sigma 1.2 / 0.78 mm), so the
// blocks on an SM are set by the registers: 2 * (2 * RX + 1) of the queue
// plus the tail's.
//
// The passes run y, z, then x, in the order and tap association of the plain
// twin (smooth_yz_plain, then the x pass of features8_xs_stream_plain), and
// the library is built without FMA contraction, so the kernel agrees with its
// twin to the bit.
//
// True faces: s is computed at clamped positions but read only at
// positions inside the volume: the tail looks its neighbours up at clamped
// indices, so at a face the phantom neighbour is s at the face itself, not
// the smoothing evaluated at a virtual position (the round-5 bug family of
// the TPU kernels). The y/z halo of the extended tile holds the clamped
// input rows, which is the ZeroFluxNeumann pad of the plain passes.
//
// Shard blocks: the sweep takes the four face clamps of s_ring.cuh (the
// clamp_ref operand of the TPU kernels). On a halo-extended shard block the
// smoothing reads the halo as data, and the tail's phantom clamps to the
// smoothed field at the kept core's true faces only; the default, the
// array's own faces, is the whole-volume kernel to the bit.
//
// What bounds it on the H100: the instructions of the SMs, not memory. HBM
// sees the image and mask once and the 8 channels written once (40 B per
// voxel). With the queue and the tail in its registers a block has 17 warps
// and an SM holds one block, so every pass is short of warps to hide its
// own latencies (dropping the barriers changes nothing); what helps is work
// not done: the planes and tails the mask leaves empty, a divide that steps
// around 0/0. Per voxel of a swept plane the block issues the FIR's unfused
// multiplies and adds (~2 * 2 * (2r + 1) per pass, times the halo's share:
// 1.6 for y, 1.2 for z and x), one shared-memory load per four of them in
// the y pass and per two in the z pass, none in the x pass, and the tail's
// ~150 operations and 19 loads.
//
// features8_xs_stream_kernel (below) keeps its x ring in shared memory: it
// serves the x radii beyond kSweepMaxRx, where a register queue would not
// fit a thread.
#include <cuda_runtime.h>

#include "sweep_passes.cuh"

// Push (vn, vd) into slot kPhase of the queue and, when `live`, sum the
// queue in tap order: tap k multiplies the plane 2 * RX - k pushes ago, slot
// (kPhase + 1 + k) % W.
template <int W, int kPhase>
__device__ __forceinline__ void x_queue_step_at(float (&qn)[W], float (&qd)[W],
                                                float vn, float vd,
                                                const Taps& tx, bool live,
                                                float& an, float& ad) {
    qn[kPhase] = vn;
    qd[kPhase] = vd;
    if (!live) return;
#pragma unroll
    for (int k = 0; k < W; ++k) {
        const int j = (kPhase + 1 + k) % W;
        const float w = tx.t[k];
        an = k == 0 ? w * qn[j] : an + w * qn[j];
        ad = k == 0 ? w * qd[j] : ad + w * qd[j];
    }
}

template <int W>
__device__ __forceinline__ void x_queue_step(int phase, float (&qn)[W],
                                             float (&qd)[W], float vn,
                                             float vd, const Taps& tx,
                                             bool live, float& an, float& ad) {
    switch (phase) {
#define IFE_X_CASE(P)                                                     \
    case P:                                                               \
        if constexpr (P < W)                                              \
            x_queue_step_at<W, P>(qn, qd, vn, vd, tx, live, an, ad);      \
        break;
        IFE_QUEUE_CASES(IFE_X_CASE)
#undef IFE_X_CASE
    }
}

// image f, raw mask (clamped here to the certainty c and used as the output
// mask); tx.r == RX.
template <int RX>
__global__ void __launch_bounds__(kSweepThreads, 1)
features8_sweep_kernel(const float* __restrict__ image,
                       const float* __restrict__ mask, float* __restrict__ out,
                       int X, int Y, int Z, int chunk_x, Taps tx, Taps ty,
                       Taps tz, StencilRecip k, FaceClamps fc) {
    extern __shared__ float smem[];
    constexpr int SY = kSweepSY, SZ = kSweepSZ, NC = kSweepCells;
    constexpr int W = 2 * RX + 1;
    const int ry = ty.r, rz = tz.r;
    const int z0 = blockIdx.x * kSweepTileZ;
    const int y0 = blockIdx.y * kSweepTileY;
    const RawTile tile = make_raw_tile(y0, z0, ry, rz, Y, Z);
    const int stride = sweep_ybuf_stride(rz);
    float* raw = smem;                    // [2 buffers][c*f, c][tile.n]
    float* qn = raw + 4 * tile.n;         // [SY][stride] y pass, numerator
    float* qd = qn + SY * stride;         // [SY][stride] y pass, denominator
    float* ring = qd + SY * stride;       // [3][NC] s planes

    const int xa = blockIdx.z * chunk_x;
    const int xb = min(xa + chunk_x, X);
    const long long plane = (long long)Y * Z;
    // the planes of the chunk that hold a voxel inside the mask: the rest
    // are zeros, and need no s
    __shared__ int span[2];
    int x_first, x_last;
    const SweepColumns g = sweep_columns(y0, z0, Y, Z);
    column_span(mask, g, xa, xb, span, x_first, x_last);
    column_zeros(out, X * plane, g, xa, xb, x_first, x_last);
    if (x_first > x_last) return;  // the same for every thread of the block
    // s planes this block needs, and the input planes (clamped) behind them
    const int p_lo = max(x_first - 1, 0);
    const int p_hi = min(x_last + 1, X - 1);
    const int q_lo = p_lo - RX, q_hi = p_hi + RX;
    // this thread's cell of the s region, in the y pass buffer
    const int cell = (threadIdx.x / SZ) * stride + threadIdx.x % SZ;
    const YItem y_first = sweep_y_item(sweep_y_first_index(), tile.n, tile.PZ,
                                       0, 0, tile.PZ, stride);

    float xn[W], xd[W];
#pragma unroll
    for (int i = 0; i < W; ++i) xn[i] = xd[i] = 0.0f;

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
        sweep_y_pass(y_first, pn, tile.n, tile.PZ, 0, 0, tile.PZ, ty, qn,
                     stride);
        __syncthreads();

        float vn, vd, an = 0.0f, ad = 0.0f;
        sweep_z_pass(qn, qd, cell, tz, vn, vd);
        const int p = q - RX;  // the queue now holds planes p - RX .. p + RX
        const bool live = p >= p_lo;
        x_queue_step<W>(phase, xn, xd, vn, vd, tx, live, an, ad);
        phase = phase + 1 == W ? 0 : phase + 1;
        if (live)
            ring[(p % 3) * NC + threadIdx.x] = sweep_divide(an, ad);
        if (q < q_hi) sweep_finish_raw(tile, nn, nn + tile.n);
        __syncthreads();
        if (live)
            sweep_emit<true>(ring, p, x_first, x_last + 1, X, Y, Z, y0, z0,
                             mask, out, k, fc);
        // What the next iteration overwrites was last read before a barrier
        // every thread has passed: the buffer of plane q by this y pass
        // (before the first barrier), the y pass buffer by this z pass
        // (before the second), the s slot of plane p + 1 by the tail of
        // plane p - 2, one iteration back.
    }
}

template <int RX>
static int launch_sweep_rx(const float* image, const float* mask, float* out,
                           long long X, long long Y, long long Z,
                           const Taps& tx, const Taps& ty, const Taps& tz,
                           const StencilRecip& k, const FaceClamps& fc,
                           cudaStream_t stream) {
    const size_t smem = sweep_smem_floats(ty.r, tz.r) * sizeof(float);
    if (smem > (size_t)kSweepMaxSmem) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            features8_sweep_kernel<RX>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int chunk = sweep_chunk_x(X, RX);
    features8_sweep_kernel<RX><<<sweep_grid(X, Y, Z, chunk), kSweepThreads,
                                 smem, stream>>>(
        image, mask, out, (int)X, (int)Y, (int)Z, chunk, tx, ty, tz, k, fc);
    return (int)cudaGetLastError();
}

// image, mask: contiguous (X, Y, Z) float32 (the mask raw, clamped to [0, 1]
// here), Y * Z < 2^31; out: contiguous (8, X, Y, Z); taps_*: host arrays of
// 2r+1 floats, the x radius at most kSweepMaxRx; x_lo .. y_hi: the face
// clamps (0, X - 1, 0, Y - 1 for a whole volume).
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
    if (!make_faces(x_lo, x_hi, y_lo, y_hi, &fc) || Y * Z >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    Taps tx, ty, tz;
    if (!make_taps(taps_x, ntx, &tx) || !make_taps(taps_y, nty, &ty)
        || !make_taps(taps_z, ntz, &tz))
        return (int)cudaErrorInvalidValue;
    const StencilRecip k{r2x, r2y, r2z, rxx, ryy, rzz};
    switch (tx.r) {
#define IFE_SWEEP_RX(R)                                                  \
    case R:                                                              \
        return launch_sweep_rx<R>(image, mask, out, X, Y, Z, tx, ty, tz, \
                                  k, fc, stream);
        IFE_SWEEP_RX(0) IFE_SWEEP_RX(1) IFE_SWEEP_RX(2) IFE_SWEEP_RX(3)
        IFE_SWEEP_RX(4) IFE_SWEEP_RX(5) IFE_SWEEP_RX(6) IFE_SWEEP_RX(7)
        IFE_SWEEP_RX(8) IFE_SWEEP_RX(9) IFE_SWEEP_RX(10)
#undef IFE_SWEEP_RX
    }
    static_assert(kSweepMaxRx == 10, "one case per instantiated x radius");
    return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// the x pass alone, from y/z-smoothed inputs: a shared-memory ring
// ---------------------------------------------------------------------------
//
// features8_xs_stream_kernel serves the x radii beyond kSweepMaxRx. Its x
// ring of 2rx + 1 numerator and denominator planes cannot live in registers
// as the sweep's queue does: 2 * (2rx + 1) = 46-98 floats at rx 11-24
// beside the tail's, over the 120 registers a thread of a 544-thread block
// may have, and over two threads a cell it would need 1088 threads for the
// 544 cells of the sweep's tile, more than a block may have. So the ring is
// in shared memory: 2rx + 2 slots of each (the window and the plane in
// flight) on the s region of the block's tile. That makes the tile the knob.
// The kernel is limited by the latency of its per-cell x pass (two
// shared-memory loads, two multiplies and two dependent adds a tap) and of
// the tail, which only more warps on an SM hide: measured at 512^3 under the
// sphere mask (NVIDIA H100 80GB HBM3, 700 W), 17 resident warps (one block
// of the 14-row tile) took 4.0-4.3 ms at rx 14-20, 22 warps (two blocks of 8
// rows) 3.6-3.7, 27 warps (three blocks of 6 rows) 3.4, and 34 warps at rx
// 11 (two blocks of 14 rows) 3.0-3.1, where 6 or 8 rows added nothing; the
// narrower tile's larger halo (1.42 cells a voxel at 6 rows against 1.21 at
// 14) costs less than the warps it buys, down to a point: at rx 14 four rows
// (28 warps, 1.59 cells a voxel) took 3.66 ms against 3.40 for six. The
// kernel is instantiated for tiles of 14, 8, 6 and 4 rows (kXsTiles), and
// the launcher takes the one whose warps resident on an SM at this radius's
// ring (CUDA's occupancy query), times the share of its cells that are its
// own voxels' (rows / (rows + 2)), are the most, the wider on a tie. Each
// instantiation does what the sweep's redesign showed pays on the card:
//   * a block sweeps only the planes of its chunk between the first and the
//     last on which its tile holds a voxel inside the mask, plus one each
//     side for the stencil (tile_mask_span), and stores zeros on the rest
//     (tile_zero_planes); the tail is skipped per voxel outside the mask
//     (s_ring.cuh);
//   * the first window of 2rx + 1 planes is asked for at once, and from then
//     on plane q + 1's two inputs are in flight (cp.async, into the ring's
//     spare slot) while plane q's window is summed and the tail runs;
//   * one thread per cell: the x pass of a cell is one thread's loop over
//     2rx + 1 ring slots in tap order (two runs of consecutive slots, no
//     wrap test per tap), and the divide steps around 0/0 (sweep_divide).
// Two barriers a plane. HBM sees the two inputs and the mask once (planes
// re-read at chunk ends come from L2) and the eight channels written once.

constexpr int kXsMinTileY = 4;  // the narrowest tile (kXsTiles' last)

template <int kTileY>
struct XsTile {
    static constexpr int kCells = (kTileY + 2) * kSweepSZ;  // the s region
    static constexpr int kThreads = (kCells + 31) / 32 * 32;  // one a cell
};

// Shared memory, in floats, of a block of `cells` s cells at x radius rx:
// the x ring of numerator and denominator (2 * (2rx + 2) * cells) and the
// ring of three s planes.
__host__ __device__ inline size_t xs_stream_smem_floats(int rx, int cells) {
    return 2 * (size_t)(2 * rx + 2) * cells + 3 * (size_t)cells;
}

// x planes per block: about 16 (rx + 1), but the chunks of X equal (a short
// last chunk would re-read its 2rx + 2 planes of overlap for little work)
__host__ inline int xs_stream_chunk_x(long long X, int rx) {
    const long long want = std::max(64, 16 * (rx + 1));
    const long long n = (X + want - 1) / want;
    return (int)((X + n - 1) / n);
}

// a, b = G_z G_y (c*f), G_z G_y c; mask = the clamped mask. The ring has
// S = 2rx + 2 slots; input plane q lives in slot (q - q_lo) % S.
template <int kTileY>
__global__ void __launch_bounds__(XsTile<kTileY>::kThreads)
features8_xs_stream_kernel(const float* __restrict__ a,
                           const float* __restrict__ b,
                           const float* __restrict__ mask,
                           float* __restrict__ out, int X, int Y, int Z,
                           int chunk_x, Taps tx, StencilRecip k) {
    extern __shared__ float smem[];
    constexpr int SZ = kSweepSZ, NC = XsTile<kTileY>::kCells;
    constexpr int kThreads = XsTile<kTileY>::kThreads;
    const int rx = tx.r;
    const int W = 2 * rx + 1;     // the window of one s plane
    const int S = W + 1;          // ring slots: the window and one in flight
    float* rn = smem;             // [S][NC] x ring, numerator
    float* rd = rn + S * NC;      // [S][NC] x ring, denominator
    float* ring = rd + S * NC;    // [3][NC] s planes

    const int z0 = blockIdx.x * kSweepTileZ;
    const int y0 = blockIdx.y * kTileY;
    const int xa = blockIdx.z * chunk_x;
    const int xb = min(xa + chunk_x, X);
    const long long plane = (long long)Y * Z;
    const FaceClamps fc = whole_volume_faces(X, Y);

    __shared__ int span[2];
    int x_first, x_last;
    tile_mask_span<kTileY, kSweepTileZ, kThreads>(mask, xa, xb, y0, z0, Y, Z,
                                                  span, x_first, x_last);
    tile_zero_planes<kTileY, kSweepTileZ, kThreads>(out, xa, xb, x_first,
                                                    x_last, X, Y, Z, y0, z0);
    if (x_first > x_last) return;  // the same for every thread of the block
    const int p_lo = max(x_first - 1, 0);
    const int p_hi = min(x_last + 1, X - 1);
    const int q_lo = p_lo - rx;

    // this thread's cell (none for the threads past the last cell): its
    // offset within an x plane
    const int cell = threadIdx.x;
    const bool has_cell = cell < NC;
    const long long cell_off =
        (long long)clamp_index(y0 - 1 + cell / SZ, Y) * Z
        + clamp_index(z0 - 1 + cell % SZ, Z);
    auto issue = [&](int q) {
        if (!has_cell) return;
        const long long src = (long long)clamp_index(q, X) * plane + cell_off;
        const int e = ((q - q_lo) % S) * NC + cell;
        cp_async_f32(rn + e, a + src);
        cp_async_f32(rd + e, b + src);
    };

    // the first window: planes q_lo .. q_lo + 2rx
    for (int q = q_lo; q < q_lo + W; ++q) issue(q);
    cp_async_wait_all();
    __syncthreads();
    for (int p = p_lo; p <= p_hi; ++p) {
        const int q = p + rx;  // the window's newest plane
        if (p < p_hi) issue(q + 1);
        if (has_cell) {
            // the x pass of plane p: tap t reads plane p - rx + t, from slot
            // first + t in two runs of consecutive slots
            const int first = (p - p_lo) % S;
            const int run = min(W, S - first);
            const float* en = rn + first * NC + cell;
            const float* ed = rd + first * NC + cell;
            float an = tx.t[0] * en[0], ad = tx.t[0] * ed[0];
            int t = 1;
            for (; t < run; ++t) {
                an = an + tx.t[t] * en[t * NC];
                ad = ad + tx.t[t] * ed[t * NC];
            }
            for (int sl = 0; t < W; ++t, ++sl) {
                an = an + tx.t[t] * rn[sl * NC + cell];
                ad = ad + tx.t[t] * rd[sl * NC + cell];
            }
            ring[(p % 3) * NC + cell] = sweep_divide(an, ad);
        }
        __syncthreads();
        sweep_emit<false, kTileY>(ring, p, x_first, x_last + 1, X, Y, Z, y0,
                                  z0, mask, out, k, fc);
        cp_async_wait_all();
        __syncthreads();
        // The next iteration writes the slot of plane p - rx, which this x
        // pass read before the first barrier, and the s slot of plane p - 2,
        // which this tail read before the second.
    }
}

// Set the instantiation's shared memory for this radius and ask how many of
// its blocks an SM holds; 0 when the ring does not fit a block.
template <int kTileY>
static int xs_stream_blocks_per_sm(int rx, size_t* smem) {
    *smem = xs_stream_smem_floats(rx, XsTile<kTileY>::kCells) * sizeof(float);
    if (*smem > (size_t)kSweepMaxSmem) return 0;
    if (cudaFuncSetAttribute(features8_xs_stream_kernel<kTileY>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)*smem) != cudaSuccess)
        return 0;
    int blocks = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, features8_xs_stream_kernel<kTileY>,
            XsTile<kTileY>::kThreads, *smem) != cudaSuccess)
        return 0;
    return blocks;
}

template <int kTileY>
static void xs_stream_launch(const float* a, const float* b,
                             const float* mask, float* out, long long X,
                             long long Y, long long Z, const Taps& tx,
                             const StencilRecip& k, size_t smem,
                             cudaStream_t stream) {
    const int chunk = xs_stream_chunk_x(X, tx.r);
    const dim3 grid((unsigned)((Z + kSweepTileZ - 1) / kSweepTileZ),
                    (unsigned)((Y + kTileY - 1) / kTileY),
                    (unsigned)((X + chunk - 1) / chunk));
    features8_xs_stream_kernel<kTileY>
        <<<grid, XsTile<kTileY>::kThreads, smem, stream>>>(
            a, b, mask, out, (int)X, (int)Y, (int)Z, chunk, tx, k);
}

// One entry per instantiated tile: its rows, its threads, and the two
// functions above.
struct XsTileEntry {
    int rows, threads;
    int (*blocks_per_sm)(int rx, size_t* smem);
    void (*launch)(const float*, const float*, const float*, float*,
                   long long, long long, long long, const Taps&,
                   const StencilRecip&, size_t, cudaStream_t);
};

template <int kTileY>
constexpr XsTileEntry xs_tile_entry() {
    return {kTileY, XsTile<kTileY>::kThreads, xs_stream_blocks_per_sm<kTileY>,
            xs_stream_launch<kTileY>};
}

static const XsTileEntry kXsTiles[] = {xs_tile_entry<14>(), xs_tile_entry<8>(),
                                       xs_tile_entry<6>(),
                                       xs_tile_entry<kXsMinTileY>()};

// num_yz, den_yz: the y/z-smoothed numerator and denominator; mask: the
// clamped {0, 1} mask; all contiguous (X, Y, Z) float32, Y * Z < 2^31; out:
// (8, X, Y, Z). The tile: of kXsTiles, the one with the most warps resident
// on an SM at this x radius, weighted by rows / (rows + 2), the wider on a
// tie.
extern "C" int ife_features8_xs_stream(const float* num_yz,
                                       const float* den_yz, const float* mask,
                                       float* out, long long X, long long Y,
                                       long long Z,
                                       const float* taps_x, long long ntx,
                                       float r2x, float r2y, float r2z,
                                       float rxx, float ryy, float rzz,
                                       cudaStream_t stream) {
    Taps tx;
    if (!make_taps(taps_x, ntx, &tx) || Y * Z >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    const StencilRecip k{r2x, r2y, r2z, rxx, ryy, rzz};
    const XsTileEntry* best = nullptr;
    float best_score = 0.0f;
    size_t best_smem = 0;
    for (const XsTileEntry& e : kXsTiles) {
        size_t smem;
        const int warps = e.blocks_per_sm(tx.r, &smem) * e.threads / 32;
        const float score = warps * (float)e.rows / (float)(e.rows + 2);
        if (score > best_score) best = &e, best_score = score, best_smem = smem;
    }
    if (best == nullptr) return (int)cudaErrorInvalidValue;
    best->launch(num_yz, den_yz, mask, out, X, Y, Z, tx, k, best_smem, stream);
    return (int)cudaGetLastError();
}
