// The pieces of the features8 line sweep that its single-scale kernel
// (features8_sweep.cu) and its multi-scale kernel (features8_sweep_multi.cu)
// share: the block's geometry, the asynchronous load of a raw plane, the y
// pass, the z pass and the register queue of the x pass.
//
// A block of kSweepThreads threads owns a (y, z) tile of kSweepTileY x
// kSweepTileZ voxels and a chunk of x. The smoothed field s is needed on the
// tile plus a one-voxel halo: kSweepSY x kSweepSZ = 544 cells, and the block
// has exactly one thread per cell. Before the sweep the block finds the
// planes of its chunk on which its tile holds a voxel inside the mask
// (column_span): it sweeps only those (plus one each side, for the
// stencil) and stores zeros on the rest, so the time follows the mask: a
// lung or a sphere leaves most planes of most tiles empty. Per raw plane q
// of the sweep:
//
//   load    image and mask on the s region extended by the y and z radii, at
//           clamped positions (the ZeroFluxNeumann pad), by cp.async, one
//           element each, into the buffer the passes do not read: plane
//           q + 1 is in flight while plane q is computed. The thread that
//           asked for an element turns it, once it has arrived, into
//           c = clamp(mask, 0, 1) and c*f (rounded once, as the twin does)
//           in place. A face tile needs no patching: the clamped address is
//           the pad. (A TMA tile load would fill the cells beyond a face with
//           zero, which is not the clamped row the pad needs.)
//   y pass  kSweepRunY consecutive y outputs of one column and one array
//           from one walk over the kSweepRunY + 2ry inputs they share
//           (fir_run): one shared-memory load and one tap per kSweepRunY
//           multiply-adds; lanes run along z, so no bank conflicts;
//   z pass  every thread sums the 2rz + 1 taps of ITS cell, numerator and
//           denominator, from the y pass buffer, whose rows are padded so
//           that a warp's 32 cells (which span two rows of 34) hit 32 banks;
//           the result stays in registers;
//   x pass  the thread keeps the last 2rx + 1 y/z-smoothed numerators and
//           denominators of its cell in a register queue, sums them in tap
//           order, divides, and writes s to a ring of three planes in shared
//           memory, from which the tail (s_ring.cuh) emits plane p - 1.
//
// Every sum keeps the twin's association (tap 0's product first, then one
// add per tap) and the library is built without FMA contraction, so the
// kernels equal their plain twins to the bit.
//
// No tensor cores: a banded-matrix FIR on wgmma would run in TF32 (10-bit
// mantissa), the package turns TF32 off, and the kernels are held to their
// f32 twins to the bit. The units to fill are the f32 pipes and the
// shared-memory port.
#pragma once

#include <cuda_runtime.h>

#include "features8_tail.cuh"
#include "fir.cuh"
#include "s_ring.cuh"

constexpr int kSweepTileY = 14;
constexpr int kSweepTileZ = 32;
constexpr int kSweepSY = kSweepTileY + 2;  // s region: the tile + 1 halo
constexpr int kSweepSZ = kSweepTileZ + 2;
constexpr int kSweepCells = kSweepSY * kSweepSZ;
constexpr int kSweepThreads = kSweepCells;  // one thread per s cell: 17 warps
constexpr int kSweepRunY = 4;               // divides kSweepSY
constexpr int kSweepMaxRx = 10;             // the x radii instantiated
constexpr int kSweepMaxSmem = 227 * 1024;
// elements of the raw plane a thread loads whose global offsets it keeps in
// registers for the whole sweep (4 * 544 = 2176 cells: ry, rz <= 10); a
// larger plane computes the offsets of the rest anew per plane
constexpr int kSweepLoadRegs = 4;

// row stride of the y pass buffer: >= SZ + 2rz and = SZ modulo 32, so that
// cell (i, j) and cell (i + 1, j - 32) never share a bank
__host__ __device__ inline int sweep_ybuf_stride(int rz) {
    return kSweepSZ + (2 * rz + 31) / 32 * 32;
}

// Shared memory of the single sweep, in floats: two buffers of the raw
// plane (c*f and c on (SY + 2ry) x (SZ + 2rz) cells), the y pass of both
// arrays, three s planes. The x queue lives in registers: rx does not count.
__host__ __device__ inline size_t sweep_smem_floats(int ry, int rz) {
    const size_t py = kSweepSY + 2 * ry, pz = kSweepSZ + 2 * rz;
    return 4 * py * pz + 2 * (size_t)kSweepSY * sweep_ybuf_stride(rz)
        + 3 * kSweepCells;
}

// x planes per block: the 2rx + 2 planes a chunk re-sweeps cost 1/16 of it
__host__ inline int sweep_chunk_x(long long X, int rx) {
    return (int)std::min<long long>(X, std::max(128, 32 * (rx + 1)));
}

// The raw plane of a block: (SY + 2ry) x (SZ + 2rz) cells, cell (i, j) at
// global (clamp(y0 - 1 - ry + i), clamp(z0 - 1 - rz + j)).
struct RawTile {
    int PZ, n;                 // row length, cells
    int y0, z0, ry, rz, Y, Z;
    int off[kSweepLoadRegs];   // y * Z + z of cell threadIdx.x + k * threads

    __device__ __forceinline__ int offset(int idx) const {
        const int i = idx / PZ, j = idx - i * PZ;
        return clamp_index(y0 - 1 - ry + i, Y) * Z
            + clamp_index(z0 - 1 - rz + j, Z);
    }
};

__device__ __forceinline__ RawTile make_raw_tile(int y0, int z0, int ry,
                                                 int rz, int Y, int Z) {
    RawTile t;
    t.PZ = kSweepSZ + 2 * rz;
    t.n = (kSweepSY + 2 * ry) * t.PZ;
    t.y0 = y0, t.z0 = z0, t.ry = ry, t.rz = rz, t.Y = Y, t.Z = Z;
#pragma unroll
    for (int k = 0; k < kSweepLoadRegs; ++k) {
        const int idx = threadIdx.x + k * kSweepThreads;
        t.off[k] = idx < t.n ? t.offset(idx) : 0;
    }
    return t;
}

// Ask for image and mask of one x plane (pointers to its first voxel) into
// pn and pd; returns at once.
__device__ __forceinline__ void sweep_issue_raw(
    const float* __restrict__ image, const float* __restrict__ mask,
    const RawTile& t, float* pn, float* pd) {
#pragma unroll
    for (int k = 0; k < kSweepLoadRegs; ++k) {
        const int idx = threadIdx.x + k * kSweepThreads;
        if (idx < t.n) {
            cp_async_f32(pn + idx, image + t.off[k]);
            cp_async_f32(pd + idx, mask + t.off[k]);
        }
    }
    for (int idx = threadIdx.x + kSweepLoadRegs * kSweepThreads; idx < t.n;
         idx += kSweepThreads) {
        const int off = t.offset(idx);
        cp_async_f32(pn + idx, image + off);
        cp_async_f32(pd + idx, mask + off);
    }
}

// Wait for this thread's elements of a raw buffer of n cells and turn them
// into c*f and c in place. The caller's next barrier shows them to the block.
__device__ __forceinline__ void sweep_finish_raw(int n, float* pn, float* pd) {
    cp_async_wait_all();
    for (int idx = threadIdx.x; idx < n; idx += kSweepThreads) {
        const float c = clamp_unit_mask(pd[idx]);
        pn[idx] = pn[idx] * c;  // c*f rounded, as plain
        pd[idx] = c;
    }
}

__device__ __forceinline__ void sweep_finish_raw(const RawTile& t, float* pn,
                                                 float* pd) {
    sweep_finish_raw(t.n, pn, pd);
}

// kRun consecutive outputs of a tap-ordered FIR from one walk:
// acc[u] = sum_k t[k] * in[(u + k) * stride], tap 0's product first. The kRun
// inputs a tap touches sit in a window of registers that takes one new input
// per tap; the taps go in groups of kRun so that the window's slots are
// known at compile time. One load and one tap per kRun multiply-adds.
template <int kRun, class TapsT>
__device__ __forceinline__ void fir_run(const float* in, int stride,
                                        const TapsT& taps,
                                        float (&acc)[kRun]) {
    float win[kRun];  // input m lives in slot m % kRun
#pragma unroll
    for (int u = 0; u < kRun; ++u) win[u] = in[u * stride];
    const float w0 = taps.t[0];
#pragma unroll
    for (int u = 0; u < kRun; ++u) acc[u] = w0 * win[u];
    const int nt = 2 * taps.r + 1;
    int k = 1;  // k = 1 modulo kRun at the head of every group
    for (; k + kRun <= nt; k += kRun) {
#pragma unroll
        for (int j = 0; j < kRun; ++j) {
            win[j] = in[(k + j + kRun - 1) * stride];
            const float w = taps.t[k + j];
#pragma unroll
            for (int u = 0; u < kRun; ++u)
                acc[u] = acc[u] + w * win[(1 + j + u) % kRun];
        }
    }
#pragma unroll
    for (int j = 0; j < kRun - 1; ++j) {
        if (k + j < nt) {
            win[j] = in[(k + j + kRun - 1) * stride];
            const float w = taps.t[k + j];
#pragma unroll
            for (int u = 0; u < kRun; ++u)
                acc[u] = acc[u] + w * win[(1 + j + u) % kRun];
        }
    }
}

// The y pass of both arrays: q[a][i][j] = sum_t ty[t] * p[a][row0 + i + t]
// [col0 + j] for the SY x pz cells the z pass needs (row0 = col0 = 0 and
// pz = src_pz when the plane was loaded with this scale's own radii). An
// item is one array, one group of kSweepRunY rows and one column: 8 * pz of
// them a plane. YItem is where an item reads (its first input, in the raw
// buffer whose two arrays lie raw_n floats apart) and writes (in the y pass
// buffer, whose two arrays lie SY * q_stride apart).
struct YItem {
    int in, out;
};

__device__ __forceinline__ YItem sweep_y_item(int item, int raw_n, int src_pz,
                                              int row0, int col0, int pz,
                                              int q_stride) {
    constexpr int kGroups = kSweepSY / kSweepRunY;
    const int sr = item / pz, j = item - sr * pz;
    const int i0 = (sr % kGroups) * kSweepRunY;
    const int den = sr / kGroups;
    return YItem{den * raw_n + (row0 + i0) * src_pz + col0 + j,
                 den * kSweepSY * q_stride + i0 * q_stride + j};
}

template <class TapsT>
__device__ __forceinline__ void sweep_y_run(const YItem& it, const float* raw,
                                            int src_pz, const TapsT& ty,
                                            float* q, int q_stride) {
    float acc[kSweepRunY];
    fir_run<kSweepRunY>(raw + it.in, src_pz, ty, acc);
#pragma unroll
    for (int u = 0; u < kSweepRunY; ++u) q[it.out + u * q_stride] = acc[u];
}

// The items are dealt from the last thread down, because the tail of the
// plane before, which runs just ahead of this pass without a barrier
// between, keeps the first 448 threads busy. `first` is this thread's first
// item, worked out once for the whole sweep (sweep_y_first); any further
// item (a z radius beyond 17) is worked out per plane.
__device__ __forceinline__ int sweep_y_first_index() {
    return kSweepThreads - 1 - threadIdx.x;
}

template <class TapsT>
__device__ __forceinline__ void sweep_y_pass(const YItem& first,
                                             const float* raw, int raw_n,
                                             int src_pz, int row0, int col0,
                                             int pz, const TapsT& ty, float* q,
                                             int q_stride) {
    constexpr int kItemsPerColumn = 2 * kSweepSY / kSweepRunY;
    if (sweep_y_first_index() < kItemsPerColumn * pz)
        sweep_y_run(first, raw, src_pz, ty, q, q_stride);
    for (int item = sweep_y_first_index() + kSweepThreads;
         item < kItemsPerColumn * pz; item += kSweepThreads)
        sweep_y_run(sweep_y_item(item, raw_n, src_pz, row0, col0, pz, q_stride),
                    raw, src_pz, ty, q, q_stride);
}

// s = num / den without epsilon: 0/0 = NaN off the support. A zero
// denominator is stepped around: x / +-0 = x * +-inf in every case (0 and NaN
// give NaN, the rest the signed infinity), and the divide's slow path, which
// every cell off the support would take, is not run.
__device__ __forceinline__ float sweep_divide(float num, float den) {
    return den == 0.0f ? num * copysignf(INFINITY, den) : num / den;
}

// The z pass of one cell: e is the cell's offset in the y pass buffer
// (row * stride + column).
template <class TapsT>
__device__ __forceinline__ void sweep_z_pass(const float* qn, const float* qd,
                                             int e, const TapsT& tz,
                                             float& vn, float& vd) {
    const float w0 = tz.t[0];
    vn = w0 * qn[e];
    vd = w0 * qd[e];
    for (int t = 1; t <= 2 * tz.r; ++t) {
        const float w = tz.t[t];
        vn = vn + w * qn[e + t];
        vd = vd + w * qd[e + t];
    }
}

// Emit plane p - 1 (its x + 1 neighbour is p) where it lies in [xa, xb), and
// at the last true plane also plane p itself (x + 1 clamps to p), from a
// ring of three s planes of a (kTileY, kSweepTileZ) tile.
template <bool kClampMask, int kTileY = kSweepTileY>
__device__ __forceinline__ void sweep_emit(const float* ring, int p, int xa,
                                           int xb, int X, int Y, int Z, int y0,
                                           int z0, const float* mask,
                                           float* out, const StencilRecip& k,
                                           const FaceClamps& fc) {
    for (int x = max(p - 1, xa); x <= (p == X - 1 ? p : p - 1); ++x) {
        if (x >= xb) break;
        emit_features8_plane<kTileY, kSweepTileZ, kClampMask>(
            ring, x, X, Y, Z, y0, z0, mask, out, k, fc);
    }
}

// The columns of a block that sweeps along one axis: its tile is
// kSweepTileY rows (u0 .. along an axis of nu voxels, u_stride floats apart)
// by kSweepTileZ voxels of z (z0 ..); thread t < kSweepTileY * kSweepTileZ
// owns tile voxel (t / kSweepTileZ, t % kSweepTileZ), and its column holds
// that voxel at every step of the sweep, `step` floats apart. The sweeps
// take (y, z) tiles and step along x; the tap kernel (features8_tap.cu)
// takes (x, z) tiles and steps along y. The functions below take the
// geometry, not a thread's column, so that a kernel held to few registers
// keeps nothing live across their calls.
struct SweepColumns {
    int u0, nu, z0, Z;
    long long u_stride, step;

    // this thread's column at step 0 in `off`; false when it has none
    __device__ __forceinline__ bool column(long long& off) const {
        const int u = u0 + threadIdx.x / kSweepTileZ;
        const int z = z0 + threadIdx.x % kSweepTileZ;
        off = u * u_stride + z;
        return threadIdx.x < kSweepTileY * kSweepTileZ && u < nu && z < Z;
    }
};

// The steps [a, b) at which one of the block's columns holds a voxel inside
// the mask: first .. last (first > last when there is none). Outside the
// mask every channel is 0 whatever s is, so only the s planes (rows)
// first - 1 .. last + 1 are ever read: the block sweeps those and stores
// zeros on the other steps of its chunk (column_zeros). On a lung mask or a
// sphere most of a volume's planes fall away here. span: two ints of shared
// memory. Not inlined (nor is column_zeros): they run once, ahead of the
// sweep, and must not cost the sweep's loop a register.
static __device__ __noinline__ void column_span(const float* __restrict__ mask,
                                                SweepColumns g, int a, int b,
                                                int* span, int& first,
                                                int& last) {
    constexpr int kBatch = 8;  // steps a thread looks at between barriers
    if (threadIdx.x == 0) {
        span[0] = b;
        span[1] = a - 1;
    }
    __syncthreads();
    long long off;
    const bool mine = g.column(off);
    const float* col = mask + off;
    // from the front, a batch of steps at a time, until one holds a voxel
    // inside; then from the back. A dense mask ends both after one batch.
    first = b;
    last = a - 1;
    for (int xs = a; xs < b; xs += kBatch) {
        int lo = b;
        if (mine) {
#pragma unroll
            for (int j = kBatch - 1; j >= 0; --j)
                if (xs + j < b
                    && clamp_unit_mask(__ldg(col + (xs + j) * g.step)) != 0.0f)
                    lo = xs + j;
        }
        if (__syncthreads_or(lo < b)) {
            lo = __reduce_min_sync(0xffffffffu, lo);
            if (threadIdx.x % 32 == 0) atomicMin(&span[0], lo);
            __syncthreads();
            first = span[0];
            break;
        }
    }
    if (first == b) return;
    for (int xs = b - 1; xs >= first; xs -= kBatch) {
        int hi = a - 1;
        if (mine) {
#pragma unroll
            for (int j = kBatch - 1; j >= 0; --j)
                if (xs - j >= first
                    && clamp_unit_mask(__ldg(col + (xs - j) * g.step)) != 0.0f)
                    hi = xs - j;
        }
        if (__syncthreads_or(hi >= a)) {
            hi = __reduce_max_sync(0xffffffffu, hi);
            if (threadIdx.x % 32 == 0) atomicMax(&span[1], hi);
            __syncthreads();
            last = span[1];
            break;
        }
    }
}

// Zeros at the steps [a, b) outside first .. last of the block's columns,
// in all 8 channels of `out`, n voxels a channel.
static __device__ __noinline__ void column_zeros(float* __restrict__ out,
                                                 long long n, SweepColumns g,
                                                 int a, int b, int first,
                                                 int last) {
    long long off;
    if (!g.column(off)) return;
    for (int x = a; x < b; ++x) {
        if (x >= first && x <= last) {
            x = last;
            continue;
        }
        const long long i = off + x * g.step;
#pragma unroll
        for (int c = 0; c < 8; ++c) out[c * n + i] = 0.0f;
    }
}

// The sweeps' columns: (y, z) tiles, stepping along x.
__device__ __forceinline__ SweepColumns sweep_columns(int y0, int z0, int Y,
                                                      int Z) {
    return SweepColumns{y0, Y, z0, Z, Z, (long long)Y * Z};
}

// column_span and column_zeros for a block of any (kTileY, kTileZ)
// tile and kThreads threads (a multiple of 32), which deal the tile's
// columns among them, kPer each, fixed at compile time: the xs-stream kernel
// (tiles of 4 to 14 rows) and ys_multi (30 x 32 voxels, 288 threads) use
// them. The sweeps keep their own forms: with these in their place (the same
// loads, one column a thread) the sweep measured 4-12% slower under the
// sphere mask on the H100, for a reason ptxas's report does not show.
template <int kTileY, int kTileZ, int kThreads>
struct TileColumns {
    static constexpr int kColumns = kTileY * kTileZ;
    static constexpr int kPer = (kColumns + kThreads - 1) / kThreads;
    bool mine[kPer];        // the column is in the tile and in the volume
    long long off[kPer];    // y * Z + z of the column

    __device__ __forceinline__ TileColumns(int y0, int z0, int Y, int Z) {
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
            const int c = threadIdx.x + i * kThreads;
            const int y = y0 + c / kTileZ, z = z0 + c % kTileZ;
            mine[i] = c < kColumns && y < Y && z < Z;
            off[i] = (long long)y * Z + z;
        }
    }
};

template <int kTileY, int kTileZ, int kThreads>
static __device__ __noinline__ void tile_mask_span(const float* __restrict__ mask,
                                                int xa, int xb, int y0, int z0,
                                                int Y, int Z, int* span,
                                                int& first, int& last) {
    constexpr int kBatch = 8;  // planes a thread looks at between barriers
    using Cols = TileColumns<kTileY, kTileZ, kThreads>;
    if (threadIdx.x == 0) {
        span[0] = xb;
        span[1] = xa - 1;
    }
    __syncthreads();
    const Cols cols(y0, z0, Y, Z);
    const long long plane = (long long)Y * Z;
    // from the front, a batch of planes at a time, until one holds a voxel
    // inside; then from the back. A dense mask ends both after one batch.
    first = xb;
    last = xa - 1;
    for (int xs = xa; xs < xb; xs += kBatch) {
        int lo = xb;
#pragma unroll
        for (int i = 0; i < Cols::kPer; ++i) {
            if (!cols.mine[i]) continue;
            const float* col = mask + cols.off[i];
#pragma unroll
            for (int j = kBatch - 1; j >= 0; --j)
                if (xs + j < xb
                    && clamp_unit_mask(__ldg(col + (xs + j) * plane)) != 0.0f)
                    lo = min(lo, xs + j);
        }
        if (__syncthreads_or(lo < xb)) {
            lo = __reduce_min_sync(0xffffffffu, lo);
            if (threadIdx.x % 32 == 0) atomicMin(&span[0], lo);
            __syncthreads();
            first = span[0];
            break;
        }
    }
    if (first == xb) return;
    for (int xs = xb - 1; xs >= first; xs -= kBatch) {
        int hi = xa - 1;
#pragma unroll
        for (int i = 0; i < Cols::kPer; ++i) {
            if (!cols.mine[i]) continue;
            const float* col = mask + cols.off[i];
#pragma unroll
            for (int j = kBatch - 1; j >= 0; --j)
                if (xs - j >= first
                    && clamp_unit_mask(__ldg(col + (xs - j) * plane)) != 0.0f)
                    hi = max(hi, xs - j);
        }
        if (__syncthreads_or(hi >= xa)) {
            hi = __reduce_max_sync(0xffffffffu, hi);
            if (threadIdx.x % 32 == 0) atomicMax(&span[1], hi);
            __syncthreads();
            last = span[1];
            break;
        }
    }
}

// column_zeros for a (kTileY, kTileZ) tile and kThreads threads.
template <int kTileY, int kTileZ, int kThreads>
static __device__ __noinline__ void tile_zero_planes(float* __restrict__ out,
                                                  int xa, int xb, int first,
                                                  int last, int X, int Y, int Z,
                                                  int y0, int z0) {
    using Cols = TileColumns<kTileY, kTileZ, kThreads>;
    const Cols cols(y0, z0, Y, Z);
    const long long plane = (long long)Y * Z;
    const long long n = (long long)X * plane;
#pragma unroll
    for (int i = 0; i < Cols::kPer; ++i) {
        if (!cols.mine[i]) continue;
        for (int x = xa; x < xb; ++x) {
            if (x >= first && x <= last) {
                x = last;
                continue;
            }
            const long long v = x * plane + cols.off[i];
#pragma unroll
            for (int c = 0; c < 8; ++c) out[c * n + v] = 0.0f;
        }
    }
}

static inline bool make_faces(long long x_lo, long long x_hi, long long y_lo,
                              long long y_hi, FaceClamps* fc) {
    const long long lim = 1LL << 30;  // the "no true face" sentinels
    const long long v[4] = {x_lo, x_hi, y_lo, y_hi};
    for (int i = 0; i < 4; ++i)
        if (v[i] < -lim || v[i] > lim) return false;
    *fc = FaceClamps{(int)x_lo, (int)x_hi, (int)y_lo, (int)y_hi};
    return true;
}

static inline dim3 sweep_grid(long long X, long long Y, long long Z,
                              int chunk) {
    return dim3((unsigned)((Z + kSweepTileZ - 1) / kSweepTileZ),
                (unsigned)((Y + kSweepTileY - 1) / kSweepTileY),
                (unsigned)((X + chunk - 1) / chunk));
}

// The switch over the queue's phase: IFE_QUEUE_CASES(M) expands M(0) ..
// M(20), one case per slot of the longest queue (2 * kSweepMaxRx + 1).
#define IFE_QUEUE_CASES(M) \
    M(0) M(1) M(2) M(3) M(4) M(5) M(6) M(7) M(8) M(9) M(10) M(11) M(12) \
    M(13) M(14) M(15) M(16) M(17) M(18) M(19) M(20)
static_assert(2 * kSweepMaxRx + 1 == 21, "IFE_QUEUE_CASES lists 21 slots");
