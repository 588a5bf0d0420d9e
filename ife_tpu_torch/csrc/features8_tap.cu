// The direct features8 entries that nothing dispatches: the tap kernel, the
// whole pass from the raw image and mask smoothed x, then y, then z; and the
// xs kernel, the x pass, the divide and the tail after y/z passes outside.
//
// ife_features8_tap (features8_tap_kernel) replaces
// ife_tpu/kernels/fused.py:fused_features8_tap (kernel _features8_tap_kernel):
// the normalized convolution s = G*(c*f) / G*c of the image f with the clamped
// mask c (c = clamp(mask, 0, 1); the mask input is also the output mask), its
// passes in the TPU kernel's order x, y, z, then the tail. It is a line sweep
// along y, the axis of the middle pass: the sweep kernel's geometry
// (sweep_passes.cuh) with x in the place of y. A block owns an (x, z) tile of
// kSweepTileY x kSweepTileZ voxels, an s region of 16 x 34 cells with one
// thread each, and a chunk of y rows, of which it sweeps those on which its
// tile holds a voxel inside the mask (plus one each side; zeros on the rest).
// Per raw row q:
//   load    image and mask of row q on the s region extended by the x and z
//           radii, at clamped positions (the ZeroFluxNeumann pad), by
//           cp.async from precomputed offsets, into the buffer the passes do
//           not read: row q + 1 is in flight while row q is computed. One
//           load of each gives both fields: the thread that asked turns its
//           elements into c and c*f in place (sweep_finish_raw);
//   x pass  16 x outputs of each z column of the row, four from one walk
//           (the sweep's y pass, sweep_y_pass), into slot q of a ring of
//           2ry + 1 x-pass rows of both fields in shared memory (in global
//           scratch where the ring does not fit beside the other buffers);
//   y pass  the ring's 2ry + 1 rows summed in tap order for row p = q - ry,
//           on the 16 x (34 + 2rz) cells the z pass needs;
//   z pass  each thread sums its s cell's 2rz + 1 taps (sweep_z_pass),
//           divides without epsilon (sweep_divide) into a ring of three s
//           rows, from which the tail emits row p - 1 (emit_features8_row).
// Three barriers a row; the tail of one row runs into the load and the x
// pass of the next with none between. The x queue of an x-first sweep along
// x would be per window cell, 2 * (2rx + 1) floats for each of ~1400 cells:
// sweeping y, the queue is the ring of x-pass rows, whose x halo is already
// gone. HBM sees the image and mask about once (rows re-read at chunk ends
// and the x and z halos come from L2) and the 8 channels written once.
//
// kCopyFloor: the roofline probe of ife_tpu/kernels/fused.py:638-645
// (_features8_tap_kernel's variant="copyfloor"). The block loads every raw
// row of its chunk and the y halo exactly as the features do on a mask with
// no empty row, skips the passes and the tail, and writes channel k of its
// core as c + k (k even) or c*f + k (k odd) from the loaded row: the floor of
// the tap's loads and stores at that sigma, at the tap's shared memory.
//
// ife_features8_xs (features8_xs_kernel) replaces
// ife_tpu/kernels/fused.py:fused_features8_xs (kernel _features8_xs_kernel):
// the numerator and denominator arrive smoothed along y and z (ife_smooth_yz
// in normalized_conv.cu, where ife_tpu ran XLA einsums). A block owns the
// sweep's (y, z) tile and kXsTileX = 16 planes of x; one thread per cell of
// the s region walks its own column along x straight from global memory
// (fir_walk_by: each input read once for its 18 outputs; a warp's lanes read
// consecutive z), divides, and writes the 18 s planes to shared memory, the
// only thing there (39 KB); the tail emits the block's planes from them
// (window_emit). A block with no voxel inside the mask stores zeros and
// stops before the walk.
//
// Both kernels keep the tap order of the plain twins' passes (fir.cuh,
// sweep_passes.cuh) and the library is built without FMA contraction: each
// equals its twin to the bit. No tensor cores: a banded FIR on wgmma would
// run in TF32, which the package turns off.
//
// What bounds them on the H100: the instructions of the SMs and the warps
// that hide their latencies, as for the sweep, not HBM (the bound of either
// is 1.6-1.8 ms at 512^3). The tap issues per voxel the unfused multiplies
// and adds of its three passes (2 * 2 * (2r + 1) each, times the halo's
// share: 1.6 for x and y, 1.2 for z), one shared-memory load per four of
// them in the x pass, per two in the y and z passes, and the tail's ~150
// operations and 19 loads; three barriers a row. Its 544 threads are held
// to 56 registers so that two blocks share an SM where the shared memory
// lets them (equal radii up to 6; 75 KB at sigma 0.6 / 0.78 mm): 3.1
// against 3.8 ms at sigma 0.6, and the same 4.5 ms at sigma 1.2 (125 KB:
// one block). Two raw rows in flight instead of one lowered the copy floor
// (2.8 against 3.6 ms at sigma 1.2) but not the features. The rows load
// 3.1 cells a voxel at sigma 1.2, each once for both fields. The xs kernel
// issues its x walk's multiplies and adds (about twice the taps' work on
// the walk's edges, where it tests each tap's range) and the tail's; its
// loads are the inputs' ((18 + 2rx) / 16 planes a plane) and the emit's. 16
// planes a block at 56 registers (two blocks, 34 warps an SM) took 2.50 ms
// at sigma 1.2 against 3.43 for 32 planes (96 registers, one block), and
// against 2.62 for 12 planes and 2.83 for 20 (spilling) in another run.
// NVIDIA H100 80GB HBM3, 700 W; PERF.md, "features8_tap and features8_xs
// redesigned".
#include <cuda_runtime.h>

#include "sweep_passes.cuh"

// ---------------------------------------------------------------------------
// tap: image + mask -> 8 channels, a row sweep along y
// ---------------------------------------------------------------------------

constexpr int kTapTileX = kSweepTileY;  // the (x, z) tile: the sweep's (y, z)
constexpr int kTapSX = kSweepSY;

// A block's buffers, in floats, at radii (rx, ry, rz): two raw rows of c*f
// and c on (16 + 2rx) x (34 + 2rz) cells, the y pass of both (rows padded as
// the sweep's) and three s rows in shared memory (tap_base_floats); the ring
// of 2ry + 1 x-pass rows of both fields on 16 x (34 + 2rz) cells
// (tap_ring_floats) between the raw rows and the y pass where the whole fits
// a block's shared memory, else in global scratch, one ring a block: a large
// y radius beside small x and z radii (ry 23 - 32 at rx = rz = 0, scales
// fused_features8_tap has taken since it was first ported) and equal radii
// 12 - 44.
__host__ __device__ inline size_t tap_base_floats(int rx, int rz) {
    return 4 * (size_t)(kTapSX + 2 * rx) * (kSweepSZ + 2 * rz)
        + 2 * (size_t)kTapSX * sweep_ybuf_stride(rz) + 3 * (size_t)kSweepCells;
}

__host__ __device__ inline size_t tap_ring_floats(int ry, int rz) {
    return (size_t)(2 * ry + 1) * 2 * kTapSX * (kSweepSZ + 2 * rz);
}

// The raw row of a block: (16 + 2rx) x (34 + 2rz) cells, cell (i, j) at
// (clamp(x0 - 1 - rx + i), y, clamp(z0 - 1 - rz + j)) of row y.
struct TapRawRow {
    int PZ, n;  // row length, cells
    int x0, z0, rx, rz, X, Z;
    long long plane;
    long long off[kSweepLoadRegs];  // x * Y * Z + z of cell threadIdx.x + k * threads

    __device__ __forceinline__ long long offset(int idx) const {
        const int i = idx / PZ, j = idx - i * PZ;
        return clamp_index(x0 - 1 - rx + i, X) * plane
            + clamp_index(z0 - 1 - rz + j, Z);
    }
};

__device__ __forceinline__ TapRawRow make_tap_raw_row(int x0, int z0, int rx,
                                                      int rz, int X, int Y,
                                                      int Z) {
    TapRawRow t;
    t.PZ = kSweepSZ + 2 * rz;
    t.n = (kTapSX + 2 * rx) * t.PZ;
    t.x0 = x0, t.z0 = z0, t.rx = rx, t.rz = rz, t.X = X, t.Z = Z;
    t.plane = (long long)Y * Z;
#pragma unroll
    for (int k = 0; k < kSweepLoadRegs; ++k) {
        const int idx = threadIdx.x + k * kSweepThreads;
        t.off[k] = idx < t.n ? t.offset(idx) : 0;
    }
    return t;
}

// Ask for image and mask of row y into pn and pd; returns at once.
__device__ __forceinline__ void tap_issue_row(const float* __restrict__ image,
                                              const float* __restrict__ mask,
                                              const TapRawRow& t, int y,
                                              float* pn, float* pd) {
    const long long row = (long long)y * t.Z;
#pragma unroll
    for (int k = 0; k < kSweepLoadRegs; ++k) {
        const int idx = threadIdx.x + k * kSweepThreads;
        if (idx < t.n) {
            cp_async_f32(pn + idx, image + row + t.off[k]);
            cp_async_f32(pd + idx, mask + row + t.off[k]);
        }
    }
    for (int idx = threadIdx.x + kSweepLoadRegs * kSweepThreads; idx < t.n;
         idx += kSweepThreads) {
        const long long off = row + t.offset(idx);
        cp_async_f32(pn + idx, image + off);
        cp_async_f32(pd + idx, mask + off);
    }
}

// The y pass of both fields for row p: for each of the 16 x PZ cells e of an
// x-pass row, tap t of the sum reads ring slot (first + t) % R, R = 2ry + 1
// (the ring holds rows p - ry .. p + ry), in two runs of consecutive slots.
// A slot is [c*f, c][16][PZ], `half` floats a field; the result goes to the
// y pass buffer, rows of `stride`.
__device__ __forceinline__ void tap_y_pass(const float* ring, int first,
                                           int slot, int half, int PZ,
                                           const Taps& ty, float* qn,
                                           float* qd, int stride) {
    const int R = 2 * ty.r + 1;
    for (int e = threadIdx.x; e < half; e += kSweepThreads) {
        const float* a = ring + first * slot + e;
        float an = ty.t[0] * a[0], ad = ty.t[0] * a[half];
        int t = 1;
        for (; t < R - first; ++t) {
            an = an + ty.t[t] * a[t * slot];
            ad = ad + ty.t[t] * a[t * slot + half];
        }
        for (const float* b = ring + e; t < R; ++t, b += slot) {
            an = an + ty.t[t] * b[0];
            ad = ad + ty.t[t] * b[half];
        }
        const int u = e / PZ, j = e - u * PZ;
        qn[u * stride + j] = an;
        qd[u * stride + j] = ad;
    }
}

// kRingInSmem: the ring after the block's other buffers in shared memory,
// else this block's ring in ring_scratch (tap_ring_floats a block, blocks in
// launch order). The copy floor reads the raw rows alone.
template <bool kCopyFloor, bool kRingInSmem>
__global__ void __launch_bounds__(kSweepThreads, 2)
features8_tap_kernel(const float* __restrict__ image,
                     const float* __restrict__ mask, float* __restrict__ out,
                     int X, int Y, int Z, int chunk_y, Taps tx, Taps ty,
                     Taps tz, StencilRecip k, float* ring_scratch) {
    extern __shared__ float smem[];
    constexpr int SZ = kSweepSZ, NC = kSweepCells;
    const int ry = ty.r;
    const int z0 = blockIdx.x * kSweepTileZ;
    const int x0 = blockIdx.y * kTapTileX;
    const int ya = blockIdx.z * chunk_y;
    const int yb = min(ya + chunk_y, Y);
    const TapRawRow row = make_tap_raw_row(x0, z0, tx.r, tz.r, X, Y, Z);
    const int PZ = row.PZ;
    const int half = kTapSX * PZ;                  // one field of a ring slot
    const int slot = 2 * half;
    const int stride = sweep_ybuf_stride(tz.r);
    float* raw = smem;                             // [2][c*f, c][row.n]
    float* ring = kRingInSmem                      // [2ry + 1][slot]
        ? raw + 4 * row.n
        : ring_scratch + ((long long)(blockIdx.z * gridDim.y + blockIdx.y)
                          * gridDim.x + blockIdx.x) * (2 * ry + 1) * slot;
    float* qn = kRingInSmem ? ring + (2 * ry + 1) * slot  // [16][stride]
                            : raw + 4 * row.n;            // y pass
    float* qd = qn + kTapSX * stride;
    float* sring = qd + kTapSX * stride;           // [3][NC] s rows

    const long long nvox = (long long)X * Y * Z;
    int y_first = ya, y_last = yb - 1;
    if (!kCopyFloor) {
        // the rows of the chunk that hold a voxel inside the mask: the rest
        // are zeros, and need no s
        __shared__ int span[2];
        const SweepColumns g{x0, X, z0, Z, (long long)Y * Z, Z};
        column_span(mask, g, ya, yb, span, y_first, y_last);
        column_zeros(out, nvox, g, ya, yb, y_first, y_last);
        if (y_first > y_last) return;  // the same for every thread
    }
    // s rows this block needs, and the raw rows (clamped) behind them
    const int p_lo = max(y_first - 1, 0);
    const int p_hi = min(y_last + 1, Y - 1);
    const int q_lo = p_lo - ry, q_hi = p_hi + ry;
    const YItem x_item = sweep_y_item(sweep_y_first_index(), row.n, PZ, 0, 0,
                                      PZ, PZ);
    // this thread's cell of the s region, in the y pass buffer
    const int cell = (threadIdx.x / SZ) * stride + threadIdx.x % SZ;

    tap_issue_row(image, mask, row, clamp_index(q_lo, Y), raw, raw + row.n);
    sweep_finish_raw(row.n, raw, raw + row.n);
    __syncthreads();
    for (int q = q_lo; q <= q_hi; ++q) {
        float* pn = raw + ((q - q_lo) & 1) * 2 * row.n;      // row q
        float* nn = raw + ((q - q_lo + 1) & 1) * 2 * row.n;  // row q + 1
        if (q < q_hi)
            tap_issue_row(image, mask, row, clamp_index(q + 1, Y), nn,
                          nn + row.n);
        if (kCopyFloor) {
            // channel c of the core of row q: c*f + c (odd), c + c (even)
            for (int idx = threadIdx.x; idx < kTapTileX * kSweepTileZ;
                 idx += kSweepThreads) {
                const int i = idx / kSweepTileZ, j = idx % kSweepTileZ;
                const int x = x0 + i, z = z0 + j;
                if (q < ya || q >= yb || x >= X || z >= Z) continue;
                const int e = (1 + tx.r + i) * PZ + 1 + tz.r + j;
                const long long o = x * row.plane + (long long)q * Z + z;
#pragma unroll
                for (int c = 0; c < 8; ++c)
                    out[c * nvox + o] = pn[(c & 1) ? e : row.n + e] + (float)c;
            }
            if (q < q_hi) sweep_finish_raw(row.n, nn, nn + row.n);
            __syncthreads();
            continue;
        }
        sweep_y_pass(x_item, pn, row.n, PZ, 0, 0, PZ, tx,
                     ring + ((q - q_lo) % (2 * ry + 1)) * slot, PZ);
        __syncthreads();
        const int p = q - ry;  // the ring now holds rows p - ry .. p + ry
        const bool live = p >= p_lo;
        if (live)
            tap_y_pass(ring, (p - p_lo) % (2 * ry + 1), slot, half, PZ, ty, qn,
                       qd, stride);
        __syncthreads();
        if (live) {
            float vn, vd;
            sweep_z_pass(qn, qd, cell, tz, vn, vd);
            sring[(p % 3) * NC + threadIdx.x] = sweep_divide(vn, vd);
        }
        if (q < q_hi) sweep_finish_raw(row.n, nn, nn + row.n);
        __syncthreads();
        // row p - 1 (its y + 1 neighbour is p), and at the last true row p
        // itself
        for (int y = max(p - 1, y_first);
             live && y <= (p == Y - 1 ? p : p - 1) && y <= y_last; ++y) {
            const float* const s3[3] = {
                sring + (max(y - 1, 0) % 3) * NC, sring + (y % 3) * NC,
                sring + (min(y + 1, Y - 1) % 3) * NC};
            emit_features8_row<kTapTileX, kSweepTileZ, true>(
                s3, y, X, Y, Z, x0, z0, mask, out, k);
        }
        // What the next iteration overwrites was last read before a barrier
        // every thread has passed: the buffer of row q by this x pass (before
        // the first barrier), the ring slot of row q - 2ry by this y pass and
        // the y pass buffer by this z pass (before the second and the third),
        // the s slot of row p + 1 by the tail of row p - 2, one iteration
        // back.
    }
}

// image, mask: contiguous (X, Y, Z) float32 (the mask raw, clamped to [0, 1]
// here); out: contiguous (8, X, Y, Z); taps_*: host arrays of 2r+1 floats;
// copy_floor: 1 for the copy-floor probe, 0 for the features; ring_scratch:
// scratch_floats floats of device memory, at least tap_ring_floats times the
// blocks of the grid when the ring does not fit shared memory (else unused,
// may be null). The grid: (Z / 32, X / 14, Y / chunk) blocks, rounded up; a
// block sweeps a chunk of y rows: about 32 (ry + 1), at least 128
// (sweep_chunk_x).
extern "C" int ife_features8_tap(const float* image, const float* mask,
                                 float* out, long long X, long long Y,
                                 long long Z,
                                 const float* taps_x, long long ntx,
                                 const float* taps_y, long long nty,
                                 const float* taps_z, long long ntz,
                                 float r2x, float r2y, float r2z,
                                 float rxx, float ryy, float rzz,
                                 long long copy_floor, float* ring_scratch,
                                 long long scratch_floats,
                                 cudaStream_t stream) {
    Taps tx, ty, tz;
    if (!make_taps(taps_x, ntx, &tx) || !make_taps(taps_y, nty, &ty)
        || !make_taps(taps_z, ntz, &tz))
        return (int)cudaErrorInvalidValue;
    if (copy_floor != 0 && copy_floor != 1) return (int)cudaErrorInvalidValue;
    const long long gx = (X + kTapTileX - 1) / kTapTileX;
    if (gx > 65535) return (int)cudaErrorInvalidValue;
    const int chunk = sweep_chunk_x(Y, ty.r);
    const dim3 grid((unsigned)((Z + kSweepTileZ - 1) / kSweepTileZ),
                    (unsigned)gx, (unsigned)((Y + chunk - 1) / chunk));
    const size_t base = tap_base_floats(tx.r, tz.r) * sizeof(float);
    const size_t ring = tap_ring_floats(ty.r, tz.r) * sizeof(float);
    const bool in_smem = base + ring <= (size_t)kSweepMaxSmem;
    if (base > (size_t)kSweepMaxSmem) return (int)cudaErrorInvalidValue;
    if (!in_smem && !copy_floor
        && (ring_scratch == nullptr
            || scratch_floats < (long long)(tap_ring_floats(ty.r, tz.r)
                                            * grid.x * grid.y * grid.z)))
        return (int)cudaErrorInvalidValue;
    // the copy floor reads no ring: its shared memory is the features'
    const size_t smem = in_smem ? base + ring : base;
    const auto kernel = copy_floor ? &features8_tap_kernel<true, true>
                        : in_smem  ? &features8_tap_kernel<false, true>
                                   : &features8_tap_kernel<false, false>;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const StencilRecip k{r2x, r2y, r2z, rxx, ryy, rzz};
    kernel<<<grid, kSweepThreads, smem, stream>>>(
        image, mask, out, (int)X, (int)Y, (int)Z, chunk, tx, ty, tz, k,
        ring_scratch);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// xs: y/z-smoothed numerator and denominator + mask -> 8 channels, the x
// pass down each thread's column
// ---------------------------------------------------------------------------

constexpr int kXsTileX = 16;            // x planes a block emits
constexpr int kXsSX = kXsTileX + 2;     // s planes it computes

// Shared memory, in floats: the s planes of the block.
__host__ __device__ constexpr size_t xs_smem_floats() {
    return (size_t)kXsSX * kSweepCells;
}

// Emit the planes [xa, xb) of a block whose s planes hold plane x0w + i in
// s + i * kSweepCells (every plane clamp(x +- 1) of an emitted x is there).
template <bool kClampMask>
__device__ __forceinline__ void window_emit(const float* s, int x0w, int xa,
                                            int xb, int X, int Y, int Z, int y0,
                                            int z0, const float* mask,
                                            float* out, const StencilRecip& k) {
    for (int x = xa; x < xb; ++x) {
        const float* const s3[3] = {
            s + (clamp_index(x - 1, X) - x0w) * kSweepCells,
            s + (x - x0w) * kSweepCells,
            s + (clamp_index(x + 1, X) - x0w) * kSweepCells};
        emit_features8_planes<kSweepTileY, kSweepTileZ, kClampMask>(
            s3, x, X, Y, Z, y0, z0, mask, out, k, 0, Y - 1);
    }
}

__global__ void __launch_bounds__(kSweepThreads, 2)
features8_xs_kernel(const float* __restrict__ num, const float* __restrict__ den,
                    const float* __restrict__ mask, float* __restrict__ out,
                    int X, int Y, int Z, Taps tx, StencilRecip k) {
    extern __shared__ float s[];  // [kXsSX][cells]: plane x0 - 1 + u at u
    constexpr int SZ = kSweepSZ, NC = kSweepCells;
    const int z0 = blockIdx.x * kSweepTileZ;
    const int y0 = blockIdx.y * kSweepTileY;
    const int x0 = blockIdx.z * kXsTileX;
    const int xb = min(x0 + kXsTileX, X);
    const long long plane = (long long)Y * Z;

    // a block with no voxel inside the mask: zeros, and no x pass. Inline,
    // not column_span: across a call ptxas spills this kernel's registers
    // (16 bytes under its cap of 56)
    long long vox;
    const bool mine = sweep_columns(y0, z0, Y, Z).column(vox);
    bool inside = false;
    if (mine) {
#pragma unroll 8
        for (int x = x0; x < xb; ++x)
            inside |= __ldg(mask + x * plane + vox) != 0.0f;
    }
    if (!__syncthreads_or(inside)) {
        if (mine) {
            const long long n = (long long)X * plane;
            for (int x = x0; x < xb; ++x)
#pragma unroll
                for (int c = 0; c < 8; ++c) out[c * n + x * plane + vox] = 0.0f;
        }
        return;
    }
    // the x pass of this thread's column: outputs x0 - 1 .. x0 + kXsTileX,
    // input i at plane clamp(x0 - 1 - rx + i)
    const int c = threadIdx.x;
    const long long col = (long long)clamp_index(y0 - 1 + c / SZ, Y) * Z
        + clamp_index(z0 - 1 + c % SZ, Z);
    const int xs = x0 - 1 - tx.r;
    float acc[2][kXsSX];
    fir_walk_by<kXsSX, 2>(
        [&](int i, float (&v)[2]) {
            const long long o = clamp_index(xs + i, X) * plane + col;
            v[0] = __ldg(num + o);
            v[1] = __ldg(den + o);
        },
        tx, acc);
#pragma unroll
    for (int u = 0; u < kXsSX; ++u)  // no epsilon: 0/0 = NaN off the support
        s[u * NC + c] = sweep_divide(acc[0][u], acc[1][u]);
    __syncthreads();
    window_emit<false>(s, x0 - 1, x0, xb, X, Y, Z, y0, z0, mask, out, k);
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
    constexpr size_t smem = xs_smem_floats() * sizeof(float);
    static_assert(smem <= (size_t)kSweepMaxSmem, "the s planes fit a block");
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            features8_xs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const long long gy = (Y + kSweepTileY - 1) / kSweepTileY;
    const long long gx = (X + kXsTileX - 1) / kXsTileX;
    if (gy > 65535 || gx > 65535) return (int)cudaErrorInvalidValue;
    const StencilRecip k{r2x, r2y, r2z, rxx, ryy, rzz};
    const dim3 grid((unsigned)((Z + kSweepTileZ - 1) / kSweepTileZ),
                    (unsigned)gy, (unsigned)gx);
    features8_xs_kernel<<<grid, kSweepThreads, smem, stream>>>(
        num_yz, den_yz, mask, out, (int)X, (int)Y, (int)Z, tx, k);
    return (int)cudaGetLastError();
}
