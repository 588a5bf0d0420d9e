// Box histograms at every centre of a dense grid of ROIs (MakeBagDense's
// DenseROIGenerator: an ROI at every foreground voxel), without a walk over
// any box.
//
// Replaces no TPU kernel: ife_tpu bins a dense bag like a sparse one, box
// by box on the host. For every start p of a box of size (sx, sy, sz) and
// every channel c, counts[p, c, b] = the voxels v of [p, p + size) with
// weight != 0 and bin_c(v) == b, where bin_c(v) is the first j with
// v <= e_c[j] (E when there is none) and a NaN value goes to bin E: the
// convention of csrc/histogram.cu, whose per-box walk would read 68,921
// voxels a box of 41^3, 3.4e11 reads a channel for the 5 M boxes of a lung.
// The rows written are the frequencies counts / (the box's weighted voxel
// count), divided in f32 as roi/bag.py:roi_feature_histograms_device
// divides them.
//
// Two kernels, launched one after the other by the one C entry
// ife_dense_hist (counted as "dense_hist" in kernels/_build.py's LAUNCHES):
//   * dense_hist_bins_kernel: one byte a voxel and channel over the region
//     that holds every box: the voxel's bin, or kNoBin where its weight is
//     0. The same binary search as the histogram kernel, over edges in
//     shared memory.
//   * dense_hist_rows_kernel: separable running box sums of the bins'
//     indicators. A block owns a tile of TY x TZ starts of one channel and
//     sweeps x over a run of starts. It keeps, in shared memory, for every
//     (y, z) column of the tile's footprint (TY + sy - 1) x (TZ + sz - 1)
//     the counts of each bin over the sx voxels of the x window (u8, as
//     the window holds at most sx <= 255 voxels); a step in x adds the
//     entering plane's bin and drops the leaving one's, one thread a
//     column. Then, for the plane's starts, the z window (pass 2, u16
//     pairs: at most sx * sz <= 32767 a bin) and the y window (pass 3, u32)
//     run as sliding sums, four bins a lane, and pass 3 writes each start's
//     row segment where the start is an ROI (its row index >= 0). Planes of
//     a tile, and runs of starts in y, that hold no ROI skip passes 2 and
//     3. Counts are integers, so the rows equal the plain twin's to the bit.
//
// What bounds it on the H100: the rows written (N x C x bins x 4 B, 5 GB a
// scale for the 5 M ROIs of a lung) at 3.35 TB/s, and below that the
// instructions of passes 2 and 3 (one block of 1,024 threads an SM, two
// barriers a plane): a lane reads a word of four u8 counts (pass 2) or two
// of u16 pairs (pass 3) a step, so the sliding sums run at a quarter of
// the loads of one bin a lane; the row index of a plane's starts is read
// once into shared memory and tells a whole tile when to skip. The first
// window of a run, 41 reads of 72 in pass 2 at 41^3, adds whole groups in
// straight-line code (four columns as u8 quads where sx <= 63, eight rows
// as u16 pairs where sx * sz <= 8191, one at a time beyond), and a whole
// run of pass 3 is unrolled: as loops over a count the compiler cannot
// see, they compiled to a ladder of branches around each chunk.
// Groups of bins a block (a column's counters of G bins, not all, so a
// 2-4x larger tile in the same shared memory) were measured slower: each
// group's block reads and tests every bin byte of its footprint, and the
// 128-byte segment of a row and channel is then written in pieces by
// blocks that run apart.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChannelsPerBinsLaunch = 8;  // channels a bins launch takes
constexpr int kMaxEdges = 63;              // at most 64 bins
constexpr unsigned char kNoBin = 0xff;
constexpr int kRowsThreads = 1024;
constexpr int kSegment = 8;                // pass 3: starts a lane slides in y
constexpr int kColsPerThread = 4;          // columns a thread prefetches
constexpr uint32_t kLowBytes = 0x00ff00ffu;
constexpr uint32_t kHalfBias = 0x8000u;    // pass 3's bias of a u16 half
constexpr uint32_t kHalfBias2 = 0x80008000u;

struct BinChannels {
    const float* p[kChannelsPerBinsLaunch];
};

// bins[c][x][y][z] over the region [x0, x0 + RX) x [y0, y0 + RY) x
// [z0, z0 + RZ) of (X, Y, Z) volumes; z fastest, as the volume. A block
// bins one (x, y) row of the region.
__global__ void __launch_bounds__(128)
dense_hist_bins_kernel(const __grid_constant__ BinChannels chans, int C,
                       const unsigned char* __restrict__ weights,
                       const float* __restrict__ edges, int E,
                       long long Y, long long Z, long long x0, long long y0,
                       long long z0, long long RX, long long RY, int RZ,
                       unsigned char* __restrict__ bins) {
    __shared__ float e_s[kChannelsPerBinsLaunch * kMaxEdges];
    for (int i = threadIdx.x; i < C * E; i += blockDim.x) e_s[i] = edges[i];
    __syncthreads();
    const long long row = blockIdx.x;
    const long long rx = row / RY, ry = row - rx * RY;
    const long long v0 = ((x0 + rx) * Y + (y0 + ry)) * Z + z0;
    const long long n = RX * RY * RZ;
    unsigned char* dst = bins + row * RZ;
    for (int rz = threadIdx.x; rz < RZ; rz += blockDim.x) {
        const bool in = weights[v0 + rz] != 0;
        for (int c = 0; c < C; ++c) {
            unsigned char b = kNoBin;
            if (in) {
                const float val = chans.p[c][v0 + rz];
                const float* e = e_s + c * E;
                int lo = 0, hi = E;
                while (lo < hi) {
                    const int mid = (lo + hi) >> 1;
                    if (e[mid] < val) lo = mid + 1; else hi = mid;
                }
                b = (unsigned char)(val != val ? E : lo);
            }
            dst[c * n + rz] = b;
        }
    }
}

// a / d for 0 <= a < 2^20 and 1 <= d <= 2^12 by the reciprocal in f32:
// (a + 0.5) / d lies at least 1 / (2 d) from an integer, far beyond the
// f32 error of the product; a divide of the kernel's index math would take
// some twenty instructions
__device__ __forceinline__ int quot(int a, float inv_d) {
    return __float2int_rz(__fmul_rn((float)a + 0.5f, inv_d));
}

struct RowsShape {
    int C, nbins, nq;           // channels, bins, words of four bins
    int RX, RY, RZ;             // region of the bins
    int SX, SY, SZ;             // starts (the region less size - 1)
    int sx, sy, sz;             // box
    int TY, TZ, xchunk;         // tile of starts, x starts a block sweeps
    int rowCw, rowRw;           // shared-memory row strides, in words
    long long out_stride;       // floats between rows of the output
};

__device__ __forceinline__ void write_row(float* __restrict__ out,
                                          const RowsShape& s, int row, int c,
                                          int q, const uint32_t h[4],
                                          int total, bool vec4) {
    float* dst = out + (long long)row * s.out_stride + c * s.nbins + 4 * q;
    const float t = (float)total;
    if (vec4) {
        *reinterpret_cast<float4*>(dst) = make_float4(
            __fdiv_rn((float)h[0], t), __fdiv_rn((float)h[1], t),
            __fdiv_rn((float)h[2], t), __fdiv_rn((float)h[3], t));
    } else {
        for (int j = 0; j < 4 && 4 * q + j < s.nbins; ++j)
            dst[j] = __fdiv_rn((float)h[j], t);
    }
}

// pass 3 at start ty of a run: the y window steps to [ty, ty + sy) (unless
// ty is the run's first start) by the entering row less the leaving one,
// as u16 pairs biased by 0x8000 so that no half borrows from the other;
// the start's row segment is written where the start is an ROI
__device__ __forceinline__ void y_step(float* __restrict__ out,
                                       const RowsShape& s, const int* row_s,
                                       const int* tot_s, const uint32_t* src,
                                       int ty, bool step, int tz, int c, int q,
                                       uint32_t h[4], bool vec4) {
    if (step) {
        const uint2 e = *reinterpret_cast<const uint2*>(
            src + (ty + s.sy - 1) * s.rowRw);
        const uint2 l = *reinterpret_cast<const uint2*>(
            src + (ty - 1) * s.rowRw);
        const uint32_t dlo = e.x + kHalfBias2 - l.x;
        const uint32_t dhi = e.y + kHalfBias2 - l.y;
        h[0] += (dlo & 0xffffu) - kHalfBias;
        h[2] += (dlo >> 16) - kHalfBias;
        h[1] += (dhi & 0xffffu) - kHalfBias;
        h[3] += (dhi >> 16) - kHalfBias;
    }
    const int r = row_s[ty * s.TZ + tz];
    if (r >= 0) write_row(out, s, r, c, q, h, tot_s[ty * s.TZ + tz], vec4);
}

__global__ void __launch_bounds__(kRowsThreads, 1)
dense_hist_rows_kernel(const unsigned char* __restrict__ bins,
                       const int* __restrict__ row_at,
                       const int* __restrict__ total_at,
                       float* __restrict__ out, const RowsShape s, bool vec4) {
    extern __shared__ uint32_t smem[];
    const int ty0 = blockIdx.y * s.TY, tz0 = blockIdx.x * s.TZ;
    const int c = blockIdx.z % s.C;
    const int xa = (blockIdx.z / s.C) * s.xchunk;
    const int xb = min(s.SX, xa + s.xchunk);
    const int TYe = min(s.TY, s.SY - ty0), TZe = min(s.TZ, s.SZ - tz0);
    if (TYe <= 0 || TZe <= 0 || xa >= xb) return;
    const int FY = TYe + s.sy - 1, FZ = TZe + s.sz - 1;
    const int FYmax = s.TY + s.sy - 1;
    const int tid = threadIdx.x;
    // columns (pass 2) and rows (pass 3) that add up without a carry out of
    // their u8 / u16 lanes: at most sx and sx * sz a lane
    const int pack2 = 255 / s.sx, pack3 = 65535 / (s.sx * s.sz);
    uint32_t* cw = smem;                                   // [FY][rowCw]
    // [FY][rowRw], on an 8-byte boundary for its pairs of words
    uint32_t* rz = cw + ((FYmax * s.rowCw + 1) & ~1);
    int* row_s = reinterpret_cast<int*>(rz + FYmax * s.rowRw);  // [TY][TZ]
    int* tot_s = row_s + s.TY * s.TZ;                           // [TY][TZ]
    unsigned char* cb = reinterpret_cast<unsigned char*>(cw);
    const long long plane = (long long)s.RY * s.RZ;
    const unsigned char* bc = bins + (long long)c * s.RX * plane;
    const long long splane = (long long)s.SY * s.SZ;
    const int ncol = FY * FZ;
    // this thread's start of the tile (one a thread: TY * TZ <= blockDim)
    const float inv_fz = 1.0f / FZ, inv_nq = 1.0f / s.nq;
    const float inv_tz = 1.0f / TZe, inv_nqtz = 1.0f / (s.nq * TZe);
    const int my_ty = quot(tid, inv_tz), my_tz = tid - my_ty * TZe;
    const bool has_start = tid < TYe * TZe;
    const long long my_at = (long long)(ty0 + my_ty) * s.SZ + tz0 + my_tz;

    for (int i = tid; i < FYmax * s.rowCw; i += blockDim.x) cw[i] = 0;
    __syncthreads();
    // the x window of the first start, [xa, xa + sx): column counts
    for (int col = tid; col < ncol; col += blockDim.x) {
        const int fy = quot(col, inv_fz), fz = col - fy * FZ;
        const long long at = (long long)(ty0 + fy) * s.RZ + (tz0 + fz);
        unsigned char* cnt = cb + 4 * (fy * s.rowCw + fz * s.nq);
#pragma unroll 8
        for (int p = 0; p < s.sx; ++p) {
            const unsigned char b = bc[(xa + p) * plane + at];
            if (b != kNoBin) cnt[b] += 1;
        }
    }
    // a plane's bytes and row data are loaded one plane ahead, so that
    // their latency hides behind the passes of the plane before
    unsigned char b_in[kColsPerThread], b_out[kColsPerThread];
    int r_next = -1, t_next = 0;
    if (has_start) {
        r_next = row_at[xa * splane + my_at];
        t_next = total_at[xa * splane + my_at];
    }

    for (int x = xa; x < xb; ++x) {
        if (x > xa) {
            // the window steps to [x, x + sx): one thread a column
#pragma unroll
            for (int k = 0; k < kColsPerThread; ++k) {
                const int col = tid + k * kRowsThreads;
                if (col < ncol) {
                    const int fy = quot(col, inv_fz), fz = col - fy * FZ;
                    unsigned char* cnt = cb + 4 * (fy * s.rowCw + fz * s.nq);
                    if (b_in[k] != kNoBin) cnt[b_in[k]] += 1;
                    if (b_out[k] != kNoBin) cnt[b_out[k]] -= 1;
                }
            }
            for (int col = tid + kColsPerThread * kRowsThreads; col < ncol;
                 col += blockDim.x) {
                const int fy = quot(col, inv_fz), fz = col - fy * FZ;
                const long long at = (long long)(ty0 + fy) * s.RZ + (tz0 + fz);
                unsigned char* cnt = cb + 4 * (fy * s.rowCw + fz * s.nq);
                const unsigned char bi = bc[(x + s.sx - 1) * plane + at];
                const unsigned char bo = bc[(x - 1) * plane + at];
                if (bi != kNoBin) cnt[bi] += 1;
                if (bo != kNoBin) cnt[bo] -= 1;
            }
        }
        __syncthreads();
        if (has_start) {
            row_s[my_ty * s.TZ + my_tz] = r_next;
            tot_s[my_ty * s.TZ + my_tz] = t_next;
        }
        const int any = __syncthreads_or(has_start && r_next >= 0);
        if (x + 1 < xb) {
#pragma unroll
            for (int k = 0; k < kColsPerThread; ++k) {
                const int col = tid + k * kRowsThreads;
                if (col < ncol) {
                    const int fy = quot(col, inv_fz), fz = col - fy * FZ;
                    const long long at =
                        (long long)(ty0 + fy) * s.RZ + (tz0 + fz);
                    b_in[k] = bc[(x + s.sx) * plane + at];
                    b_out[k] = bc[x * plane + at];
                }
            }
            if (has_start) {
                r_next = row_at[(x + 1) * splane + my_at];
                t_next = total_at[(x + 1) * splane + my_at];
            }
        }
        if (!any) continue;

        // pass 2: z window of every footprint row, four bins a lane as
        // u16 pairs (bins 0, 2 in lo; 1, 3 in hi); the first window adds
        // four columns at a time as u8 quads (pack2 >= 4) before it widens
        // them
        for (int t = tid; t < FY * s.nq; t += blockDim.x) {
            const int fy = quot(t, inv_nq), q = t - fy * s.nq;
            const uint32_t* src = cw + fy * s.rowCw + q;
            uint32_t* dst = rz + fy * s.rowRw + 2 * q;
            uint32_t lo = 0, hi = 0;
            int dz = 0;
            if (pack2 >= 4) {
                for (; dz + 4 <= s.sz; dz += 4) {
                    const uint32_t w = src[dz * s.nq] + src[(dz + 1) * s.nq]
                                       + src[(dz + 2) * s.nq]
                                       + src[(dz + 3) * s.nq];
                    lo += w & kLowBytes;
                    hi += (w >> 8) & kLowBytes;
                }
            }
            for (; dz < s.sz; ++dz) {
                const uint32_t w = src[dz * s.nq];
                lo += w & kLowBytes;
                hi += (w >> 8) & kLowBytes;
            }
            *reinterpret_cast<uint2*>(dst) = make_uint2(lo, hi);
            for (int tz = 1; tz < TZe; ++tz) {
                const uint32_t we = src[(tz + s.sz - 1) * s.nq];
                const uint32_t wl = src[(tz - 1) * s.nq];
                lo += (we & kLowBytes) - (wl & kLowBytes);
                hi += ((we >> 8) & kLowBytes) - ((wl >> 8) & kLowBytes);
                *reinterpret_cast<uint2*>(dst + tz * 2 * s.nq) =
                    make_uint2(lo, hi);
            }
        }
        __syncthreads();

        // pass 3: y window of each start, u32 a bin; rows of the ROIs. A
        // segment without an ROI is skipped. The first window adds eight
        // rows at a time as u16 pairs (pack3 >= 8) before it widens them;
        // then y_step
        const int nseg = (TYe + kSegment - 1) / kSegment;
        for (int t = tid; t < nseg * TZe * s.nq; t += blockDim.x) {
            const int seg = quot(t, inv_nqtz);
            const int tq = t - seg * s.nq * TZe;
            const int tz = quot(tq, inv_nq), q = tq - tz * s.nq;
            const int y0 = seg * kSegment;
            const int y1 = min(TYe, y0 + kSegment);
            const uint32_t* src = rz + tz * 2 * s.nq + 2 * q;
            // a whole run in straight-line code
            const bool whole = y1 - y0 == kSegment;
            bool roi = false;
            if (whole) {
#pragma unroll
                for (int k = 0; k < kSegment; ++k)
                    roi |= row_s[(y0 + k) * s.TZ + tz] >= 0;
            } else {
                for (int ty = y0; ty < y1; ++ty)
                    roi |= row_s[ty * s.TZ + tz] >= 0;
            }
            if (!roi) continue;
            uint32_t h[4] = {0, 0, 0, 0};
            int dy = 0;
            if (pack3 >= 8) {
                for (; dy + 8 <= s.sy; dy += 8) {
                    uint32_t plo = 0, phi = 0;
#pragma unroll
                    for (int k = 0; k < 8; ++k) {
                        const uint2 v = *reinterpret_cast<const uint2*>(
                            src + (y0 + dy + k) * s.rowRw);
                        plo += v.x;
                        phi += v.y;
                    }
                    h[0] += plo & 0xffffu; h[2] += plo >> 16;
                    h[1] += phi & 0xffffu; h[3] += phi >> 16;
                }
            }
            for (; dy < s.sy; ++dy) {
                const uint2 v = *reinterpret_cast<const uint2*>(
                    src + (y0 + dy) * s.rowRw);
                h[0] += v.x & 0xffffu; h[2] += v.x >> 16;
                h[1] += v.y & 0xffffu; h[3] += v.y >> 16;
            }
            if (whole) {
#pragma unroll
                for (int k = 0; k < kSegment; ++k)
                    y_step(out, s, row_s, tot_s, src, y0 + k, k > 0, tz, c,
                           q, h, vec4);
            } else {
                for (int ty = y0; ty < y1; ++ty)
                    y_step(out, s, row_s, tot_s, src, ty, ty > y0, tz, c, q,
                           h, vec4);
            }
        }
    }
}

}  // namespace

// One scale's dense rows, both kernels in one call: chan_ptrs, a host
// array of C device pointers to contiguous f32 (X, Y, Z) volumes; weights:
// device uint8 (X, Y, Z), nonzero = counted; edges: device (C, E) f32
// (E <= 63), non-decreasing rows; the starts [x0, x0 + SX) x [y0, y0 + SY)
// x [z0, z0 + SZ) of boxes (sx, sy, sz) inside the volume; row_at: device
// int32 (SX, SY, SZ), the output row of each start or -1; total_at: device
// int32 (SX, SY, SZ), the weighted voxel count of each start's box; bins:
// device uint8 scratch of C x RX x RY x RZ, (RX, RY, RZ) = (SX, SY, SZ) +
// (sx, sy, sz) - 1; out: device f32, row r's C x (E + 1) frequencies at
// out + r * out_stride; the tile (TY, TZ) of the rows kernel and the run of
// x starts a block sweeps (xchunk); smem_bytes: the dynamic shared memory
// the tile takes (kernels/dense_hist.py:_rows_plan).
extern "C" int ife_dense_hist(const void* const* chan_ptrs, long long C,
                              const void* weights, const float* edges,
                              long long E, long long X, long long Y,
                              long long Z, long long x0, long long y0,
                              long long z0, long long sx, long long sy,
                              long long sz, const void* row_at,
                              const void* total_at, long long SX,
                              long long SY, long long SZ, void* bins,
                              void* out, long long out_stride, long long TY,
                              long long TZ, long long xchunk,
                              long long smem_bytes, cudaStream_t stream) {
    const long long nbins = E + 1, nq = (nbins + 3) / 4;
    const long long RX = SX + sx - 1, RY = SY + sy - 1, RZ = SZ + sz - 1;
    if (C < 1 || C > 65535 || E < 0 || E > kMaxEdges || sx < 1 || sx > 255
        || sy < 1 || sz < 1 || sx * sz > 32767 || SX < 1 || SY < 1 || SZ < 1
        || x0 < 0 || y0 < 0 || z0 < 0 || x0 + RX > X || y0 + RY > Y
        || z0 + RZ > Z || RX * RY > 0x7fffffffLL || RY * RZ > 0x7fffffffLL
        || TY < 1 || TZ < 1 || TY * TZ > kRowsThreads || xchunk < 1
        || out_stride < C * nbins || smem_bytes > 232448)
        return (int)cudaErrorInvalidValue;
    RowsShape s{};
    s.C = (int)C; s.nbins = (int)nbins; s.nq = (int)nq;
    s.RX = (int)RX; s.RY = (int)RY; s.RZ = (int)RZ;
    s.sx = (int)sx; s.sy = (int)sy; s.sz = (int)sz;
    s.SX = (int)SX; s.SY = (int)SY; s.SZ = (int)SZ;
    s.TY = (int)TY; s.TZ = (int)TZ; s.xchunk = (int)xchunk;
    // row strides with rows r of one warp on distinct banks: a warp of
    // pass 2 reads 32 / nq rows of nq words, one of pass 3 two rows of
    // 2 nq words a half
    const int FZmax = s.TZ + s.sz - 1, FYmax = s.TY + s.sy - 1;
    s.rowCw = FZmax * s.nq + (((s.nq - FZmax * s.nq) % 32) + 32) % 32;
    s.rowRw = 2 * s.TZ * s.nq + (((2 * s.nq - 2 * s.TZ * s.nq) % 32) + 32) % 32;
    s.out_stride = out_stride;
    const long long need = 4LL * (((FYmax * (long long)s.rowCw + 1) & ~1LL)
                                  + FYmax * (long long)s.rowRw
                                  + 2LL * s.TY * s.TZ);
    const long long xchunks = (SX + xchunk - 1) / xchunk;
    dim3 grid((unsigned)((SZ + TZ - 1) / TZ), (unsigned)((SY + TY - 1) / TY),
              (unsigned)(C * xchunks));
    if (need != smem_bytes || grid.y > 65535 || C * xchunks > 65535)
        return (int)cudaErrorInvalidValue;

    unsigned char* b = static_cast<unsigned char*>(bins);
    const long long per = RX * RY * RZ;
    for (long long c0 = 0; c0 < C; c0 += kChannelsPerBinsLaunch) {
        BinChannels chans{};
        const long long n = C - c0 < kChannelsPerBinsLaunch
                            ? C - c0 : kChannelsPerBinsLaunch;
        for (long long c = 0; c < n; ++c)
            chans.p[c] = static_cast<const float*>(chan_ptrs[c0 + c]);
        dense_hist_bins_kernel<<<(unsigned)(RX * RY), 128, 0, stream>>>(
            chans, (int)n, static_cast<const unsigned char*>(weights),
            edges + c0 * E, (int)E, Y, Z, x0, y0, z0, RX, RY, (int)RZ,
            b + c0 * per);
    }
    const bool vec4 = nbins % 4 == 0 && out_stride % 4 == 0
                      && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
    cudaError_t err = cudaFuncSetAttribute(
        dense_hist_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
    dense_hist_rows_kernel<<<grid, kRowsThreads, (size_t)smem_bytes, stream>>>(
        b, static_cast<const int*>(row_at), static_cast<const int*>(total_at),
        static_cast<float*>(out), s, vec4);
    return (int)cudaGetLastError();
}
