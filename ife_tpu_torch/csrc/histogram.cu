// Searchsorted-left histograms of C channels over B boxes, in one launch.
//
// Replaces ife_tpu/kernels/histogram.py:_hist_multi_kernel (called through
// _hist_multi_pallas), the kernel behind histogram_counts_pallas and
// histogram_counts_multi, and the per-ROI binning ife_tpu ran as vmapped
// XLA ops (roi/bag.py:roi_feature_histograms_device), whose batched edges
// the TPU kernel could not take.
//
// What it computes (reference DenseHistogram.h:13-78): for each box b,
// channel c and voxel v of the box with weight w != 0,
// counts[b, c, bin(v)] += w, where bin(v) is the first j with v <= e_c[j]
// (E when there is none) and a NaN value goes to bin E. For non-decreasing
// edges free of NaN (the wrappers check both on the host) that is exactly
// the TPU's cumulative compare-reduce, C[j] = sum w (v <= e_j) followed by
// a difference.
//
// The TPU needed ceil(E/127) passes over the data with an unrolled compare
// per edge and per-lane partials carried along a sequential grid; here
// blocks run in any order, each lane bins its voxels with a binary search,
// and integer atomics make the sum independent of the order of the adds,
// so the counts equal the plain twin's exactly.
//
// What bounds it on the H100: not the bytes (the weights, and the C
// channels of every 32-voxel run that holds a weight: 1.42 GB for bench.py
// config 4, 0.42 ms at 3.35 TB/s) but the work a voxel and channel costs:
// a load, a search of log2(E) + 1 steps, an add. Timed without its atomics
// the kernel lost 0.1 ms of 1.8 on config 4 and without its search steps
// (E = 1) 0.9, so the design (PERF.md) keeps the search lean and many of
// them in flight at full occupancy:
//   * a warp owns a tile of kRuns = 8 runs of 32 consecutive voxels; lane
//     l holds voxel 32 s + l of run s, so every load of a run is coalesced
//     whatever the channel's offset (a view at an offset needs no head or
//     tail path, so no float4). The tile's 8 weight loads are issued
//     together, then per channel its 8 loads, then every search step over
//     the 8 values, then their adds. Of the batches timed
//     in turns (runs x channels 1 x 1, 4 x 2, 4 x 4, 2 x 4, 8 x 2, 16 x 1),
//     8 x 1 was the fastest on every 512^3 shape but the random mask;
//   * a run is skipped by the whole warp when none of its 32 voxels has a
//     weight: its channel lines are never read. A lane never skips on its
//     own: lanes drifting apart cost 4.7x at a random 75% mask;
//   * at most 64 registers a thread (__launch_bounds__), so 32 warps an SM
//     stay resident (a batch of 32 values at 128 registers left 16 and ran
//     slower than one voxel a thread), and a grid of one wave of resident
//     blocks (CUDA's occupancy query);
//   * the search steps over powers of two in a table whose rows are padded
//     with +inf to a power of two (kernels/histogram.py:_edge_row): no bound
//     check and no branch, the same steps in every lane, runs without a
//     weight searched unchecked (this took config 4 from 1.83 to 1.38 ms);
//     the channel pointers are read from the kernel parameters
//     (__grid_constant__);
//   * one atomic add a lane: warp-aggregated adds (__match_any_sync, or a
//     shuffle over runs of lanes) measured slower on every shape, and
//     lanes that share a bin cost little (PERF.md);
//   * the box path walks the box's rows with lanes along z: a lane's
//     (i, j, k) is found by two 32-bit divides a tile and stepped by 32
//     voxels without a divide. Its tiles hold kBoxRuns = 2 runs: a box of
//     41^3 has few tiles for its warps (50 boxes: 0.122 ms as a kernel
//     against 0.126 with 4 runs, 0.144 with 8 and the old form's 0.134).
//
// Memory forms, picked by the wrapper's plan (kernels/histogram.py:_plan):
// edges and private bin copies in shared memory; bins alone in shared
// memory with the edges read through L1 (8 x 4096 edges do not fit beside
// their bins); or edges and counts in global memory when the bins alone
// exceed a block's shared memory (64 x 4097 bins): a second form of the
// kernel, not a fallback to the plain version. Shared bins are flushed
// with global atomics into the zeroed output at block end.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// at most 1024 threads a block, and one such block an SM: a thread keeps to
// 64 registers
constexpr int kHistMaxThreads = 1024;
constexpr int kMaxChannels = 64;  // ife_tpu_torch/kernels/histogram.py _MAX_C
constexpr int kRuns = 8;          // runs of 32 voxels a warp holds a tile
constexpr int kBoxRuns = 2;       // the same in the box path
constexpr unsigned kFull = 0xffffffffu;

struct ChannelPtrs {
    const float* p[kMaxChannels];
};

// kWeights: 0 unweighted, 1 uint8 weights, 2 int32 weights; kBox: the
// voxels are the boxes at `starts` (else one flat run of n voxels)
template <int kWeights, bool kBox, bool kSharedEdges, bool kSharedBins>
__global__ void __launch_bounds__(kHistMaxThreads, 1)
histogram_kernel(const __grid_constant__ ChannelPtrs chans, int C,
                 const void* __restrict__ weights,
                 const float* __restrict__ edges, int E, int top,
                 const int* __restrict__ starts, int Y, int Z, int sy, int sz,
                 long long n, int copies, long long out_box_stride,
                 int* __restrict__ out) {
    extern __shared__ int smem[];  // [C*P edges (f32)][copies x C*(E+1) bins]
    const int nb = E + 1;
    const int P = 2 * top;  // a row of the edge table, +inf past its E edges
    const int nbins = C * nb;
    const int box = blockIdx.y;
    int* gout = out + box * out_box_stride;
    const float* es = edges;
    int* bins = gout;
    int* shared_bins = smem;
    if (kSharedEdges) {
        float* ef = reinterpret_cast<float*>(smem);
        for (int i = threadIdx.x; i < C * P; i += blockDim.x) ef[i] = edges[i];
        es = ef;
        shared_bins = smem + C * P;
    }
    if (kSharedBins) {
        for (int i = threadIdx.x; i < copies * nbins; i += blockDim.x)
            shared_bins[i] = 0;
        bins = shared_bins + ((threadIdx.x >> 5) % copies) * nbins;
    }
    if (kSharedEdges || kSharedBins) __syncthreads();

    long long base = 0;
    int dk = 0, dj = 0, di = 0;  // 32 voxels of the box in (i, j, k) steps
    if (kBox) {
        base = ((long long)starts[3 * box] * Y + starts[3 * box + 1]) * Z
               + starts[3 * box + 2];
        const int dq = 32 / sz;
        dk = 32 - dq * sz;
        di = dq / sy;
        dj = dq - di * sy;
    }
    const int lane = threadIdx.x & 31;
    constexpr int R = kBox ? kBoxRuns : kRuns;
    constexpr int kTile = 32 * R;
    const long long tiles = (n + kTile - 1) / kTile;
    const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
    for (long long tile = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
         tile < tiles; tile += warps) {
        const long long t0 = tile * kTile + lane;
        long long g[R];
        bool ok[R];
        if (kBox) {
            // a box holds fewer than 2^31 - 2^16 voxels (checked below)
            int k = (int)t0, q = k / sz;
            k -= q * sz;
            int i = q / sy, j = q - (q / sy) * sy;
#pragma unroll
            for (int s = 0; s < R; ++s) {
                ok[s] = t0 + 32 * s < n;
                g[s] = base + ((long long)i * Y + j) * Z + k;
                k += dk;
                j += dj;
                i += di;
                if (k >= sz) {
                    k -= sz;
                    ++j;
                }
                if (j >= sy) {
                    j -= sy;
                    ++i;
                }
            }
        } else {
#pragma unroll
            for (int s = 0; s < R; ++s) {
                g[s] = t0 + 32 * s;
                ok[s] = g[s] < n;
            }
        }
        int w[R];
#pragma unroll
        for (int s = 0; s < R; ++s) {
            int ws = 0;
            if (ok[s]) {
                if (kWeights == 0) ws = 1;
                if (kWeights == 1) ws = static_cast<const uint8_t*>(weights)[g[s]];
                if (kWeights == 2) ws = static_cast<const int*>(weights)[g[s]];
            }
            w[s] = ws;
        }
        unsigned live = 0;  // the runs with a weight: the same in every lane
#pragma unroll
        for (int s = 0; s < R; ++s)
            if (__any_sync(kFull, w[s] != 0)) live |= 1u << s;
        if (live == 0) continue;

        for (int c = 0; c < C; ++c) {
            // the channel's loads, then every search step over all of them,
            // then the adds: independent chains the SM overlaps
            const float* p = chans.p[c];
            float v[R];
#pragma unroll
            for (int s = 0; s < R; ++s)
                v[s] = ((live >> s) & 1u) && ok[s] ? __ldg(p + g[s]) : 0.0f;
            // b = the number of edges below v: searchsorted-left's bin for a
            // v that is not NaN (the first j with v <= e[j], else E), by
            // steps over the powers of two from `top` (the largest <= E);
            // the +inf past a row's E edges needs no bound check, and runs
            // without a weight search their zeros unchecked
            int b[R];
#pragma unroll
            for (int s = 0; s < R; ++s) b[s] = 0;
            for (int step = top; step > 0; step >>= 1) {
                const float* e = es + c * P + step - 1;
#pragma unroll
                for (int s = 0; s < R; ++s) {
                    const float ej = kSharedEdges ? e[b[s]] : __ldg(e + b[s]);
                    if (ej < v[s]) b[s] += step;
                }
            }
            int* counts = bins + c * nb;
#pragma unroll
            for (int s = 0; s < R; ++s)
                if (((live >> s) & 1u) && w[s] != 0)
                    atomicAdd(counts + (isnan(v[s]) ? E : b[s]), w[s]);
        }
    }

    if (kSharedBins) {
        __syncthreads();
        for (int i = threadIdx.x; i < nbins; i += blockDim.x) {
            int s = 0;
            for (int k = 0; k < copies; ++k) s += shared_bins[k * nbins + i];
            if (s != 0) atomicAdd(gout + i, s);
        }
    }
}

template <int kWeights, bool kBox, bool kSharedEdges, bool kSharedBins>
cudaError_t launch_form(const ChannelPtrs& chans, int C, const void* weights,
                        const float* edges, int E, int top, const int* starts,
                        int B, int Y, int Z, int sy, int sz, long long n,
                        int copies, int threads, int blocks_per_box,
                        long long out_box_stride, int* out,
                        cudaStream_t stream) {
    auto kernel = histogram_kernel<kWeights, kBox, kSharedEdges, kSharedBins>;
    const size_t smem = (kSharedEdges ? sizeof(float) * (size_t)C * 2 * top : 0)
                        + (kSharedBins ? sizeof(int) * (size_t)copies * C * (E + 1) : 0);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    // one wave: the blocks CUDA's occupancy query keeps resident on every
    // SM, shared over the boxes, at most blocks_per_box (the plan's cap)
    int dev = 0, sms = 0, active = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&active, kernel,
                                                            threads, smem);
    if (err != cudaSuccess) return err;
    const long long wave = (long long)active * sms / B;
    const long long per_box = wave < 1 ? 1 : wave < blocks_per_box ? wave : blocks_per_box;
    const dim3 grid((unsigned)per_box, (unsigned)B);
    kernel<<<grid, threads, smem, stream>>>(chans, C, weights, edges, E, top,
                                            starts, Y, Z, sy, sz, n, copies,
                                            out_box_stride, out);
    return cudaGetLastError();
}

template <int kWeights, bool kBox>
cudaError_t launch_histogram(const ChannelPtrs& chans, int C,
                             const void* weights, const float* edges, int E,
                             int top, const int* starts, int B, int Y, int Z,
                             int sy, int sz, long long n, bool edges_shared,
                             int copies, int threads, int blocks_per_box,
                             long long out_box_stride, int* out,
                             cudaStream_t stream) {
    if (edges_shared && copies > 0)
        return launch_form<kWeights, kBox, true, true>(
            chans, C, weights, edges, E, top, starts, B, Y, Z, sy, sz, n,
            copies, threads, blocks_per_box, out_box_stride, out,
            stream);
    if (!edges_shared && copies > 0)
        return launch_form<kWeights, kBox, false, true>(
            chans, C, weights, edges, E, top, starts, B, Y, Z, sy, sz, n,
            copies, threads, blocks_per_box, out_box_stride, out,
            stream);
    if (!edges_shared && copies == 0)
        return launch_form<kWeights, kBox, false, false>(
            chans, C, weights, edges, E, top, starts, B, Y, Z, sy, sz, n,
            copies, threads, blocks_per_box, out_box_stride, out,
            stream);
    return cudaErrorInvalidValue;  // shared edges need shared bins
}

template <int kWeights>
cudaError_t launch_weights(const ChannelPtrs& chans, int C, const void* weights,
                           const float* edges, int E, int top,
                           const int* starts, int B, int Y, int Z, int sy,
                           int sz, long long n, bool edges_shared, int copies,
                           int threads, int blocks_per_box,
                           long long out_box_stride, int* out,
                           cudaStream_t stream) {
    if (starts != nullptr)
        return launch_histogram<kWeights, true>(
            chans, C, weights, edges, E, top, starts, B, Y, Z, sy, sz, n,
            edges_shared, copies, threads, blocks_per_box,
            out_box_stride, out, stream);
    return launch_histogram<kWeights, false>(
        chans, C, weights, edges, E, top, starts, B, Y, Z, sy, sz, n,
        edges_shared, copies, threads, blocks_per_box,
        out_box_stride, out, stream);
}

}  // namespace

// chan_ptrs: host array of C (<= 64) device pointers to f32 volumes of
// shape (X, Y, Z) (X is not needed: the boxes lie inside), any 4-byte
// aligned offset; weight_kind 0 (weights unused), 1 (uint8) or 2 (int32)
// over the same shape; edges: device (C, P) f32, non-decreasing rows of E
// edges padded with +inf to P = 2 top, top the largest power of two <= E
// (P = 0 for E = 0);
// starts: device (B, 3) int32 box corners, or null for one flat run of
// sx * sy * sz voxels from voxel 0; box size (sx, sy, sz); the plan:
// edges_shared (edges in shared memory), copies (private bin copies in
// shared memory, or 0: counts straight into global memory), threads (256
// or 1024 a block), blocks_per_box (at most: the launch takes one wave of
// the blocks that stay resident); out: device int32, box b's (C, E+1)
// counts at out + b * out_box_stride, zeroed by the caller.
extern "C" int ife_histogram(const void* const* chan_ptrs, long long C,
                             const void* weights, long long weight_kind,
                             const float* edges, long long E,
                             const int* starts, long long B, long long Y,
                             long long Z, long long sx, long long sy,
                             long long sz, long long edges_shared,
                             long long copies, long long threads,
                             long long blocks_per_box,
                             long long out_box_stride, int* out,
                             cudaStream_t stream) {
    const long long n = sx * sy * sz;
    if (C < 1 || C > kMaxChannels || B < 1 || B > 65535 || E < 0
        || E > 0x3fffffffLL || copies < 0 || blocks_per_box < 1
        || blocks_per_box > 0x7fffffffLL
        || (threads != 256 && threads != kHistMaxThreads)
        || sx < 1 || sy < 1 || sz < 1 || Y > 0x7fffffffLL || Z > 0x7fffffffLL
        || (starts != nullptr && n > 0x7fff0000LL) || out_box_stride < C * (E + 1))
        return (int)cudaErrorInvalidValue;
    ChannelPtrs chans{};
    for (long long c = 0; c < C; ++c)
        chans.p[c] = static_cast<const float*>(chan_ptrs[c]);
    int top = 0;
    while (top != 0 ? 2LL * top <= E : E >= 1) top = top != 0 ? 2 * top : 1;
    const bool es = edges_shared != 0;
    cudaError_t err;
    if (weight_kind == 0)
        err = launch_weights<0>(chans, (int)C, weights, edges, (int)E, top,
                                starts, (int)B, (int)Y, (int)Z, (int)sy,
                                (int)sz, n, es, (int)copies, (int)threads,
                                (int)blocks_per_box,
                                out_box_stride, out, stream);
    else if (weight_kind == 1)
        err = launch_weights<1>(chans, (int)C, weights, edges, (int)E, top,
                                starts, (int)B, (int)Y, (int)Z, (int)sy,
                                (int)sz, n, es, (int)copies, (int)threads,
                                (int)blocks_per_box,
                                out_box_stride, out, stream);
    else if (weight_kind == 2)
        err = launch_weights<2>(chans, (int)C, weights, edges, (int)E, top,
                                starts, (int)B, (int)Y, (int)Z, (int)sy,
                                (int)sz, n, es, (int)copies, (int)threads,
                                (int)blocks_per_box,
                                out_box_stride, out, stream);
    else
        err = cudaErrorInvalidValue;
    return (int)err;
}
