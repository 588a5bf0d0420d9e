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
// blocks run in any order, each thread bins its voxels with a binary search
// and an atomic add, and integer atomics make the sum independent of that
// order, so the counts equal the plain twin's exactly.
//
// What bounds it on the H100 (measured at 512^3, PERF.md): not HBM but the
// per-voxel work, C dependent chains of a global load and log2(E) shared
// loads; the atomics add little once the warps stay converged. A voxel
// costs one weight read, C float reads, C binary searches over edges in
// shared memory and C shared-memory atomics. Two choices carry the speed:
//   * a warp skips the channel reads only when ALL its voxels have weight
//     0 (outside the mask: those HBM lines are never read); a warp with
//     some weight bins every lane and adds only where the weight is not 0.
//     Skipping per lane let the lanes of a warp drift apart across loop
//     iterations and cost 4.7x at a random 75% mask;
//   * a grid-stride loop, so every block gets an even share of a mask that
//     is dense in one region (contiguous ranges per block put the whole
//     load of a lung on the few blocks over it).
//
// Layout: blockIdx.y is the box; the box's voxels are walked by a
// grid-stride loop over blockIdx.x (z fastest, so a warp's loads are
// coalesced along z). The C x E edges and the C x (E+1) bins live in shared
// memory; the bins are kept in `copies` private copies (one per warp when
// they fit) and are flushed with global atomics into the zeroed output at
// block end. Where the edges and one copy of the bins exceed a block's
// shared memory (copies == 0, e.g. 64 channels x 4097 bins) the kernel
// reads the edges from global memory and counts straight into global
// memory: a second code path of the kernel, not a fallback to the plain
// version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHistThreads = 256;
constexpr int kMaxChannels = 64;  // ife_tpu_torch/kernels/histogram.py _MAX_C

struct ChannelPtrs {
    const float* p[kMaxChannels];
};

// the first j in [0, E) with v <= e[j], else E; NaN -> E
__device__ __forceinline__ int bin_of(float v, const float* e, int E) {
    if (isnan(v)) return E;
    int lo = 0, hi = E;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (v <= e[mid]) hi = mid;
        else lo = mid + 1;
    }
    return lo;
}

// kWeights: 0 unweighted, 1 uint8 weights, 2 int32 weights
template <int kWeights, bool kSharedBins>
__global__ void __launch_bounds__(kHistThreads)
histogram_kernel(ChannelPtrs chans, int C, const void* __restrict__ weights,
                 const float* __restrict__ edges, int E,
                 const long long* __restrict__ starts, long long Y,
                 long long Z, long long sx, long long sy, long long sz,
                 int copies, int* __restrict__ out) {
    extern __shared__ int smem[];  // [C*E edges (f32)][copies x C*(E+1) bins]
    __shared__ const float* ptrs[kMaxChannels];
    const int nbins = C * (E + 1);
    const long long box = blockIdx.y;
    int* gout = out + box * nbins;

    for (int c = threadIdx.x; c < C; c += blockDim.x) ptrs[c] = chans.p[c];
    const float* e_all = edges;
    int* bins = nullptr;
    if (kSharedBins) {
        float* es = reinterpret_cast<float*>(smem);
        for (int i = threadIdx.x; i < C * E; i += blockDim.x) es[i] = edges[i];
        int* all = smem + C * E;
        for (int i = threadIdx.x; i < copies * nbins; i += blockDim.x) all[i] = 0;
        e_all = es;
        bins = all + ((threadIdx.x >> 5) % copies) * nbins;
    }
    __syncthreads();

    long long x0 = 0, y0 = 0, z0 = 0;
    if (starts != nullptr) {
        x0 = starts[3 * box];
        y0 = starts[3 * box + 1];
        z0 = starts[3 * box + 2];
    }
    const long long base = (x0 * Y + y0) * Z + z0;
    const long long n = sx * sy * sz;
    // a flattened volume is one row (sx == sy == 1): no index division
    const bool one_row = sx == 1 && sy == 1;
    for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < n;
         t += (long long)gridDim.x * blockDim.x) {
        long long g = base + t;
        if (!one_row) {
            const long long r = t / sz, k = t - r * sz;
            const long long i = r / sy, j = r - i * sy;
            g = base + (i * Y + j) * Z + k;
        }
        int w = 1;
        if (kWeights == 1) w = static_cast<const uint8_t*>(weights)[g];
        if (kWeights == 2) w = static_cast<const int*>(weights)[g];
        // skip a warp with no weight at all; never a lane on its own
        if (kWeights != 0 && !__any_sync(__activemask(), w != 0)) continue;
        for (int c = 0; c < C; ++c) {
            const int b = bin_of(ptrs[c][g], e_all + c * E, E);
            if (w != 0) {
                if (kSharedBins) atomicAdd(bins + c * (E + 1) + b, w);
                else atomicAdd(gout + c * (E + 1) + b, w);
            }
        }
    }

    if (kSharedBins) {
        __syncthreads();
        const int* all = smem + C * E;
        for (int i = threadIdx.x; i < nbins; i += blockDim.x) {
            int s = 0;
            for (int k = 0; k < copies; ++k) s += all[k * nbins + i];
            if (s != 0) atomicAdd(gout + i, s);
        }
    }
}

template <int kWeights>
cudaError_t launch_histogram(const ChannelPtrs& chans, int C,
                             const void* weights, const float* edges, int E,
                             const long long* starts, long long B, long long Y,
                             long long Z, long long sx, long long sy,
                             long long sz, int copies, long long blocks_per_box,
                             int* out, cudaStream_t stream) {
    const dim3 grid((unsigned)blocks_per_box, (unsigned)B);
    if (copies == 0) {
        histogram_kernel<kWeights, false><<<grid, kHistThreads, 0, stream>>>(
            chans, C, weights, edges, E, starts, Y, Z, sx, sy, sz, 0, out);
        return cudaGetLastError();
    }
    const size_t smem = sizeof(float) * (size_t)C * E
                        + sizeof(int) * (size_t)copies * C * (E + 1);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            histogram_kernel<kWeights, true>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    histogram_kernel<kWeights, true><<<grid, kHistThreads, smem, stream>>>(
        chans, C, weights, edges, E, starts, Y, Z, sx, sy, sz, copies, out);
    return cudaGetLastError();
}

}  // namespace

// chan_ptrs: host array of C (<= 64) device pointers to f32 volumes of
// shape (X, Y, Z) (X is not needed: the boxes lie inside); weight_kind 0
// (weights unused), 1 (uint8) or 2 (int32) over the same shape; edges:
// device (C, E) f32, non-decreasing rows; starts: device (B, 3) int64 box
// corners or null for one box at (0, 0, 0); box size (sx, sy, sz); copies:
// private bin copies per block (>= 1, shared memory) or 0 (global path);
// out: device (B, C, E+1) int32, zeroed by the caller.
extern "C" int ife_histogram(const void* const* chan_ptrs, long long C,
                             const void* weights, long long weight_kind,
                             const float* edges, long long E,
                             const long long* starts, long long B, long long Y,
                             long long Z, long long sx, long long sy,
                             long long sz, long long copies,
                             long long blocks_per_box, int* out,
                             cudaStream_t stream) {
    if (C < 1 || C > kMaxChannels || B < 1 || B > 65535 || blocks_per_box < 1
        || blocks_per_box > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    ChannelPtrs chans{};
    for (long long c = 0; c < C; ++c)
        chans.p[c] = static_cast<const float*>(chan_ptrs[c]);
    cudaError_t err;
    if (weight_kind == 0)
        err = launch_histogram<0>(chans, (int)C, weights, edges, (int)E, starts,
                                  B, Y, Z, sx, sy, sz, (int)copies,
                                  blocks_per_box, out, stream);
    else if (weight_kind == 1)
        err = launch_histogram<1>(chans, (int)C, weights, edges, (int)E, starts,
                                  B, Y, Z, sx, sy, sz, (int)copies,
                                  blocks_per_box, out, stream);
    else if (weight_kind == 2)
        err = launch_histogram<2>(chans, (int)C, weights, edges, (int)E, starts,
                                  B, Y, Z, sx, sy, sz, (int)copies,
                                  blocks_per_box, out, stream);
    else
        err = cudaErrorInvalidValue;
    return (int)err;
}
