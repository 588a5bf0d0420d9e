// Normalized Gaussian convolution: out = G*(c*f) / G*c, separable FIR with
// edge-clamped (ZeroFluxNeumann) indices, the certainty c used RAW, and the
// divide without epsilon (NaN = 0/0 outside the certainty support, as in the
// reference NormalizedGaussianConvolutionImageFilter.hxx:40-63).
//
// Replaces ife_tpu/kernels/fused.py:fused_normalized_conv_sweep (kernel
// _nc_sweep_kernel). The TPU kernel swept x with a VMEM ring of input rows
// whose size capped the radius (and sent large sigma to an MXU band-einsum
// path); here there is no such cap below kMaxTaps.
//
// Three separable passes in the order of ops/stencil.py gaussian_smooth —
// x, then y, then z — for the numerator (c*f) and the denominator (c),
// through two scratch volumes S1, S2 and the output O:
//   x: (f, c) -> S1 = G_x*(c*f), S2 = G_x*c   (one launch, both arrays)
//   y: S1 -> O,  y: S2 -> S1
//   z: (O, S1) -> O = G_z*O / G_z*S1 (in place: a block owns whole z rows)
// 11 volumes of traffic. The y pair cannot share a launch: its two outputs
// would need a fourth volume, or a y pass in place. Each output is
// sum_k t[k] * in[clamp(i + k - r)] in tap order, tap 0's product first,
// f32 taps rounded once from the f64 numpy taps, so with the library built
// without FMA contraction every pass equals its plain twin to the bit.
//
// What bounds it on the H100: the issue of the taps' arithmetic. Unfused,
// each tap costs an FMUL and an FADD per output and array, 2 * 2 * (2r + 1)
// instructions a voxel and pass; at sigma 4.8 (r = 28 / 28 / 22 at 0.78 mm)
// that is ~2.5 ms of the SMs' 33.5 T FP32 instructions/s at 512^3 against
// ~1.8 ms for the 11 volumes at 3.35 TB/s. So the design keeps every other
// instruction off the walk:
//   - the taps live in shared memory, read once a step for all outputs and
//     arrays of a thread (no dynamic index into the kernel parameter);
//   - a thread makes a run of consecutive outputs, taps outer: step k adds
//     t[k] * in[k + u] to every output u of the run, so an input is loaded
//     once for the run and a tap once for the run and both arrays, and each
//     output is still summed in tap order;
//   - the inputs are staged in shared memory once, at clamped positions,
//     so the walk never clamps.
//
// ife_smooth_yz runs the y and z passes alone (no divide), for the
// features8_xs_stream branch of ops/features.py, where the x pass, the
// divide and the feature tail follow in one kernel (features8_sweep.cu);
// ife_smooth_xz runs the x and z passes alone, per scale ahead of the
// multi-scale kernel (features8_ys_multi.cu), which adds the y pass, the
// divide and the tail; ife_tpu smooths x and z there with XLA band einsums
// (ife_tpu/ops/features.py multiscale_features8_fused). Each is one paired
// axis launch, (f, c) -> (num, den), and the z pass in place on both.
#include <cstdint>

#include <cuda_runtime.h>

#include "fir.cuh"

// taps in shared memory, zero-padded to a multiple of 8 floats (so a 16-byte
// read of four taps from any multiple of 4 below 2r + 1 stays inside; the
// padding is loaded, never multiplied)
__host__ __device__ constexpr int taps_floats(int r) {
    return (2 * r + 1 + 7) & ~7;
}

__device__ __forceinline__ void stage_taps(const Taps& taps, float* st) {
    const int nt = 2 * taps.r + 1;
    for (int i = threadIdx.x; i < taps_floats(taps.r); i += blockDim.x)
        st[i] = i < nt ? taps.t[i] : 0.0f;
}

// ---------------------------------------------------------------------------
// x and y passes
// ---------------------------------------------------------------------------

// One group of kRun steps k .. k + kRun - 1 of a taps-outer walk over a ring
// of kRun registers per array (slot m % kRun holds input m): step k loads
// input k + kRun - 1 into the slot input k - 1 left, then adds t[k] * in[k+u]
// to output u. k is a multiple of kRun, so every slot index is a constant.
// kFirst: the group holds step 0, whose product starts each sum; kGuard: the
// group may pass the last tap. in(a, i): input i of array a.
template <int kRun, int kArrays, bool kFirst, bool kGuard, class In>
__device__ __forceinline__ void ring_group(const In& in, const float* st,
                                           int k, int nt,
                                           float (&w)[kArrays][kRun],
                                           float (&acc)[kArrays][kRun]) {
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
        if (kGuard && k + j >= nt) break;
        const float t = st[k + j];
#pragma unroll
        for (int a = 0; a < kArrays; ++a) {
            w[a][(j + kRun - 1) % kRun] = in(a, k + j + kRun - 1);
#pragma unroll
            for (int u = 0; u < kRun; ++u) {
                const float p = t * w[a][(j + u) % kRun];
                acc[a][u] = kFirst && j == 0 ? p : acc[a][u] + p;
            }
        }
    }
}

// kRun consecutive outputs out[u] = sum_k t[k] * in[k + u] of kArrays arrays,
// k = 0 .. nt - 1 in order, from inputs 0 .. nt + kRun - 2.
template <int kRun, int kArrays, class In>
__device__ __forceinline__ void ring_walk(const In& in, const float* st,
                                          int nt,
                                          float (&acc)[kArrays][kRun]) {
    float w[kArrays][kRun];
#pragma unroll
    for (int a = 0; a < kArrays; ++a)
#pragma unroll
        for (int m = 0; m < kRun - 1; ++m) w[a][m] = in(a, m);
    if (nt < kRun) {
        ring_group<kRun, kArrays, true, true>(in, st, 0, nt, w, acc);
        return;
    }
    ring_group<kRun, kArrays, true, false>(in, st, 0, nt, w, acc);
    int k = kRun;
    for (; k + kRun <= nt; k += kRun)
        ring_group<kRun, kArrays, false, false>(in, st, k, nt, w, acc);
    if (k < nt) ring_group<kRun, kArrays, false, true>(in, st, k, nt, w, acc);
}

// out = G_axis * in along axis 0 (x) or 1 (y) of an (X, Y, Z) volume, for
// kArrays arrays; kWeighted: the two inputs are (f, c) and the arrays are
// (c*f, c), c*f rounded once as in the plain twin. A block owns kAxisTileA
// outputs along the axis for kAxisTileZ columns of z at one position of the
// third axis. It stages its inputs, the tile extended by the radius at both
// ends at clamped positions, in shared memory ([array][position][z]) by
// cp.async, every load in flight at once; each thread then makes a run of
// consecutive outputs of one column (ring_walk), a warp's lanes on 32
// neighbouring columns (no bank conflict). The halo is read
// (kAxisTileA + 2r) / kAxisTileA times (1.44 at r = 28), mostly from L2.
// Blocks are numbered so that those resident together read neighbouring
// memory: z tiles fastest, then for the x pass y (blockIdx.z is the x tile),
// for the y pass the y tile (blockIdx.z is x).
constexpr int kAxisTileA = 128;
constexpr int kAxisTileZ = 32;
// outputs a thread makes of each array (divide kAxisTileA): the pair's and
// the single pass's, 16 accumulators either way. Measured at 512^3, sigma
// 4.8 (device ms in turns, one H100): the single y pass 0.73 ms a launch
// at a run of 16 against 0.77 at 8; a run of 4 or a tile of 64 cost the
// paired x pass 0.2 and 0.1 ms; staging by plain loads in place of
// cp.async, ~1 ms more on nc.
constexpr int kAxisRunPair = 8;
constexpr int kAxisRunSingle = 16;
constexpr int kAxisThreads = 256;

template <int kArrays, bool kWeighted>
__global__ void __launch_bounds__(kAxisThreads)
fir_axis_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ out_a, float* __restrict__ out_b, int X,
                int Y, int Z, int axis, Taps taps) {
    static_assert(kArrays == 1 || kArrays == 2, "one or two arrays");
    static_assert(!kWeighted || kArrays == 2, "the weighted pass pairs");
    extern __shared__ __align__(16) float smem[];
    constexpr int TA = kAxisTileA, TZ = kAxisTileZ;
    constexpr int RUN = kArrays == 2 ? kAxisRunPair : kAxisRunSingle;
    const int r = taps.r, nt = 2 * r + 1;
    const int rows = TA + 2 * r;  // staged positions along the axis
    float* const st = smem;
    float* const tile = smem + taps_floats(r);  // [kArrays][rows][TZ]
    const int n = axis == 0 ? X : Y;
    const int z0 = blockIdx.x * TZ;
    const int a0 = (axis == 0 ? blockIdx.z : blockIdx.y) * TA;
    const int other = axis == 0 ? blockIdx.y : blockIdx.z;
    const long long stride = axis == 0 ? (long long)Y * Z : (long long)Z;
    // offset of position 0 along the axis, column 0 of z
    const long long base = axis == 0 ? (long long)other * Z
                                     : (long long)other * Y * Z;
    stage_taps(taps, st);
    // every load in flight at once (cp.async); a column past Z feeds only
    // outputs that are never written, so it loads column Z - 1
    const int zl = threadIdx.x % TZ, z_in = min(z0 + zl, Z - 1);
    constexpr int kStep = kAxisThreads / TZ;
    for (int i = threadIdx.x / TZ; i < rows; i += kStep) {
        const long long off =
            base + clamp_index(a0 - r + i, n) * stride + z_in;
        cp_async_f32(tile + i * TZ + zl, a + off);
        if (kArrays == 2) cp_async_f32(tile + (rows + i) * TZ + zl, b + off);
    }
    cp_async_wait_all();
    if (kWeighted)  // c*f rounded once, as plain; each thread its own cells
        for (int i = threadIdx.x / TZ; i < rows; i += kStep)
            tile[i * TZ + zl] *= tile[(rows + i) * TZ + zl];
    __syncthreads();
    for (int item = threadIdx.x; item < (TA / RUN) * TZ; item += blockDim.x) {
        const int i0 = (item / TZ) * RUN, z = z0 + item % TZ;
        if (a0 + i0 >= n || z >= Z) continue;
        const float* const col = tile + i0 * TZ + item % TZ;
        float acc[kArrays][RUN];
        ring_walk<RUN, kArrays>(
            [&](int arr, int i) { return col[(arr * rows + i) * TZ]; }, st, nt,
            acc);
#pragma unroll
        for (int u = 0; u < RUN; ++u) {
            if (a0 + i0 + u >= n) break;
            const long long off = base + (long long)(a0 + i0 + u) * stride + z;
            out_a[off] = acc[0][u];
            if (kArrays == 2) out_b[off] = acc[kArrays - 1][u];
        }
    }
}

template <int kArrays, bool kWeighted>
static cudaError_t launch_fir_axis(const float* a, const float* b,
                                   float* out_a, float* out_b, long long X,
                                   long long Y, long long Z, int axis,
                                   const Taps& taps, cudaStream_t stream) {
    const size_t smem =
        (taps_floats(taps.r)
         + (size_t)kArrays * (kAxisTileA + 2 * taps.r) * kAxisTileZ)
        * sizeof(float);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            fir_axis_kernel<kArrays, kWeighted>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    const unsigned gz = (unsigned)((Z + kAxisTileZ - 1) / kAxisTileZ);
    const unsigned ga = (unsigned)(((axis == 0 ? X : Y) + kAxisTileA - 1)
                                   / kAxisTileA);
    const dim3 grid = axis == 0 ? dim3(gz, (unsigned)Y, ga)
                                : dim3(gz, ga, (unsigned)X);
    fir_axis_kernel<kArrays, kWeighted><<<grid, kAxisThreads, smem, stream>>>(
        a, b, out_a, out_b, (int)X, (int)Y, (int)Z, axis, taps);
    return cudaSuccess;
}

// ---------------------------------------------------------------------------
// z pass
// ---------------------------------------------------------------------------

// A block owns `rows` whole z rows of numerator and denominator and walks
// them in chunks of `chunk` outputs: it stages each row's chunk with its
// clamped halo in shared memory ([row][num, den][len]: inputs z = c0 - r +
// j) by cp.async, every load in flight at once, and each thread makes kZRun
// consecutive outputs of one row, taps outer, from 16-byte reads: four
// inputs of each array and four taps a read, a warp's lanes on neighbouring
// runs (512 contiguous bytes, no conflict). Rows of up to kZRun * kZThreads
// voxels are one chunk, several rows a block; longer rows take one block
// each and several chunks. A chunk's successor is staged before the chunk's
// outputs are written, and a chunk is at least r long, so out may alias num
// or den: the halo a block reads back is never one it has written, and no
// other block reads its rows. (Blocks as many as the card holds at once,
// each taking row groups in turn with the next group in flight in a second
// buffer while this one is walked: at 512^3 the pass in place 0.85 ms
// against 0.96 at rz 11 but 1.32 against 1.27 at rz 22, with the divide
// 1.53 against 1.47 (one H100, in turns): not kept.)
constexpr int kZRun = 4;
constexpr int kZThreads = 256;
// __launch_bounds__' blocks an SM: at most 40 registers, 6 blocks of 8 warps
// (the z pass with the divide 1.47 ms at sigma 4.8 against 1.55 with the
// compiler's 48 registers, 1.48 at 8 blocks)
constexpr int kZMinBlocks = 6;
constexpr int kZSmem = 48 * 1024;

struct ZPlan {
    int rows;   // z rows a block owns
    int chunk;  // outputs a row and step, a multiple of kZRun
    int len;    // staged inputs a row and array: chunk + 2r + 8, rounded
                // up to a multiple of 4 (every row 16-byte aligned)
    size_t smem;
};

// Mirrored by ife_tpu_torch/kernels/normalized_conv.py z_plan.
static ZPlan z_plan(long long Z, int r) {
    ZPlan p;
    const long long runs = (Z + kZRun - 1) / kZRun;
    if (runs >= kZThreads) {
        p.rows = 1;
        p.chunk = kZRun * kZThreads;
    } else {
        p.rows = kZThreads / (int)runs;
        p.chunk = kZRun * (int)runs;
    }
    p.len = p.chunk + ((2 * r + 3) & ~3) + 8;
    const size_t per_row = 2 * (size_t)p.len * sizeof(float);
    const size_t room = kZSmem - taps_floats(r) * sizeof(float);
    p.rows = std::max(1, std::min(p.rows, (int)(room / per_row)));
    p.smem = taps_floats(r) * sizeof(float) + p.rows * per_row;
    return p;
}

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

// steps k .. k + 3 of the z walk (k a multiple of 4): n0 / d0 hold inputs
// k .. k + 3 of num / den, the group reads k + 4 .. k + 7 and the taps
// k .. k + 3; out[u] += t[k + j] * in[k + j + u]
template <bool kFirst, bool kGuard>
__device__ __forceinline__ void z_group(const float* pn, const float* pd,
                                        const float* st, int k, int nt,
                                        float4& n0, float4& d0,
                                        float (&an)[kZRun],
                                        float (&ad)[kZRun]) {
    const float4 n1 = ld4(pn + k + 4), d1 = ld4(pd + k + 4), tq = ld4(st + k);
    const float vn[8] = {n0.x, n0.y, n0.z, n0.w, n1.x, n1.y, n1.z, n1.w};
    const float vd[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
    const float t[4] = {tq.x, tq.y, tq.z, tq.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        if (kGuard && k + j >= nt) break;
#pragma unroll
        for (int u = 0; u < kZRun; ++u) {
            const float qn = t[j] * vn[j + u], qd = t[j] * vd[j + u];
            an[u] = kFirst && j == 0 ? qn : an[u] + qn;
            ad[u] = kFirst && j == 0 ? qd : ad[u] + qd;
        }
    }
    n0 = n1;
    d0 = d1;
}

// the kZRun outputs of num and den whose inputs start at pn / pd
__device__ __forceinline__ void z_walk(const float* pn, const float* pd,
                                       const float* st, int nt,
                                       float (&an)[kZRun],
                                       float (&ad)[kZRun]) {
    float4 n0 = ld4(pn), d0 = ld4(pd);
    if (nt < 4) {
        z_group<true, true>(pn, pd, st, 0, nt, n0, d0, an, ad);
        return;
    }
    z_group<true, false>(pn, pd, st, 0, nt, n0, d0, an, ad);
    int k = 4;
    for (; k + 4 <= nt; k += 4)
        z_group<false, false>(pn, pd, st, k, nt, n0, d0, an, ad);
    if (k < nt) z_group<false, true>(pn, pd, st, k, nt, n0, d0, an, ad);
}

// out = G_z*num / G_z*den per z row (kDivide), else num = G_z*num and
// den = G_z*den in place; out may alias num or den. vec: Z % 4 == 0 and the
// three pointers 16-byte aligned (float4 stores).
template <bool kDivide>
__global__ void __launch_bounds__(kZThreads, kZMinBlocks)
fir_z_kernel(float* num, float* den, float* out, long long n_rows, int Z,
             int rows, int chunk, int len, int vec, Taps taps) {
    extern __shared__ __align__(16) float smem[];
    const int r = taps.r, nt = 2 * r + 1;
    float* const st = smem;
    const int runs = chunk / kZRun;
    const int lr = threadIdx.x / runs, run = threadIdx.x % runs;
    const long long row = (long long)blockIdx.x * rows + lr;
    const bool mine = lr < rows && row < n_rows;
    const long long off = row * Z;
    float* const bn = smem + taps_floats(r) + (size_t)lr * 2 * len;
    float* const bd = bn + len;
    stage_taps(taps, st);
    auto stage = [&](int c0) {  // every load in flight at once
        if (!mine) return;
        for (int j = run; j < len; j += runs) {
            const int z = clamp_index(c0 - r + j, Z);
            cp_async_f32(bn + j, num + off + z);
            cp_async_f32(bd + j, den + off + z);
        }
        cp_async_wait_all();
    };
    stage(0);
    __syncthreads();
    for (int c0 = 0;; c0 += chunk) {
        const int z = c0 + kZRun * run;
        float an[kZRun], ad[kZRun];
        if (mine && z < Z) z_walk(bn + kZRun * run, bd + kZRun * run, st, nt,
                                  an, ad);
        const bool more = c0 + chunk < Z;
        if (more) {  // stage the next chunk before this one is written
            __syncthreads();
            stage(c0 + chunk);
            __syncthreads();
        }
        if (mine && z < Z) {
            if (kDivide) {  // no epsilon: 0/0 = NaN off the support
                if (vec) {
                    *reinterpret_cast<float4*>(out + off + z) = make_float4(
                        an[0] / ad[0], an[1] / ad[1], an[2] / ad[2],
                        an[3] / ad[3]);
                } else {
#pragma unroll
                    for (int u = 0; u < kZRun; ++u)
                        if (z + u < Z) out[off + z + u] = an[u] / ad[u];
                }
            } else if (vec) {
                *reinterpret_cast<float4*>(num + off + z) =
                    make_float4(an[0], an[1], an[2], an[3]);
                *reinterpret_cast<float4*>(den + off + z) =
                    make_float4(ad[0], ad[1], ad[2], ad[3]);
            } else {
#pragma unroll
                for (int u = 0; u < kZRun; ++u) {
                    if (z + u < Z) {
                        num[off + z + u] = an[u];
                        den[off + z + u] = ad[u];
                    }
                }
            }
        }
        if (!more) break;
    }
}

static bool aligned16(const void* p) {
    return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

template <bool kDivide>
static cudaError_t launch_fir_z(float* num, float* den, float* out,
                                long long X, long long Y, long long Z,
                                const Taps& tz, cudaStream_t stream) {
    const ZPlan p = z_plan(Z, tz.r);
    const long long n_rows = X * Y;
    const int vec = Z % 4 == 0 && aligned16(num) && aligned16(den)
                    && (!kDivide || aligned16(out));
    fir_z_kernel<kDivide>
        <<<(unsigned)((n_rows + p.rows - 1) / p.rows), kZThreads, p.smem,
           stream>>>(num, den, out, n_rows, (int)Z, p.rows, p.chunk, p.len,
                     vec, tz);
    return cudaSuccess;
}

// image, cert, out, s1, s2: contiguous (X, Y, Z) float32 on the device (s1,
// s2 are scratch); taps_*: host arrays of 2r+1 floats per axis.
extern "C" int ife_normalized_conv(const float* image, const float* cert,
                                   float* out, float* s1, float* s2,
                                   long long X, long long Y, long long Z,
                                   const float* taps_x, long long ntx,
                                   const float* taps_y, long long nty,
                                   const float* taps_z, long long ntz,
                                   cudaStream_t stream) {
    Taps tx, ty, tz;
    if (!make_taps(taps_x, ntx, &tx) || !make_taps(taps_y, nty, &ty)
        || !make_taps(taps_z, ntz, &tz))
        return (int)cudaErrorInvalidValue;
    cudaError_t e = launch_fir_axis<2, true>(image, cert, s1, s2, X, Y, Z, 0,
                                             tx, stream);
    if (e == cudaSuccess)
        e = launch_fir_axis<1, false>(s1, nullptr, out, nullptr, X, Y, Z, 1,
                                      ty, stream);
    if (e == cudaSuccess)
        e = launch_fir_axis<1, false>(s2, nullptr, s1, nullptr, X, Y, Z, 1,
                                      ty, stream);
    if (e == cudaSuccess)
        e = launch_fir_z<true>(out, s1, out, X, Y, Z, tz, stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// num = G_z*G_a*(cert*image), den = G_z*G_a*cert for a = axis (0: x, 1: y)
static int smooth_pair(int axis, const float* image, const float* cert,
                       float* num, float* den, long long X, long long Y,
                       long long Z, const float* taps_a, long long nta,
                       const float* taps_z, long long ntz,
                       cudaStream_t stream) {
    Taps ta, tz;
    if (!make_taps(taps_a, nta, &ta) || !make_taps(taps_z, ntz, &tz))
        return (int)cudaErrorInvalidValue;
    cudaError_t e = launch_fir_axis<2, true>(image, cert, num, den, X, Y, Z,
                                             axis, ta, stream);
    if (e == cudaSuccess)
        e = launch_fir_z<false>(num, den, nullptr, X, Y, Z, tz, stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// num = G_z*G_y*(cert*image), den = G_z*G_y*cert: contiguous (X, Y, Z)
// float32 on the device; taps_*: host arrays of 2r+1 floats.
extern "C" int ife_smooth_yz(const float* image, const float* cert,
                             float* num, float* den,
                             long long X, long long Y, long long Z,
                             const float* taps_y, long long nty,
                             const float* taps_z, long long ntz,
                             cudaStream_t stream) {
    return smooth_pair(1, image, cert, num, den, X, Y, Z, taps_y, nty, taps_z,
                       ntz, stream);
}

// num = G_z*G_x*(cert*image), den = G_z*G_x*cert: as ife_smooth_yz, along x
// instead of y.
extern "C" int ife_smooth_xz(const float* image, const float* cert,
                             float* num, float* den,
                             long long X, long long Y, long long Z,
                             const float* taps_x, long long ntx,
                             const float* taps_z, long long ntz,
                             cudaStream_t stream) {
    return smooth_pair(0, image, cert, num, den, X, Y, Z, taps_x, ntx, taps_z,
                       ntz, stream);
}
