// Hessian + eigen features of the unsmoothed volume, one pass.
//
// Replaces ife_tpu/kernels/fused.py:fused_hessian_eig_stream (kernel
// _stream_kernel) and fused_hessian_eig (kernel _kernel, the same math
// through manual-DMA windows): the central-difference Hessian (cascaded
// cross terms, edge clamp) of x and its six eigen features
// {e1, e2, e3, LoG, Gaussian curvature, Frobenius norm}.
//
// What bounds it on the H100: bytes, 1 float read and 6 written per voxel
// (28 B; 1.12 ms at 512^3), against ~150 f32 operations a voxel, each issued
// on its own (--fmad=false, kernels/_build.py): ~0.6 ms of issue at 512^3.
// One thread per voxel that loaded its 19 neighbours with clamped 64-bit
// addresses and stored six scalars spent as long again on addresses, loads
// and stores, and issue did not hide under the bytes (1.96 ms; PERF.md §6,
// the probes' split). So the design spends few instructions around the solve:
//   * a thread owns a run of kRun = 4 voxels along z, a warp one row of 128,
//     a block kTileY rows of one x plane;
//   * per neighbour row (x + a - 1, y + b - 1) one 16-byte load of the run,
//     the nine issued together, and the z rims of the five rows that need
//     them from the neighbouring lanes by __shfl (a load at a warp's ends);
//   * the clamps, halo rows and layer are resolved once a row, in its
//     address (PlaneSource::base, row_offset): the clamped plane and row
//     (whole volume), lo / hi by a select for the planes -1 and X (x_halo),
//     the layer's own rows (pre_padded); offsets within a plane are 32-bit;
//   * the shared tail (features8_tail.cuh) per voxel, and each channel as
//     one 16-byte store.
// That is the kWide instantiation (Z % 4 == 0, 16-byte aligned pointers);
// the other loads each column at its clamped z and stores scalars.
//
// Measured at 512^3 on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6;
// device ms): 1.32 whole volume, 1.34
// x_halo, 1.35 pre_padded, within 3% of its own copy floor (kCopyFloor,
// 1.31) and below trivial6's 1-read-6-write floor at PyTorch's launch shape
// (1.34). A block that marched x through a ring of planes in shared memory
// (cp.async, one barrier a plane), the shape of the TPU's _stream_kernel,
// took 1.39-1.40 in every mode and its copy floor 1.41: the ring's
// traffic, not the solve, bounded it.
//
// The shard modes of the TPU kernels (x_halo = _stream_kernel's ext_halo,
// pre_padded) are StencilModes of the same kernel (features8_tail.cuh):
// the rows -1 and X come from two extra row pointers, or the block already
// carries its boundary layer on x and y; only the core is written.
//
// The outputs (HessianOutput) are the same kernel, loads and stores with
// another function of the neighbourhood: kReference the reference's eigen
// path (ife_tpu.ops.features.hessian_eig_features, which has no Pallas
// kernel: XLA ops); the roofline probes of the TPU kernel kCopyFloor
// (ife_tpu/kernels/fused.py:472-478, _kernel's variant="copyfloor", and
// benchmarks/probe11.py:99 floor_window, the same function), kCopy6 and
// kStencil6 (benchmarks/probe_fused.py:29 _variant_kernel's "copy6" and
// "stencil6"). These take the whole-volume mode only.
#include <cuda_runtime.h>

#include <cstdint>
#include <limits>

#include "features8_tail.cuh"

// What the kernel writes per voxel, six channels:
//   kFeatures   the six eigen features on the polynomial path (the Pallas
//               kernel's function);
//   kCopyFloor  s + k, channel k = 0..5: the copy floor of this kernel shape;
//   kCopy6      s, six times;
//   kStencil6   Dxx, Dyy, Dzz, Dxy, Dxz, Dyz, the stencil without the eigen
//               solve;
//   kReference  the six eigen features on the reference's trig path with
//               its diagonal branch.
enum HessianOutput {
    kFeatures = 0, kCopyFloor = 1, kCopy6 = 2, kStencil6 = 3, kReference = 4
};

// The block's geometry (mirrored by kernels/hessian_eig.py HESSIAN_TILE):
// a thread owns a run of kRun voxels along z, a warp one tile row of 32
// runs, a block kTileY rows of one x plane.
constexpr int kRun = 4;
constexpr int kTileZ = 32 * kRun;
constexpr int kTileY = 8;
constexpr int kThreads = 32 * kTileY;

// Where the planes of the kernel's source lie: plane xp in [-1, X] of the
// core, in each mode.
template <int kMode>
struct PlaneSource {
    const float* s;
    const float* lo;
    const float* hi;
    long long plane;  // floats between two planes of s
    int X;

    __device__ __forceinline__ const float* base(int xp) const {
        if (kMode == kPrePadded) return s + (long long)(xp + 1) * plane;
        const float* p = s + (long long)min(max(xp, 0), X - 1) * plane;
        if (kMode == kXHalo) {  // selects, not branches
            p = xp < 0 ? lo : p;
            p = xp >= X ? hi : p;
        }
        return p;
    }
};

// the offset within a plane of the source row of row yy in [-1, Y]: the
// clamped row, or the layer's own in pre_padded mode
template <int kMode>
__device__ __forceinline__ int row_offset(int yy, int Y, int Z) {
    if (kMode == kPrePadded) return (yy + 1) * Z;
    return min(max(yy, 0), Y - 1) * Z;
}

// The six outputs of each voxel of a run from its neighbour rows r[a][b]
// (columns z - 1 .. z + kRun of row (x + a - 1, y + b - 1); the corner rows'
// rims are never read).
template <int kOut>
__device__ __forceinline__ void run_outputs(
    const float (&r)[3][3][kRun + 2], const StencilRecip& k, float never,
    float (&o)[6][kRun]) {
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
        float v[3][3][3];
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int b = 0; b < 3; ++b)
#pragma unroll
                for (int c = 0; c < 3; ++c) v[a][b][c] = r[a][b][j + c];
        float f[6];
        if (kOut == kFeatures || kOut == kReference) {
            float gm, h[6];
            hessian_stencil(v, k, gm, h);
            if (kOut == kFeatures)
                eigen_features(h[0], h[1], h[2], h[3], h[4], h[5], f);
            else
                eigen_features_reference(h[0], h[1], h[2], h[3], h[4],
                                         h[5], f);
        } else if (kOut == kStencil6) {
            float gm, h[6];
            hessian_stencil(v, k, gm, h);
            const int order[6] = {0, 3, 5, 1, 2, 4};  // from the packed order
#pragma unroll
            for (int c = 0; c < 6; ++c) f[c] = h[order[c]];
        } else {
            // only the centre is written: keep the other 18 reads live,
            // as the TPU kernel's window DMA moved them, by a select on
            // their sum that is never taken (`never` is NaN at run
            // time, unknown to the compiler)
            float sum = 0.0f;
#pragma unroll
            for (int a = 0; a < 3; ++a)
#pragma unroll
                for (int b = 0; b < 3; ++b)
#pragma unroll
                    for (int c = 0; c < 3; ++c)
                        if (a == 1 || b == 1 || c == 1) sum += v[a][b][c];
            const float s0 = sum == never ? sum : v[1][1][1];
#pragma unroll
            for (int c = 0; c < 6; ++c)
                f[c] = kOut == kCopyFloor ? s0 + (float)c : s0;
        }
#pragma unroll
        for (int c = 0; c < 6; ++c) o[c][j] = f[c];
    }
}

// Store a run's six channels at dst (channel c at dst + c n): 16-byte
// stores where kWide, else the run's voxels inside Z one by one.
template <bool kWide>
__device__ __forceinline__ void store_run(float* dst, long long n, int zr,
                                          int Z, const float (&o)[6][kRun]) {
    if (kWide) {
#pragma unroll
        for (int c = 0; c < 6; ++c)
            *reinterpret_cast<float4*>(dst + c * n) =
                make_float4(o[c][0], o[c][1], o[c][2], o[c][3]);
    } else {
#pragma unroll
        for (int j = 0; j < kRun; ++j)
            if (zr + j < Z)
#pragma unroll
                for (int c = 0; c < 6; ++c) dst[c * n + j] = o[c][j];
    }
}

// The nine neighbour rows of a run: r[a][b][c] = s at row (x + a - 1,
// y + b - 1), column z - 1 + c (c = 0 .. kRun + 1); the corner rows (a, b
// != 1) their core alone. Two forms, each its own instantiation of the
// kernel (kWide), so that each is straight-line code whose nine row loads
// the compiler issues together (one kernel with both forms behind a
// run-time flag took 1.56 ms at 512^3 against 1.33: PERF.md §6).
//
// Wide rows (Z % 4 == 0, 16-byte aligned pointers): a 16-byte load a row,
// the z rims from the neighbouring lanes by __shfl (a load at a warp's
// ends, the clamp at the volume's). Every lane of the warp takes part
// (zr past Z included: it loads the last run inside Z).
template <int kMode>
__device__ __forceinline__ void load_rows_wide(
    const PlaneSource<kMode>& src, int x, int y, int zr, int Y, int Z,
    float (&r)[3][3][kRun + 2]) {
    const int lane = threadIdx.x & 31;
    const int zc = min(zr, Z - kRun);
    float4 q[3][3];
    const float* rows[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        const float* plane = src.base(x + a - 1);
#pragma unroll
        for (int b = 0; b < 3; ++b) {
            rows[a][b] = plane + row_offset<kMode>(y + b - 1, Y, Z);
            q[a][b] = __ldg(reinterpret_cast<const float4*>(rows[a][b] + zc));
        }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) {
            r[a][b][1] = q[a][b].x;
            r[a][b][2] = q[a][b].y;
            r[a][b][3] = q[a][b].z;
            r[a][b][4] = q[a][b].w;
            r[a][b][0] = r[a][b][kRun + 1] = 0.0f;  // a corner row's: unread
            if (a == 1 || b == 1) {
                float left = __shfl_up_sync(0xffffffffu, q[a][b].w, 1);
                float right = __shfl_down_sync(0xffffffffu, q[a][b].x, 1);
                if (lane == 0)
                    left = zc == 0 ? q[a][b].x : __ldg(rows[a][b] + zc - 1);
                if (lane == 31 || zc + kRun >= Z)
                    right = zc + kRun < Z ? __ldg(rows[a][b] + zc + kRun)
                                          : q[a][b].w;
                r[a][b][0] = left;
                r[a][b][kRun + 1] = right;
            }
        }
}

// Any other rows: a load a column, at its clamped z.
template <int kMode>
__device__ __forceinline__ void load_rows_clamped(
    const PlaneSource<kMode>& src, int x, int y, int zr, int Y, int Z,
    float (&r)[3][3][kRun + 2]) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        const float* plane = src.base(x + a - 1);
#pragma unroll
        for (int b = 0; b < 3; ++b) {
            const float* row = plane + row_offset<kMode>(y + b - 1, Y, Z);
            const bool rims = a == 1 || b == 1;
#pragma unroll
            for (int c = 0; c < kRun + 2; ++c)
                r[a][b][c] = rims || (c > 0 && c <= kRun)
                    ? __ldg(row + min(max(zr - 1 + c, 0), Z - 1))
                    : 0.0f;
        }
    }
}

// One block: rows [blockIdx.y kTileY, +kTileY) of plane x = blockIdx.z,
// columns [blockIdx.x kTileZ, +kTileZ), each clipped to the core. kWide:
// Z % 4 == 0 and every pointer 16-byte aligned, so rows load and channels
// store in 16-byte pieces.
template <int kMode, int kOut, bool kWide>
__global__ void __launch_bounds__(kThreads)
hessian_eig_kernel(PlaneSource<kMode> src, float* __restrict__ out, int X,
                   int Y, int Z, StencilRecip k, float never) {
    const int y = blockIdx.y * kTileY + (threadIdx.x >> 5);
    const int zr = blockIdx.x * kTileZ + kRun * (threadIdx.x & 31);
    const int x = blockIdx.z;
    if (y >= Y) return;  // a whole warp
    float r[3][3][kRun + 2];
    if (kWide)
        load_rows_wide<kMode>(src, x, y, zr, Y, Z, r);
    else
        load_rows_clamped<kMode>(src, x, y, zr, Y, Z, r);
    if (zr >= Z) return;
    float o[6][kRun];
    run_outputs<kOut>(r, k, never, o);
    store_run<kWide>(out + ((long long)x * Y + y) * Z + zr,
                     (long long)X * Y * Z, zr, Z, o);
}

static bool aligned16(const void* p) {
    return p == nullptr || reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

template <int kMode, int kOut>
static void launch_hessian(const float* x, const float* lo, const float* hi,
                           float* out, long long X, long long Y, long long Z,
                           const StencilRecip& k, cudaStream_t stream) {
    const long long plane = kMode == kPrePadded ? (Y + 2) * Z : Y * Z;
    const bool wide = Z % 4 == 0 && aligned16(x) && aligned16(lo)
        && aligned16(hi) && aligned16(out);
    const dim3 grid((unsigned)((Z + kTileZ - 1) / kTileZ),
                    (unsigned)((Y + kTileY - 1) / kTileY), (unsigned)X);
    const PlaneSource<kMode> src{x, lo, hi, plane, (int)X};
    const float never = std::numeric_limits<float>::quiet_NaN();
    if (wide)
        hessian_eig_kernel<kMode, kOut, true><<<grid, kThreads, 0, stream>>>(
            src, out, (int)X, (int)Y, (int)Z, k, never);
    else
        hessian_eig_kernel<kMode, kOut, false><<<grid, kThreads, 0, stream>>>(
            src, out, (int)X, (int)Y, (int)Z, k, never);
}

// out: contiguous (6, X, Y, Z) float32 for the (X, Y, Z) core. mode 0: x is
// the contiguous core; mode 1 (x_halo): so, with lo and hi its (1, Y, Z)
// rows -1 and X; mode 2 (pre_padded): x is (X + 2, Y + 2, Z), the core and a
// one-voxel layer on x and y. lo, hi are read in mode 1 only. output: a
// HessianOutput; every output but kFeatures takes mode 0 alone.
extern "C" int ife_hessian_eig(const float* x, const float* lo, const float* hi,
                               float* out, long long X, long long Y,
                               long long Z, long long mode, long long output,
                               float r2x, float r2y, float r2z, float rxx,
                               float ryy, float rzz, cudaStream_t stream) {
    using Launch = void (*)(const float*, const float*, const float*, float*,
                            long long, long long, long long,
                            const StencilRecip&, cudaStream_t);
    // every output in the whole-volume mode, then the features in x_halo
    // and pre_padded
    static const Launch kWhole[] = {
        launch_hessian<kWholeVolume, kFeatures>,
        launch_hessian<kWholeVolume, kCopyFloor>,
        launch_hessian<kWholeVolume, kCopy6>,
        launch_hessian<kWholeVolume, kStencil6>,
        launch_hessian<kWholeVolume, kReference>};
    Launch fn = nullptr;
    if (mode == kWholeVolume && output >= kFeatures && output <= kReference)
        fn = kWhole[output];
    else if (mode == kXHalo && output == kFeatures && lo && hi)
        fn = launch_hessian<kXHalo, kFeatures>;
    else if (mode == kPrePadded && output == kFeatures)
        fn = launch_hessian<kPrePadded, kFeatures>;
    if (fn == nullptr) return (int)cudaErrorInvalidValue;
    fn(x, lo, hi, out, X, Y, Z, StencilRecip{r2x, r2y, r2z, rxx, ryy, rzz},
       stream);
    return (int)cudaGetLastError();
}

extern "C" const char* ife_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
