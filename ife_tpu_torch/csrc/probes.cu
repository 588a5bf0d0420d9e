// The streaming probes: one read, kOut scaled copies, any shape.
//
// ife_pcopy1 replaces benchmarks/probe11.py:84 pcopy1 (out = x * 1.000001)
// and ife_trivial6 replaces benchmarks/probe10.py:56 and probe11.py:63
// trivial6 (six outputs x * (1 + 1e-6 k), one function at two call sites).
// On the TPU they measured the copy ceiling of the Hessian kernel's traffic
// pattern (one read, one or six writes) through blocked Pallas specs; their
// block-shape and grid-semantics modes were Mosaic knobs with the same
// outputs. On the card the question those modes asked, which access pattern
// reaches the ceiling, is asked by the access width: one float a thread, as
// the Hessian kernel loads and stores, or float4 with a scalar tail.
//
// What bounds them on the H100: bytes, 4 (1 + kOut) B a voxel against kOut
// multiplies. The design is a grid-stride loop of coalesced accesses, a
// full SM of threads, nothing else (more loads in flight a thread, 2 or 4,
// measured no faster on the H100).
// Each output has its own pointer, so every output of a torch allocation is
// 16-byte aligned and float4 takes any element count. The constants come in
// as f32, rounded once on the host.
#include <cuda_runtime.h>

#include <cstdint>

constexpr int kProbeThreads = 256;
constexpr int kProbeMaxOut = 6;
constexpr int kProbeBlocksPerSm = 8;

struct ProbeOuts {
    float* p[kProbeMaxOut];
    float c[kProbeMaxOut];
};

template <int kOut, int kWidth>
__global__ void __launch_bounds__(kProbeThreads)
scaled_copies_kernel(const float* __restrict__ x, ProbeOuts o, long long n) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    long long tail = 0;  // the floats past the last whole float4
    if (kWidth == 4) {
        const long long n4 = n / 4;
        const float4* x4 = reinterpret_cast<const float4*>(x);
        for (long long i = t0; i < n4; i += stride) {
            const float4 v = __ldg(x4 + i);
#pragma unroll
            for (int k = 0; k < kOut; ++k) {
                const float c = o.c[k];
                reinterpret_cast<float4*>(o.p[k])[i] =
                    make_float4(v.x * c, v.y * c, v.z * c, v.w * c);
            }
        }
        tail = 4 * n4;
    }
    for (long long i = tail + t0; i < n; i += stride) {
        const float v = __ldg(x + i);
#pragma unroll
        for (int k = 0; k < kOut; ++k) o.p[k][i] = v * o.c[k];
    }
}

template <int kOut>
static int launch_scaled_copies(const float* x, const ProbeOuts& o,
                                long long n, long long width,
                                cudaStream_t stream) {
    if (n < 1 || (width != 1 && width != 4)) return (int)cudaErrorInvalidValue;
    if (width == 4) {
        uintptr_t bits = reinterpret_cast<uintptr_t>(x);
        for (int k = 0; k < kOut; ++k)
            bits |= reinterpret_cast<uintptr_t>(o.p[k]);
        if (bits % 16 != 0) return (int)cudaErrorMisalignedAddress;
    }
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    const long long units = width == 4 ? (n + 3) / 4 : n;
    const long long blocks = (units + kProbeThreads - 1) / kProbeThreads;
    const long long cap = (long long)sms * kProbeBlocksPerSm;
    const unsigned grid = (unsigned)(blocks < cap ? blocks : cap);
    if (width == 4)
        scaled_copies_kernel<kOut, 4>
            <<<grid, kProbeThreads, 0, stream>>>(x, o, n);
    else
        scaled_copies_kernel<kOut, 1>
            <<<grid, kProbeThreads, 0, stream>>>(x, o, n);
    return (int)cudaGetLastError();
}

// x, out: n contiguous float32; width: 1 (a float a thread) or 4 (float4,
// x and out 16-byte aligned); c: the constant, rounded to f32 by the caller.
extern "C" int ife_pcopy1(const float* x, float* out, long long n,
                          long long width, float c, cudaStream_t stream) {
    ProbeOuts o{};
    o.p[0] = out;
    o.c[0] = c;
    return launch_scaled_copies<1>(x, o, n, width, stream);
}

// six outputs of n floats each, out_k = x * c_k
extern "C" int ife_trivial6(const float* x, float* o0, float* o1, float* o2,
                            float* o3, float* o4, float* o5, long long n,
                            long long width, float c0, float c1, float c2,
                            float c3, float c4, float c5, cudaStream_t stream) {
    const ProbeOuts o{{o0, o1, o2, o3, o4, o5}, {c0, c1, c2, c3, c4, c5}};
    return launch_scaled_copies<6>(x, o, n, width, stream);
}
