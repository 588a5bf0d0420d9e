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
// multiplies. The loop has PyTorch's launch shape for elementwise kernels:
// 128-thread blocks, a grid that covers the volume once, 32-bit indices,
// four accesses a thread with every load issued before any store. Timed
// on the device yardstick in turns with torch.mul (PERF.md), it
// reaches the library's copy rate (0.358 against 0.356 ms for pcopy1 at
// 512^3); the grid-stride loop over a full SM of threads it replaced took
// 0.376, and streaming cache hints (__ldcs / __stcs) gained nothing.
// Each output has its own pointer, so every output of a torch allocation is
// 16-byte aligned and float4 takes any element count. The constants come in
// as f32, rounded once on the host.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

constexpr int kProbeThreads = 128;
constexpr int kProbeUnroll = 4;
constexpr int kProbeMaxOut = 6;
// the largest n the 32-bit indices take (kernels/probes.py _MAX_N)
constexpr long long kProbeMaxN = 0x7fff0000LL;

struct ProbeOuts {
    float* p[kProbeMaxOut];
    float c[kProbeMaxOut];
};

__device__ __forceinline__ float4 scale4(float4 v, float c) {
    return make_float4(v.x * c, v.y * c, v.z * c, v.w * c);
}

// units of kWidth floats, kProbeUnroll units a thread at a stride of one
// block, so each access of a warp is coalesced
template <int kOut, int kWidth>
__global__ void __launch_bounds__(kProbeThreads)
scaled_copies_kernel(const float* __restrict__ x, ProbeOuts o, int n) {
    using V = typename std::conditional<kWidth == 4, float4, float>::type;
    const int units = kWidth == 4 ? n / 4 : n;
    const int u0 = blockIdx.x * (kProbeThreads * kProbeUnroll) + threadIdx.x;
    const V* xv = reinterpret_cast<const V*>(x);
    V v[kProbeUnroll];
#pragma unroll
    for (int u = 0; u < kProbeUnroll; ++u) {
        const int i = u0 + u * kProbeThreads;
        if (i < units) v[u] = __ldg(xv + i);
    }
#pragma unroll
    for (int u = 0; u < kProbeUnroll; ++u) {
        const int i = u0 + u * kProbeThreads;
        if (i >= units) continue;
#pragma unroll
        for (int k = 0; k < kOut; ++k) {
            if constexpr (kWidth == 4)
                reinterpret_cast<float4*>(o.p[k])[i] = scale4(v[u], o.c[k]);
            else
                o.p[k][i] = v[u] * o.c[k];
        }
    }
    // the floats past the last whole float4, in the last block
    if (kWidth == 4 && blockIdx.x == gridDim.x - 1) {
        const int i = 4 * units + threadIdx.x;
        if (i < n) {
            const float f = x[i];
#pragma unroll
            for (int k = 0; k < kOut; ++k) o.p[k][i] = f * o.c[k];
        }
    }
}

template <int kOut>
static int launch_scaled_copies(const float* x, const ProbeOuts& o,
                                long long n, long long width,
                                cudaStream_t stream) {
    if (n < 1 || n > kProbeMaxN || (width != 1 && width != 4))
        return (int)cudaErrorInvalidValue;
    if (width == 4) {
        uintptr_t bits = reinterpret_cast<uintptr_t>(x);
        for (int k = 0; k < kOut; ++k)
            bits |= reinterpret_cast<uintptr_t>(o.p[k]);
        if (bits % 16 != 0) return (int)cudaErrorMisalignedAddress;
    }
    const long long units = width == 4 ? n / 4 : n;
    const long long per_block = (long long)kProbeThreads * kProbeUnroll;
    const long long blocks = units > 0 ? (units + per_block - 1) / per_block : 1;
    if (width == 4)
        scaled_copies_kernel<kOut, 4>
            <<<(unsigned)blocks, kProbeThreads, 0, stream>>>(x, o, (int)n);
    else
        scaled_copies_kernel<kOut, 1>
            <<<(unsigned)blocks, kProbeThreads, 0, stream>>>(x, o, (int)n);
    return (int)cudaGetLastError();
}

// x, out: n (< 2^31 - 2^16) contiguous float32; width: 1 (a float a
// thread) or 4 (float4, x and out 16-byte aligned); c: the constant,
// rounded to f32 by the caller.
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
