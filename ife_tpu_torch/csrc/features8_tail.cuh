// The shared features8 tail: at one voxel, from its edge-clamped 3x3x3
// neighbourhood, the gradient magnitude, the six Hessian terms with
// cascaded cross terms, and the six eigen features.
//
// ONE copy, included by every stencil kernel (hessian_eig.cu,
// features8_post.cu): in ife_tpu the round-5 true-face bug family came from
// copies of this chain drifting apart (ife_tpu/kernels/fused.py
// _emit_features8, docs/design.md "true-face clamp"). It is the CUDA
// counterpart of fused.py:_emit_features8 / _stream_kernel, with the
// eigen solve of ife_tpu/ops/eigen.py on the polynomial, no-diagonal path
// (use_trig=False, diag_path=False), in float32; beside it the reference's
// trig path with its diagonal branch (eigen_features_reference), which the
// Hessian kernel's reference output computes.
//
// Boundaries: the caller fills v[a][b][c] with s at the CLAMPED index
// (min(max(x+a-1, 0), X-1), ...) of the exact, unpadded volume, so at a true
// face the phantom neighbour is the field's own boundary value. Mixed
// central differences of clamped neighbourhoods equal the reference's
// cascade (Dx then Dy, Dx then Dz, Dy then Dz, each with its own clamp,
// Hessian3DImageFilter.hxx:31-59) exactly, and every expression keeps the
// plain PyTorch twin's association. The library is built with --fmad=false
// (kernels/_build.py), so each product and sum rounds as the twin's
// separate tensor ops do and the tail agrees with the twin to the bit.
#pragma once

struct StencilRecip {
    // 1/(2h) and 1/h^2 per axis, folded in f64 on the host and rounded once
    // to f32 (ife_tpu/kernels/fused.py:172-177, ops/stencil.py:80-87)
    float r2x, r2y, r2z, rxx, ryy, rzz;
};

// Where a one-thread-per-voxel stencil kernel finds the neighbours of a
// voxel of its (X, Y, Z) core (the shard modes of
// ife_tpu/kernels/fused.py:fused_hessian_eig_stream / _post_stream / _post):
//   kWholeVolume  s is the core; x and y clamp at its faces;
//   kXHalo        s is the core; row -1 is `lo` and row X is `hi`, each
//                 (1, Y, Z), a neighbouring shard's row or the replicated
//                 face row, so no extended block is built; y clamps;
//   kPrePadded    s is (X + 2, Y + 2, Z) and carries a one-voxel layer on
//                 x and y around the core: no x or y clamp at all.
// z always clamps: it is never sharded.
enum StencilMode { kWholeVolume = 0, kXHalo = 1, kPrePadded = 2 };

struct StencilSource {
    const float* s;
    const float* lo;  // kXHalo only
    const float* hi;
};

// the address of s at core position (x + dx, y + dy), dx, dy in {-1, 0, 1},
// column 0 of the row
template <int kMode>
__device__ __forceinline__ const float* stencil_row(
    const StencilSource& src, int X, int Y, int Z, int x, int y) {
    if (kMode == kPrePadded)
        return src.s + ((long long)(x + 1) * (Y + 2) + (y + 1)) * Z;
    const int yc = min(max(y, 0), Y - 1);
    if (kMode == kXHalo) {
        if (x < 0) return src.lo + (long long)yc * Z;
        if (x >= X) return src.hi + (long long)yc * Z;
        return src.s + ((long long)x * Y + yc) * Z;
    }
    return src.s + ((long long)min(max(x, 0), X - 1) * Y + yc) * Z;
}

// the neighbourhood of core voxel (x, y, z); the eight corners are never read
// by the tail and are left unset
template <int kMode>
__device__ __forceinline__ void load_neighbourhood_from(
    const StencilSource& src, int X, int Y, int Z, int x, int y, int z,
    float (&v)[3][3][3]) {
    const int zs[3] = {max(z - 1, 0), z, min(z + 1, Z - 1)};
    if (kMode == kWholeVolume) {
        // the three clamped indices per axis once, then plain offsets: 6%
        // faster at 512^3 than a row pointer per (a, b)
        const int xs[3] = {max(x - 1, 0), x, min(x + 1, X - 1)};
        const int ys[3] = {max(y - 1, 0), y, min(y + 1, Y - 1)};
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int b = 0; b < 3; ++b)
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    if (a != 1 && b != 1 && c != 1) continue;  // corner
                    v[a][b][c] = __ldg(
                        src.s + ((long long)xs[a] * Y + ys[b]) * Z + zs[c]);
                }
        return;
    }
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) {
            if (a != 1 && b != 1) {  // only the centre column is not a corner
                v[a][b][1] = __ldg(
                    stencil_row<kMode>(src, X, Y, Z, x + a - 1, y + b - 1) + zs[1]);
                continue;
            }
            const float* row =
                stencil_row<kMode>(src, X, Y, Z, x + a - 1, y + b - 1);
#pragma unroll
            for (int c = 0; c < 3; ++c) v[a][b][c] = __ldg(row + zs[c]);
        }
}

// cos(arccos(m)/3) on m in [0, 1]: degree-8 Chebyshev fit (Horner) plus one
// divide-free Newton polish on 4c^3 - 3c = m (ife_tpu/ops/eigen.py:67-121)
__device__ __forceinline__ float cos_third_arccos(float m) {
    float c = -0.0003058979258242973f;
    c = c * m + 0.0017713776825497704f;
    c = c * m + -0.004929524933662343f;
    c = c * m + 0.009372082506501525f;
    c = c * m + -0.015095279415175522f;
    c = c * m + 0.02459883847130328f;
    c = c * m + -0.04810327526051493f;
    c = c * m + 0.16666626771129278f;
    c = c * m + 0.8660254080410869f;
    const float y = c * c;
    const float g = 0.5951957727093505f
        + y * (-0.8371248718026527f + 0.353440250822755f * y);
    return c - ((4.0f * y - 3.0f) * c - m) * g;
}

// NaN-preserving clamp to [-1, 1] (fminf/fmaxf would turn NaN into a bound)
__device__ __forceinline__ float clip_unit(float r) {
    return r < -1.0f ? -1.0f : (r > 1.0f ? 1.0f : r);
}

// The part of the closed-form solve both eigen paths share
// (ife_tpu_torch/ops/eigen.py eigenvalues_from_channels, up to rc): p1 (the
// off-diagonal energy), q = tr/3, p2, p = sqrt(p2/6) and the clipped
// r = det(A - qI) / (2 p^3).
struct EigenSetup {
    float p1, q, p2, p, rc;
};

__device__ __forceinline__ EigenSetup eigen_setup(
    float a11, float a12, float a13, float a22, float a23, float a33) {
    EigenSetup e;
    e.p1 = a12 * a12 + a13 * a13 + a23 * a23;
    e.q = (a11 + a22 + a33) * (float)(1.0 / 3.0);
    const float d11 = a11 - e.q, d22 = a22 - e.q, d33 = a33 - e.q;
    e.p2 = d11 * d11 + d22 * d22 + d33 * d33 + 2.0f * e.p1;
    const float p2safe = (e.p2 > 0.0f ? e.p2 : 1.0f) * (float)(1.0 / 6.0);
    const float pinv = rsqrtf(p2safe);
    e.p = p2safe * pinv;  // sqrt(p2/6)
    const float det = d11 * (d22 * d33 - a23 * a23)
        + a12 * (a23 * a13 - a12 * d33)
        + a13 * (a12 * a23 - a13 * d22);
    e.rc = clip_unit(det * (pinv * pinv * pinv) * 0.5f);
    return e;
}

// g0 = q + 2p cos(phi), g2 = q + 2p cos(phi + 2pi/3), g1 by the trace
// identity, reordered to |t2| <= |t1| <= |t0| with the reference's two swaps
__device__ __forceinline__ void eigen_reorder(
    const EigenSetup& e, float cphi, float cphi2, float& t0, float& t1,
    float& t2) {
    const float g0 = e.q + 2.0f * e.p * cphi;
    const float g2 = e.q + 2.0f * e.p * cphi2;
    const float g1 = 3.0f * e.q - g0 - g2;  // trace identity
    const bool s1 = fabsf(g0) < fabsf(g2);
    t0 = s1 ? g2 : g0;
    t2 = s1 ? g0 : g2;
    const bool sw = fabsf(g1) < fabsf(t2);
    t1 = sw ? t2 : g1;
    t2 = sw ? g1 : t2;
}

// f = {e0, e1, e2, e0+e1+e2, e0*e1*e2, frobenius}
// (EigenvalueFeaturesFunctor.h:20-31)
__device__ __forceinline__ void eigen_feature_values(
    float e0, float e1, float e2, float (&f)[6]) {
    f[0] = e0;
    f[1] = e1;
    f[2] = e2;
    f[3] = e0 + e1 + e2;
    f[4] = e0 * e1 * e2;
    f[5] = sqrtf(e0 * e0 + e1 * e1 + e2 * e2);
}

// Eigen features of the symmetric matrix [a11 a12 a13; . a22 a23; . . a33]:
// f = {e1, e2, e3 (|e3| <= |e2| <= |e1|), e1+e2+e3, e1*e2*e3, frobenius}.
// ife_tpu/ops/eigen.py eigenvalue_feature_channels(use_trig=False,
// diag_path=False), line for line: the function of the Pallas kernels.
__device__ __forceinline__ void eigen_features(
    float a11, float a12, float a13, float a22, float a23, float a33,
    float (&f)[6]) {
    const EigenSetup e = eigen_setup(a11, a12, a13, a22, a23, a33);
    // arccos(r) = pi - arccos(|r|) for r < 0, by the angle-difference
    // identities; cos(phi + 2pi/3) = -c/2 - (sqrt3/2) s
    const float s32 = (float)0.8660254037844386;  // sqrt(3)/2
    const float cm = cos_third_arccos(fabsf(e.rc));
    const float sm = sqrtf(fmaxf(1.0f - cm * cm, 0.0f));
    const bool pos = e.rc >= 0.0f;
    const float cphi = pos ? cm : 0.5f * cm + s32 * sm;
    const float sphi = pos ? sm : s32 * cm - 0.5f * sm;
    const float cphi2 = -0.5f * cphi - s32 * sphi;
    float t0, t1, t2;
    eigen_reorder(e, cphi, cphi2, t0, t1, t2);
    // scalar-matrix guard: p2 == 0 means all eigenvalues are q
    const bool scalar = e.p2 == 0.0f;
    eigen_feature_values(scalar ? e.q : t0, scalar ? e.q : t1,
                         scalar ? e.q : t2, f);
}

// The same features on the reference's path: eigenvalue_feature_channels
// with its defaults (use_trig=True, diag_path=True), line for line — the
// function of ife_tpu.ops.features.hessian_eig_features on every platform.
// phi = acos(r)/3 and the two cosines by CUDA's acosf / cosf (written with
// explicit fmaf, so --fmad does not reach them), and where the matrix is
// diagonal (p1 == 0) its diagonal ordered by |.| with the reference's
// strict-'>' comparison tree (Symmetric3x3EigenvalueSolver.h:45-83;
// ops/eigen.py _ordered_by_abs_desc_diag).
__device__ __forceinline__ void eigen_features_reference(
    float a11, float a12, float a13, float a22, float a23, float a33,
    float (&f)[6]) {
    const EigenSetup e = eigen_setup(a11, a12, a13, a22, a23, a33);
    // pi rounded to f32, then the product, as the twin's pi * (2/3)
    const float third_turn = (float)3.141592653589793 * (float)(2.0 / 3.0);
    const float phi = acosf(e.rc) * (float)(1.0 / 3.0);
    const float cphi = cosf(phi);
    const float cphi2 = cosf(phi + third_turn);
    float t0, t1, t2;
    eigen_reorder(e, cphi, cphi2, t0, t1, t2);

    const bool c1 = fabsf(a11) > fabsf(a22);
    const bool c2 = fabsf(a11) > fabsf(a33);
    const bool c3 = fabsf(a22) > fabsf(a33);
    // the four branches of the tree: (a11, ...), (a33, a11, a22),
    // (a22, ...), (a33, a22, a11)
    const float d0 = c1 ? (c2 ? a11 : a33) : (c3 ? a22 : a33);
    const float d1 = c1 ? (c2 ? (c3 ? a22 : a33) : a11)
                        : (c3 ? (c2 ? a11 : a33) : a22);
    const float d2 = c1 ? (c2 ? (c3 ? a33 : a22) : a22)
                        : (c3 ? (c2 ? a33 : a11) : a11);
    const bool diag = e.p1 == 0.0f;
    eigen_feature_values(diag ? d0 : t0, diag ? d1 : t1, diag ? d2 : t2, f);
}

// The stencil of the tail: h = {Dxx, Dxy, Dxz, Dyy, Dyz, Dzz} (the packed
// order the eigen solve takes) and gm = |grad s|. Written once, here: the
// tail and the Hessian kernel's stencil6 probe both call it.
__device__ __forceinline__ void hessian_stencil(
    const float (&v)[3][3][3], const StencilRecip& k, float& gm,
    float (&h)[6]) {
    const float s0 = v[1][1][1];
    const float dxx = (v[2][1][1] - 2.0f * s0 + v[0][1][1]) * k.rxx;
    const float dyy = (v[1][2][1] - 2.0f * s0 + v[1][0][1]) * k.ryy;
    const float dzz = (v[1][1][2] - 2.0f * s0 + v[1][1][0]) * k.rzz;
    // cascaded cross terms: the first difference at the clamped neighbour
    // row, then the second difference of those
    const float dxy = ((v[2][2][1] - v[0][2][1]) * k.r2x
                       - (v[2][0][1] - v[0][0][1]) * k.r2x) * k.r2y;
    const float dxz = ((v[2][1][2] - v[0][1][2]) * k.r2x
                       - (v[2][1][0] - v[0][1][0]) * k.r2x) * k.r2z;
    const float dyz = ((v[1][2][2] - v[1][0][2]) * k.r2y
                       - (v[1][2][0] - v[1][0][0]) * k.r2y) * k.r2z;
    const float dx = (v[2][1][1] - v[0][1][1]) * k.r2x;
    const float dy = (v[1][2][1] - v[1][0][1]) * k.r2y;
    const float dz = (v[1][1][2] - v[1][1][0]) * k.r2z;
    gm = sqrtf(dx * dx + dy * dy + dz * dz);
    h[0] = dxx;
    h[1] = dxy;
    h[2] = dxz;
    h[3] = dyy;
    h[4] = dyz;
    h[5] = dzz;
}

// The tail: the stencil, then f = the six eigen features of h.
__device__ __forceinline__ void features8_tail(
    const float (&v)[3][3][3], const StencilRecip& k, float& gm,
    float (&h)[6], float (&f)[6]) {
    hessian_stencil(v, k, gm, h);
    eigen_features(h[0], h[1], h[2], h[3], h[4], h[5], f);
}

// launch shape of the one-thread-per-voxel stencil kernels: a warp spans 32
// consecutive z (coalesced loads and stores), a block 4 y rows, grid.z is x
constexpr int kStencilBlockZ = 32;
constexpr int kStencilBlockY = 4;

inline dim3 stencil_grid(long long X, long long Y, long long Z) {
    return dim3((unsigned)((Z + kStencilBlockZ - 1) / kStencilBlockZ),
                (unsigned)((Y + kStencilBlockY - 1) / kStencilBlockY),
                (unsigned)X);
}
