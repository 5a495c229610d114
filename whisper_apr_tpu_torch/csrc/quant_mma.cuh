// Shared pieces of the tensor-core kernels over f32 and bf16 x: the
// matmuls over quantized weights, K17 and K8 (int8_matmul.cu) and K18
// (dequant_matmul.cu), and K16's f32 kernel (flash_attention.cu): the
// scale of a column, the bf16 tensor-core product, x's pairs as B
// fragments of the decode-row kernels, f32 as three bf16 terms, the
// weights' 16-byte vector loads, and x's side of the 128 x 128 tile
// kernels (int8_mma_kernel, int4_mma_kernel).
#pragma once

#include <type_traits>

#include "common.cuh"
#include "cp_async.cuh"

namespace wa {
namespace {

__device__ __forceinline__ float col_scale(const float* scale, int n_scale,
                                           int gn) {
    return n_scale == 1 ? scale[0] : (gn < n_scale ? scale[gn] : 0.f);
}

// c += a . b, m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 packed bytes of row k (32 columns from vector v), zero past the row
template <bool ALIGNED>
__device__ __forceinline__ uint4 load_vec(const uint8_t* __restrict__ w,
                                          int rowb, int k, int v) {
    const uint8_t* p = w + (size_t)k * rowb + 16 * v;
    if (ALIGNED) return __ldg(reinterpret_cast<const uint4*>(p));
    uint32_t r[4] = {0u, 0u, 0u, 0u};
    const int left = rowb - 16 * v;
#pragma unroll
    for (int b = 0; b < 16; ++b)
        if (b < left) r[b / 4] |= (uint32_t)__ldg(p + b) << (8 * (b % 4));
    return make_uint4(r[0], r[1], r[2], r[3]);
}

// x[m, k .. k + 1] as loaded: a bf16 pair (low half k) or two f32; 0
// past M or kend
template <typename XT>
using XPair = typename std::conditional<std::is_same<XT, float>::value,
                                        float2, uint32_t>::type;

template <typename XT>
__device__ __forceinline__ XPair<XT> x_pair(const XT* __restrict__ x, int M,
                                            int K, int kend, int m, int k) {
    const XT* p = x + (size_t)m * K + k;
    const bool in0 = m < M && k < kend, in1 = m < M && k + 1 < kend;
    const bool pair = in1 && (reinterpret_cast<uintptr_t>(p)
                              % (2 * sizeof(XT))) == 0;
    if constexpr (std::is_same<XT, float>::value) {
        if (pair) return __ldg(reinterpret_cast<const float2*>(p));
        return make_float2(in0 ? __ldg(p) : 0.f, in1 ? __ldg(p + 1) : 0.f);
    } else {
        const unsigned short* u = reinterpret_cast<const unsigned short*>(p);
        if (pair) return __ldg(reinterpret_cast<const unsigned int*>(u));
        return (in0 ? (uint32_t)__ldg(u) : 0u)
               | (in1 ? (uint32_t)__ldg(u + 1) << 16 : 0u);
    }
}

// a pair of x as B-fragment registers: bf16 as it is; f32 as three bf16
// pairs hi, mid, lo whose sum is x, each the bf16 rounding of what the
// terms before it left (exact: 3 x 8 bits cover f32's 24)
__device__ __forceinline__ void x_terms(uint32_t v, uint32_t (&b)[1]) {
    b[0] = v;
}

__device__ __forceinline__ void x_terms(float2 v, uint32_t (&b)[3]) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        const __nv_bfloat162 t = __floats2bfloat162_rn(v.x, v.y);
        b[i] = *reinterpret_cast<const uint32_t*>(&t);
        v.x -= __low2float(t);
        v.y -= __high2float(t);
    }
}

// the three terms of an f32 pair as element e of three fragments
template <int N>
__device__ __forceinline__ void terms_at(float2 v, uint32_t (&f)[3][N],
                                         int e) {
    uint32_t b[3];
    x_terms(v, b);
    f[0][e] = b[0];
    f[1][e] = b[1];
    f[2][e] = b[2];
}

// --------------------------------------------------------------------------
// x's side of the 128 x 128 tile kernels (K17 int8_mma_kernel, K18
// int4_mma_kernel): a 3-stage ring of x's 64-deep slices, 8 warps. bf16 x
// feeds the tensor cores as it is, by ldmatrix, a warp 64 x 32 outputs (4
// x 4 fragments); f32 x as its three bf16 terms, split from float2 loads
// as each A fragment is built, so every product with the exactly widened
// weights is exact and the sums are f32: a warp 32 x 64 outputs (2 x 8
// fragments, so each x value is split by two warps, not four), three
// products a fragment pair.
// --------------------------------------------------------------------------

constexpr int TM_BM = 128, TM_BN = 128, TM_BK = 64, TM_STAGES = 3;
constexpr int TM_THREADS = 256;
constexpr int TM_XLD = TM_BK + 8;       // x tile row: 144 bytes (bf16), 288
                                        // (f32): both free of conflicts
constexpr int TM_WLD = TM_BN + 8;       // widened tile row: 272 bytes

// TERMS bf16 terms an x value, warps of WM x WN outputs, BLOCKS blocks an
// SM (their shared memory: two of bf16 x's, one of f32 x's, which may
// then take up to 255 registers a thread)
template <typename XT>
struct TileX {                          // bf16
    static constexpr int TERMS = 1, WM = 64, WN = 32, BLOCKS = 2;
};
template <>
struct TileX<float> {
    static constexpr int TERMS = 3, WM = 32, WN = 64, BLOCKS = 1;
};

// whether x's rows can be staged by 16-byte copies
template <typename XT>
__host__ __forceinline__ bool tile_x_aligned(const void* x, int K) {
    return reinterpret_cast<uintptr_t>(x) % 16 == 0
           && K % (16 / (int)sizeof(XT)) == 0;
}

// stage the slice at k0 of x's tile: 16-byte cp.async copies (zero-filled
// past M and K), or, when rows are not 16-byte aligned, element loads
template <typename XT, bool ALIGNED>
__device__ __forceinline__ void tile_stage_x(XT (*xs)[TM_XLD],
                                             const XT* __restrict__ x, int M,
                                             int K, int m0, int k0, int tid) {
    constexpr int V = 16 / sizeof(XT);      // elements a copy
    if (ALIGNED) {
#pragma unroll
        for (int e = tid; e < TM_BM * (TM_BK / V); e += TM_THREADS) {
            const int r = e / (TM_BK / V), c = V * (e % (TM_BK / V));
            const bool ok = m0 + r < M && k0 + c < K;
            cp_async16(&xs[r][c], ok ? x + (size_t)(m0 + r) * K + k0 + c : x,
                       ok ? 16 : 0);
        }
        return;
    }
    for (int e = tid; e < TM_BM * TM_BK; e += TM_THREADS) {
        const int r = e / TM_BK, c = e % TM_BK;
        xs[r][c] = m0 + r < M && k0 + c < K ? x[(size_t)(m0 + r) * K + k0 + c]
                                            : from_f32<XT>(0.f);
    }
}

// the A fragments of x's rows r0 .. r0 + 15, k 16 kc .. 16 kc + 15: bf16
// by one ldmatrix.x4; f32 as three terms from four float2 loads (a0 row
// g, k 2t; a1 row g + 8; a2, a3 at k + 8)
__device__ __forceinline__ void tile_a(uint32_t (&a)[1][4],
                                       const __nv_bfloat16 (*xs)[TM_XLD],
                                       int r0, int kc, int lane) {
    ldmatrix_x4(a[0], &xs[r0 + (lane & 15)][16 * kc + 8 * (lane >> 4)]);
}

__device__ __forceinline__ void tile_a(uint32_t (&a)[3][4],
                                       const float (*xs)[TM_XLD], int r0,
                                       int kc, int lane) {
    const float* p = &xs[r0 + (lane >> 2)][16 * kc + 2 * (lane & 3)];
#pragma unroll
    for (int e = 0; e < 4; ++e)
        terms_at(*reinterpret_cast<const float2*>(
                     p + 8 * (e & 1) * TM_XLD + 8 * (e >> 1)), a, e);
}

// one 16-deep step of a warp's outputs: B from the widened [k][n] tile
// (ldmatrix.x4.trans, two 8-column fragments each), A per 16-row tile,
// every term of A against each B fragment. f32's three products (lo
// first) go into a sum of their own that acc takes with one f32 add: the
// tensor cores truncate what an mma's addends hold below 24 bits of the
// largest, so each product summed into acc could lose an ulp of acc, all
// the same way, where this loses one of the step's sum.
template <typename XT, int I, int J>
__device__ __forceinline__ void tile_step(
        float (&acc)[I][J][4], const XT (*xs)[TM_XLD],
        const __nv_bfloat16 (*wt)[TM_WLD], int wm, int wn, int kc,
        int lane) {
    constexpr int TERMS = TileX<XT>::TERMS;
    uint32_t b[J][2];
#pragma unroll
    for (int jj = 0; jj < J / 2; ++jj) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &wt[16 * kc + (lane & 15)]
                                [wn + 16 * jj + 8 * (lane >> 4)]);
        b[2 * jj][0] = r[0]; b[2 * jj][1] = r[1];
        b[2 * jj + 1][0] = r[2]; b[2 * jj + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < I; ++i) {
        uint32_t a[TERMS][4];
        tile_a(a, xs, wm + 16 * i, kc, lane);
#pragma unroll
        for (int j = 0; j < J; ++j) {
            if constexpr (TERMS == 1) {
                mma_bf16(acc[i][j], a[0], b[j][0], b[j][1]);
            } else {
                float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
                for (int tm = TERMS - 1; tm >= 0; --tm)
                    mma_bf16(d, a[tm], b[j][0], b[j][1]);
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[i][j][e] += d[e];
            }
        }
    }
}

// y[i], y[i + 1] (both when `two`) from f32 sums, in y's dtype
__device__ __forceinline__ void store2(float* y, float v0, float v1,
                                       bool pair, bool two) {
    if (pair) {
        *reinterpret_cast<float2*>(y) = make_float2(v0, v1);
    } else {
        y[0] = v0;
        if (two) y[1] = v1;
    }
}

__device__ __forceinline__ void store2(__nv_bfloat16* y, float v0, float v1,
                                       bool pair, bool two) {
    if (pair) {
        *reinterpret_cast<__nv_bfloat162*>(y) = __floats2bfloat162_rn(v0, v1);
    } else {
        y[0] = __float2bfloat16_rn(v0);
        if (two) y[1] = __float2bfloat16_rn(v1);
    }
}

// the tile's epilogue: acc * the column's scale (col_scale), stored in
// y's dtype, paired where N is even and y's rows keep the pair aligned
template <typename XT, int I, int J>
__device__ __forceinline__ void tile_store(
        const float (&acc)[I][J][4], const float* __restrict__ scale,
        int n_scale, XT* __restrict__ y, int M, int N, int m0, int n0,
        int lane) {
    const int g = lane >> 2, t = lane & 3;
    const bool pairs = N % 2 == 0
        && reinterpret_cast<uintptr_t>(y) % (2 * sizeof(XT)) == 0;
#pragma unroll
    for (int j = 0; j < J; ++j) {
        const int gn = n0 + 8 * j + 2 * t;
        if (gn >= N) continue;
        const bool two = gn + 1 < N;
        const float s0 = col_scale(scale, n_scale, gn);
        const float s1 = two ? col_scale(scale, n_scale, gn + 1) : 0.f;
#pragma unroll
        for (int i = 0; i < I; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int gm = m0 + 16 * i + g + 8 * h;
                if (gm < M)
                    store2(y + (size_t)gm * N + gn, acc[i][j][2 * h] * s0,
                           acc[i][j][2 * h + 1] * s1, pairs, two);
            }
    }
}

}  // namespace
}  // namespace wa
