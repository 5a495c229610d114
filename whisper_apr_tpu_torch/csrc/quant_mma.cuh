// Shared pieces of the matmuls over quantized weights, K17 and K8
// (int8_matmul.cu) and K18 (dequant_matmul.cu): the scale of a column,
// the CUDA-core kernel for f32 x above 16 rows, the bf16 tensor-core
// product, x's pairs as B fragments of the decode-row kernels, and the
// weights' 16-byte vector loads.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace wa {
namespace {

constexpr int DM_BN = 64;
constexpr int DM_BK = 32;
constexpr int DM_THREADS = 256;

__device__ __forceinline__ float nibble(int8_t byte, int high) {
    const int u = ((int)(uint8_t)byte >> (high ? 4 : 0)) & 15;
    return (float)((u ^ 8) - 8);
}

__device__ __forceinline__ float col_scale(const float* scale, int n_scale,
                                           int gn) {
    return n_scale == 1 ? scale[0] : (gn < n_scale ? scale[gn] : 0.f);
}

// weight w[gk, gn] as a float (int8, or the nibble of a packed byte)
template <int WBITS>
__device__ __forceinline__ float weight(const int8_t* __restrict__ w, int wN,
                                        int gk, int gn) {
    if (WBITS == 8) return (float)w[(size_t)gk * wN + gn];
    return nibble(w[(size_t)gk * wN + gn / 2], gn & 1);
}

// --------------------------------------------------------------------------
// f32, M > 16: CUDA cores. WBITS 8: w [K, N] int8; 4: w [K, N / 2] bytes.
// --------------------------------------------------------------------------

template <typename XT, int WBITS>
__global__ void __launch_bounds__(DM_THREADS) dequant_mm_kernel(
        const XT* __restrict__ x, const int8_t* __restrict__ w,
        const float* __restrict__ scale, int n_scale, XT* __restrict__ y,
        int M, int K, int N) {
    constexpr int BM = 64, TM = BM / 16;
    __shared__ float xs[BM][DM_BK + 1];
    __shared__ float ws[DM_BK][DM_BN];
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * DM_BN;
    const int wN = WBITS == 8 ? N : N / 2;
    float acc[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += DM_BK) {
        for (int e = tid; e < BM * DM_BK; e += DM_THREADS) {
            const int r = e / DM_BK, c = e % DM_BK;
            const int gm = m0 + r, gk = k0 + c;
            xs[r][c] = gm < M && gk < K ? to_f32(x[(size_t)gm * K + gk]) : 0.f;
        }
        for (int e = tid; e < DM_BK * DM_BN; e += DM_THREADS) {
            const int r = e / DM_BN, c = e % DM_BN;
            const int gk = k0 + r, gn = n0 + c;
            ws[r][c] = gk < K && gn < N ? weight<WBITS>(w, wN, gk, gn) : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < DM_BK; ++kk) {
            float a[TM], bv[4];
#pragma unroll
            for (int i = 0; i < TM; ++i) a[i] = xs[ty * TM + i][kk];
#pragma unroll
            for (int j = 0; j < 4; ++j) bv[j] = ws[kk][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * bv[j];
        }
        __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int gn = n0 + tx + 16 * j;
        if (gn >= N) continue;
        const float s = col_scale(scale, n_scale, gn);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            const int gm = m0 + ty * TM + i;
            if (gm < M) y[(size_t)gm * N + gn] = from_f32<XT>(acc[i][j] * s);
        }
    }
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

}  // namespace
}  // namespace wa
