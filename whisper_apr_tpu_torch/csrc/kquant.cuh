// The k-quant planar weight forms and K11's reader: a column matvec over
// the planar Q5_K and Q6_K weights, templated on the format, over row
// tiles of activations (kquant_matvec.cu). K10, the Q4_K matvec, runs on
// the tensor cores (kquant_matvec.cu); K12-K14 run on K1's, K2's and
// K3's kernels over these planar forms (decode_blocks.cu).
//
// Planar forms (ops/q4k.py, ops/kquants.py), per layer, input-major:
//   Q4_K: wq int8 [K/2, N], byte row r holds K value 2r in its low nibble
//         and 2r+1 in its high nibble (the raw byte viewed as signed: it is
//         zero-extended before the split), values 0..15; scale and zero
//         f32 [K/32, N]: x = q * S - Z per 32-group;
//   Q5_K: wq int8 [K, N] values 0..31; scale, zero f32 [K/32, N];
//   Q6_K: wq int8 [K, N] values -32..31; scale f32 [K/16, N], no zero.
// The scales are the effective per-group values (the super-block d/dmin
// already folded in): nothing here decodes an f16 super-block.
//
// K11: out[b, n] = sum_g S[g, n] * sum_{k in g} x[b, k] q[k, n]
//                  - Z[g, n] * sum_{k in g} x[b, k]
// with f32 accumulation, x staged in shared memory as f32. What bounds it:
// the weight bytes, 1.25 a weight for Q5_K (one byte plus 8 per 32) and
// for Q6_K (one plus 4 per 16); two flops a weight per row stay far under
// the card's flop/byte ratio.
//
// Design (the matvec tiling of common.cuh): a block owns MV_COLS columns, each
// thread four neighbouring columns (one 32-bit load of a weight row) and one
// of MV_KLANES k-lanes. A k-lane walks whole groups (32 value rows of Q5_K,
// 16 of Q6_K); it keeps the group's partial sums x.q in
// registers and applies S (and -Z times the group's sum of x) once at the
// group's end, so each scale and zero is read once per group. The group sums
// of x are computed once per block into shared memory. A row tile (1, 4 or 8
// rows, the smallest that holds the batch) is staged in chunks of KC values
// whose groups the k-lanes share, and every weight byte feeds every row of the
// tile.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace wa {
namespace {

enum KqFmt { KQ_Q4K = 0, KQ_Q5K = 1, KQ_Q6K = 2 };

template <int FMT> struct KqTraits;
template <> struct KqTraits<KQ_Q4K> {
    static constexpr int SUB = 32;       // K values per group
    static constexpr bool ZERO = true;   // asymmetric: a zero per group
};
template <> struct KqTraits<KQ_Q5K> {
    static constexpr int SUB = 32;
    static constexpr bool ZERO = true;
};
template <> struct KqTraits<KQ_Q6K> {
    static constexpr int SUB = 16;
    static constexpr bool ZERO = false;
};

constexpr int KQ_ROWS = 8;      // the tallest row tile
constexpr int KQ_MAX_B = 32;    // rows an entry takes (four row tiles)
constexpr int KQ_WARPS = MV_THREADS / 32;

// Staged row k sits at kidx(k): one pad row per 32 keeps the k-lanes of a
// warp (whole groups apart) in different banks.
__device__ __forceinline__ int kidx(int k) { return k + (k >> 5); }

template <int ROWS>
struct KqShared {
    static constexpr int PITCH = ROWS < 4 ? ROWS : ROWS + 4;
    static constexpr int KC = ROWS == 1 ? 2048 : (ROWS == 4 ? 1024 : 512);
    alignas(16) float hs[KC + KC / 32][PITCH];
    float gsum[KC / 16][ROWS];               // sums of h per group
    float red[KQ_WARPS][ROWS][MV_COLS];     // per-warp column partials
    float out[ROWS][MV_COLS + 1];            // the block's sums
};

__device__ __forceinline__ float4 ldg4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
}

// Rows [r0, r0 + nb) of x [*, K], nb <= ROWS, against the block's columns
// of one layer's planar Q5_K or Q6_K weight (wq, sc, zr at the layer);
// fills s.out[r][c]. K is a multiple of the group. Ends with a barrier.
template <int FMT, typename IT, int ROWS>
__device__ __forceinline__ void kq_block(
        const IT* __restrict__ x, int K, int r0, int nb,
        const int8_t* __restrict__ wq, const float* __restrict__ sc,
        const float* __restrict__ zr, int N, KqShared<ROWS>& s) {
    static_assert(FMT != KQ_Q4K, "K10 runs on the tensor cores");
    constexpr int SUB = KqTraits<FMT>::SUB;
    constexpr bool ZERO = KqTraits<FMT>::ZERO;
    constexpr int KC = KqShared<ROWS>::KC;
    const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
    const int cg = tid % MV_CGROUPS;
    const int kl = tid / MV_CGROUPS;
    const int n0 = blockIdx.x * MV_COLS + cg * 4;
    float acc[ROWS][4];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
        acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
    for (int k0 = 0; k0 < K; k0 += KC) {
        const int kc = min(KC, K - k0);
        const int ng = kc / SUB;
        __syncthreads();          // the previous chunk is consumed
        for (int i = tid; i < nb * kc; i += MV_THREADS) {
            const int r = i / kc, k = i % kc;
            s.hs[kidx(k)][r] = to_f32(x[(size_t)(r0 + r) * K + k0 + k]);
        }
        __syncthreads();
        if constexpr (ZERO) {
            for (int i = tid; i < nb * ng; i += MV_THREADS) {
                const int r = i / ng, g = i % ng;
                float t = 0.f;
#pragma unroll 8
                for (int j = 0; j < SUB; ++j) t += s.hs[kidx(g * SUB + j)][r];
                s.gsum[g][r] = t;
            }
            __syncthreads();
        }
        for (int g = kl; g < ng; g += MV_KLANES) {
            float ga[ROWS][4];
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
                ga[r][0] = ga[r][1] = ga[r][2] = ga[r][3] = 0.f;
            // the group's rows eight at a time, the next eight requested
            // while these multiply (carried across the loop, so that the
            // compiler keeps the loads in flight)
            const int8_t* wp = wq + (size_t)(k0 + g * SUB) * N + n0;
            uint32_t w[8];
#pragma unroll
            for (int u = 0; u < 8; ++u)
                w[u] = __ldg(reinterpret_cast<const uint32_t*>(
                    wp + (size_t)u * N));
#pragma unroll 1
            for (int i0 = 0; i0 < SUB; i0 += 8) {
                uint32_t wn[8];
#pragma unroll
                for (int u = 0; u < 8; ++u)
                    wn[u] = i0 + 8 < SUB
                        ? __ldg(reinterpret_cast<const uint32_t*>(
                              wp + (size_t)(i0 + 8 + u) * N))
                        : 0u;
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const char4 b = *reinterpret_cast<const char4*>(&w[i]);
                    const float q[4] = {(float)b.x, (float)b.y, (float)b.z,
                                        (float)b.w};
                    const int k = kidx(g * SUB + i0 + i);
#pragma unroll
                    for (int r = 0; r < ROWS; ++r) {
                        const float h = s.hs[k][r];
#pragma unroll
                        for (int j = 0; j < 4; ++j) ga[r][j] += h * q[j];
                    }
                }
#pragma unroll
                for (int u = 0; u < 8; ++u) w[u] = wn[u];
            }
            const size_t gi = (size_t)(k0 / SUB + g) * N + n0;
            const float4 S4 = ldg4(sc + gi);
            const float S[4] = {S4.x, S4.y, S4.z, S4.w};
            float Z[4] = {0.f, 0.f, 0.f, 0.f};
            if constexpr (ZERO) {
                const float4 Z4 = ldg4(zr + gi);
                Z[0] = Z4.x; Z[1] = Z4.y; Z[2] = Z4.z; Z[3] = Z4.w;
            }
#pragma unroll
            for (int r = 0; r < ROWS; ++r) {
                const float hsum = ZERO ? s.gsum[g][r] : 0.f;
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[r][j] += S[j] * ga[r][j] - Z[j] * hsum;
            }
        }
    }
    // the 32 k-lanes of a column: 4 per warp (lanes 8 and 16 apart) by
    // shuffles, then the 8 warps through shared memory; rows >= nb of a
    // tile hold stale inputs and are never written out
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        if (r < nb) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                float v = acc[r][j];
                v += __shfl_xor_sync(0xffffffffu, v, 8);
                v += __shfl_xor_sync(0xffffffffu, v, 16);
                if (lane < MV_CGROUPS) s.red[wid][r][cg * 4 + j] = v;
            }
        }
    }
    __syncthreads();
    for (int i = tid; i < nb * MV_COLS; i += MV_THREADS) {
        const int r = i / MV_COLS, c = i % MV_COLS;
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < KQ_WARPS; ++w) v += s.red[w][r][c];
        s.out[r][c] = v;
    }
    __syncthreads();
}

// out[b, n] = the k-quant matvec of x[b] rounded to OT, for x [B, K]
// (K11). Grid (N / MV_COLS, ceil(B / ROWS)).
template <int FMT, typename IT, typename OT, int ROWS>
__global__ void __launch_bounds__(MV_THREADS) kq_kernel(
        const IT* __restrict__ x, int B, int K, int N,
        const int8_t* __restrict__ wq, const float* __restrict__ sc,
        const float* __restrict__ zr, OT* __restrict__ out) {
    __shared__ KqShared<ROWS> s;
    const int r0 = blockIdx.y * ROWS;
    const int nb = min(ROWS, B - r0);
    kq_block<FMT, IT, ROWS>(x, K, r0, nb, wq, sc, zr, N, s);
    for (int i = threadIdx.x; i < nb * MV_COLS; i += MV_THREADS) {
        const int r = i / MV_COLS, c = i % MV_COLS;
        const int n = blockIdx.x * MV_COLS + c;
        out[(size_t)(r0 + r) * N + n] = from_f32<OT>(s.out[r][c]);
    }
}

// Calls f(std::integral_constant<int, ROWS>{}) with the row tile for B
template <typename F>
cudaError_t with_kq_row_tile(int B, F&& f) {
    if (B <= 1) return f(std::integral_constant<int, 1>{});
    if (B <= 4) return f(std::integral_constant<int, 4>{});
    return f(std::integral_constant<int, KQ_ROWS>{});
}

template <int FMT, typename IT, typename OT>
cudaError_t launch_kq(const void* x, int B, int K, int N, const int8_t* wq,
                      const float* sc, const float* zr, void* out,
                      cudaStream_t st) {
    return with_kq_row_tile(B, [&](auto rows) {
        constexpr int R = decltype(rows)::value;
        const dim3 grid(N / MV_COLS, (B + R - 1) / R);
        kq_kernel<FMT, IT, OT, R><<<grid, MV_THREADS, 0, st>>>(
            static_cast<const IT*>(x), B, K, N, wq, sc, zr,
            static_cast<OT*>(out));
        return cudaGetLastError();
    });
}

// Q4_K's bytes of one 32-bit word (four columns of a byte row) widened
// exactly at the FMA rate: lo[c] the low nibble of byte c (the even K
// value), hi[c] the high one, each set as the low byte of the f32 2^23 + q
// by a byte permute and 2^23 taken off by one subtraction
__device__ __forceinline__ void nibbles4(uint32_t w, float (&lo)[4],
                                         float (&hi)[4]) {
    const uint32_t l = w & 0x0F0F0F0Fu, h = (w >> 4) & 0x0F0F0F0Fu;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
        lo[b] = __uint_as_float(__byte_perm(l, 0x4B000000u, 0x7540 | b))
            - 8388608.f;
        hi[b] = __uint_as_float(__byte_perm(h, 0x4B000000u, 0x7540 | b))
            - 8388608.f;
    }
}

// Calls f(std::integral_constant<int, FMT>{}) for a format code; the
// format's shape rule: K a multiple of the group, N of MV_COLS.
template <typename F>
cudaError_t with_kq_fmt(int fmt, F&& f) {
    switch (fmt) {
        case KQ_Q4K: return f(std::integral_constant<int, KQ_Q4K>{});
        case KQ_Q5K: return f(std::integral_constant<int, KQ_Q5K>{});
        case KQ_Q6K: return f(std::integral_constant<int, KQ_Q6K>{});
        default: return (cudaError_t)ERR_DTYPE;
    }
}

inline bool kq_fmt_ok(int fmt) { return fmt >= KQ_Q4K && fmt <= KQ_Q6K; }

// One layer's k-quant weight: values, per-group scale and zero (null for
// Q6_K), at the layer.
struct KqW {
    const int8_t* q;
    const float* s;
    const float* z;
};

inline KqW kqw(const void* q, const void* s, const void* z) {
    return KqW{static_cast<const int8_t*>(q), static_cast<const float*>(s),
               static_cast<const float*>(z)};
}

// Q6_K has no zero, the others one per group
inline bool zeros_ok(int fmt, const void* z) {
    return (fmt == KQ_Q6K) == (z == nullptr);
}

inline bool kq_shape_ok(int fmt, int K, int N) {
    const int sub = fmt == KQ_Q6K ? 16 : 32;
    return kq_fmt_ok(fmt) && K > 0 && K % sub == 0 && N > 0
        && N % MV_COLS == 0;
}

}  // namespace
}  // namespace wa
