// The k-quant planar weight forms: their formats, shape rules and the
// readers that the kernels over them share. K10 and K11, the Q4_K and the
// Q5_K / Q6_K matvecs, are one tensor-core kernel (kquant_matvec.cu);
// K12-K14 run on K1's, K2's and K3's kernels over these planar forms
// (decode_blocks.cu).
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
