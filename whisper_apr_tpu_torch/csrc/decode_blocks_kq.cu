// Per-block decode kernels for one token at batch 1 over k-quant weights
// (Q4_K, Q5_K, Q6_K): K12 self_block_kq and K14 ffn_block_kq. (K13
// cross_block_kq runs on K2's head-cluster kernel, decode_blocks.cu.)
//
// Replace the Pallas kernels of whisper_apr_tpu/ops/decode_blocks_kq.py
// (self_block_kq/_self_kernel_kq, ffn_block_kq/_ffn_kernel_kq) and compute
// what they compute: K1 and K3 (decode_blocks.cu) with every int8 matvec
// replaced by the k-quant matvec of kquant.cuh, biases added in f32:
//
//   K12: LN1 -> QKV k-quant matvec + bqkv -> the new k/v row in the
//        cache's form -> attention over rows < pos plus the current row
//        -> o-proj k-quant + bias + residual
//   K14: LN3 -> fc1 + b1 -> exact GELU (erff), rounded to x's dtype ->
//        fc2, + b2 + residual in f32, cast once
//
// Every matvec input (the LN output, the attention output, the GELU
// output) is rounded to x's dtype before the dot and before its group
// sums, as the TPU kernels round h before both.
//
// What bounds them on the card: the k-quant weight bytes of the
// sub-block, read once per call (large-v3, Q4_K: 4.9 MB QKV + o-proj,
// 9.8 MB fc1 + fc2; Q5_K/Q6_K 5/3 of that) plus, for attention, every
// live cache row once. Design: one launch per matvec, the columns spread
// over N/32 blocks, each recomputing the LayerNorm from the D-long input;
// attention is attention.cuh unchanged, with its int8/fp8/bf16 self-row
// output.
#include "attention.cuh"
#include "kquant.cuh"

namespace wa {
namespace {

template <int FMT, typename XT>
cudaError_t self_block_kq_t(const void* x, int D, int H, const float* ln_w,
                            const float* ln_b, KqW wqkv, const float* bqkv,
                            const void* kq, const float* ks, const void* vq,
                            const float* vs, int cache_dtype, int T, int pos,
                            KqW wo, const float* bo, void* x_out,
                            void* k_row, float* k_scale, void* v_row,
                            float* v_scale, float* qkv, float* part,
                            float* attn, cudaStream_t st) {
    const int bf = sizeof(XT) == 2;
    cudaError_t e = launch_kq<FMT, XT, float, KEPI_AFFINE, 1>(
        x, 1, D, 3 * D, ln_w, ln_b, bf, wqkv.q, wqkv.s, wqkv.z, bqkv,
        nullptr, qkv, st);
    if (e != cudaSuccess) return e;
    AttnArgs a{};
    a.q = qkv;
    a.kc = kq; a.vc = vq; a.ks = ks; a.vs = vs;
    a.T = T; a.D = D; a.H = H;
    a.n_valid = pos; a.n_loop = pos;
    a.n_splits = n_att_splits(pos); a.part = part;
    a.kv_cur = qkv + D;
    a.k_row = k_row; a.v_row = v_row; a.k_scale = k_scale;
    a.v_scale = v_scale; a.attn_out = attn;
    e = attention(cache_dtype, a, st);
    if (e != cudaSuccess) return e;
    return launch_kq<FMT, float, XT, KEPI_RESID, 1>(
        attn, 1, D, D, nullptr, nullptr, bf, wo.q, wo.s, wo.z, bo, x, x_out,
        st);
}

template <int FMT, typename XT>
cudaError_t ffn_block_kq_t(const void* x, int D, int Hd, const float* ln_w,
                           const float* ln_b, KqW w1, const float* b1,
                           KqW w2, const float* b2, void* x_out, float* g,
                           cudaStream_t st) {
    const int bf = sizeof(XT) == 2;
    cudaError_t e = launch_kq<FMT, XT, float, KEPI_GELU, 1>(
        x, 1, D, Hd, ln_w, ln_b, bf, w1.q, w1.s, w1.z, b1, nullptr, g, st);
    if (e != cudaSuccess) return e;
    return launch_kq<FMT, float, XT, KEPI_RESID, 1>(
        g, 1, Hd, D, nullptr, nullptr, bf, w2.q, w2.s, w2.z, b2, x, x_out,
        st);
}

}  // namespace
}  // namespace wa

using namespace wa;

// Weights per layer: fmt KQ_Q4K ([K/2, N] nibble bytes) or KQ_Q5K /
// KQ_Q6K ([K, N] values) with [K/sub, N] f32 scales (and zeros); biases
// [N] f32. Caches and scratch as wa_self_block's (decode_blocks.cu).
extern "C" int wa_self_block_kq(
        const void* x, int x_dtype, int D, int H, int fmt, const void* ln_w,
        const void* ln_b, const void* wqkv, const void* sqkv,
        const void* zqkv, const void* bqkv, const void* kq, const void* ks,
        const void* vq, const void* vs, int cache_dtype, int T, int pos,
        const void* wo, const void* so, const void* zo, const void* bo,
        void* x_out, void* k_row, void* k_scale, void* v_row, void* v_scale,
        void* qkv, void* part, void* attn, void* stream) {
    if (!shape_ok(D, H) || !kq_shape_ok(fmt, D, 3 * D) || pos < 0
            || pos > T)
        return ERR_SHAPE;
    if ((cache_dtype == I8) != (ks != nullptr && vs != nullptr)
            || !zeros_ok(fmt, zqkv) || !zeros_ok(fmt, zo))
        return ERR_DTYPE;
    auto st = static_cast<cudaStream_t>(stream);
    return (int)with_kq_fmt(fmt, [&](auto f) {
        constexpr int FMT = decltype(f)::value;
#define WA_SELF(XT)                                                          \
        self_block_kq_t<FMT, XT>(                                            \
            x, D, H, (const float*)ln_w, (const float*)ln_b,                 \
            kqw(wqkv, sqkv, zqkv), (const float*)bqkv, kq, (const float*)ks, \
            vq, (const float*)vs, cache_dtype, T, pos, kqw(wo, so, zo),      \
            (const float*)bo, x_out, k_row, (float*)k_scale, v_row,          \
            (float*)v_scale, (float*)qkv, (float*)part, (float*)attn, st)
        if (x_dtype == F32) return WA_SELF(float);
        if (x_dtype == BF16) return WA_SELF(__nv_bfloat16);
#undef WA_SELF
        return (cudaError_t)ERR_DTYPE;
    });
}

extern "C" int wa_ffn_block_kq(
        const void* x, int x_dtype, int D, int Hd, int fmt, const void* ln_w,
        const void* ln_b, const void* w1, const void* s1, const void* z1,
        const void* b1, const void* w2, const void* s2, const void* z2,
        const void* b2, void* x_out, void* g, void* stream) {
    if (!kq_shape_ok(fmt, D, Hd) || !kq_shape_ok(fmt, Hd, D))
        return ERR_SHAPE;
    if (!zeros_ok(fmt, z1) || !zeros_ok(fmt, z2)) return ERR_DTYPE;
    auto st = static_cast<cudaStream_t>(stream);
    return (int)with_kq_fmt(fmt, [&](auto f) {
        constexpr int FMT = decltype(f)::value;
#define WA_FFN(XT)                                                           \
        ffn_block_kq_t<FMT, XT>(                                             \
            x, D, Hd, (const float*)ln_w, (const float*)ln_b,                \
            kqw(w1, s1, z1), (const float*)b1, kqw(w2, s2, z2),              \
            (const float*)b2, x_out, (float*)g, st)
        if (x_dtype == F32) return WA_FFN(float);
        if (x_dtype == BF16) return WA_FFN(__nv_bfloat16);
#undef WA_FFN
        return (cudaError_t)ERR_DTYPE;
    });
}
