// The per-block decode kernel for one token at batch 1 over k-quant
// weights (Q4_K, Q5_K, Q6_K): K14 ffn_block_kq. (K12 self_block_kq and
// K13 cross_block_kq run on K2's head-cluster kernel, decode_blocks.cu.)
//
// Replaces the Pallas kernel of whisper_apr_tpu/ops/decode_blocks_kq.py
// (ffn_block_kq/_ffn_kernel_kq) and computes what it computes: K3
// (decode_blocks.cu) with the int8 matvecs replaced by the k-quant matvec
// of kquant.cuh, biases added in f32:
//
//   K14: LN3 -> fc1 + b1 -> exact GELU (erff), rounded to x's dtype ->
//        fc2, + b2 + residual in f32, cast once
//
// The LN output is rounded to x's dtype before the dot and before its
// group sums, as the TPU kernel rounds h before both.
//
// What bounds it on the card: the k-quant weight bytes of the sub-block,
// read once per call (large-v3, Q4_K: 9.8 MB fc1 + fc2; Q5_K/Q6_K 5/3 of
// that). Design: one launch per matvec, the columns spread over N/32
// blocks, fc1's blocks each recomputing the LayerNorm from the D-long
// input.
#include "kquant.cuh"

namespace wa {
namespace {

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
// [N] f32; g f32 [Hd] scratch for the GELU output.
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
