// K10 q4k_matvec_stacked and K11 kq_matvec_stacked: y [M, N] = x [M, K]
// @ one layer of a planar k-quant weight stack.
//
// Replace the Pallas kernels of whisper_apr_tpu/ops/q4k.py
// (q4k_matvec_stacked/_q4k_kernel) and whisper_apr_tpu/ops/kquants.py
// (kq_matvec_stacked/_kq_kernel_asym, _kq_kernel_sym) and compute what they
// compute: per 32-group (16 for Q6_K) S * sum(x q) - Z * sum(x), with
// f32 accumulation, the group sums of x in f32 from x as given, and the
// output rounded to x's dtype. The TPU kernels expand x block-diagonally
// over the groups so that the partial dots become matrix-unit products,
// and optionally split Q4_K's nibbles algebraically to spare vector-unit
// work; here each k-lane walks whole groups on the CUDA cores and takes
// the exact low/high nibble form (kquant.cuh).
//
// What bounds them on the card: the weight bytes of one layer (0.75 a
// weight for Q4_K, 1.25 for Q5_K and Q6_K: large-v3's fc1 [1280, 5120] is
// 4.9 MB in Q4_K, 8.2 MB in Q5_K), read once per call for every row of a
// row tile; two flops a weight per row. Design: the reader of kquant.cuh
// over row tiles of 1, 4 or 8 rows (the smallest that holds M; M > 8 reads
// the weights once per 8 rows); the entry takes M <= 32 and the wrapper
// launches once per 32-row chunk.
#include "kquant.cuh"

using namespace wa;

// x [M, K] f32 or bf16; fmt KQ_Q4K (wq [K/2, N]), KQ_Q5K or KQ_Q6K
// (wq [K, N]); sc and zr [K/sub, N] f32 (zr null for Q6_K), all at the
// layer; out [M, N] in x's dtype.
extern "C" int wa_kq_matvec(const void* x, int x_dtype, int M, int K,
                            int fmt, const void* wq, int N, const void* sc,
                            const void* zr, void* out, void* stream) {
    if (!kq_shape_ok(fmt, K, N) || M < 1 || M > KQ_MAX_B) return ERR_SHAPE;
    if ((fmt == KQ_Q6K) != (zr == nullptr)) return ERR_DTYPE;
    auto st = static_cast<cudaStream_t>(stream);
    return (int)with_kq_fmt(fmt, [&](auto f) {
        constexpr int FMT = decltype(f)::value;
#define WA_KQMV(XT)                                                          \
        launch_kq<FMT, XT, XT, KEPI_OUT>(                                    \
            x, M, K, N, nullptr, nullptr, 0, (const int8_t*)wq,              \
            (const float*)sc, (const float*)zr, nullptr, nullptr, out, st)
        if (x_dtype == F32) return WA_KQMV(float);
        if (x_dtype == BF16) return WA_KQMV(__nv_bfloat16);
#undef WA_KQMV
        return (cudaError_t)ERR_DTYPE;
    });
}
