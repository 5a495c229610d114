// K4: the fused greedy vocab head for M rows. (K8, the stacked int8
// matvec, runs K17's decode-row kernel in int8_matmul.cu; K9, the scan
// step's fused FFN, K7's tensor-core kernel in ffn_batched.cu.)
//
// K4 replaces the Pallas kernel of whisper_apr_tpu/ops/qmatvec.py
// (qmatvec_greedy_head/_greedy_head_kernel) and computes what it computes,
// per row of x [M, K]: logits = x @ vocab_qT + bias over the lane-padded
// vocab, columns >= n_vocab masked to -inf, then (first index of the max,
// the max, logsumexp) with no logits row written. The logsumexp is
// m + log(max(z, 1e-30)); suppressed (-inf) and masked columns add 0.
//
// What bounds K4 on the card: the int8 vocab, read once per call for all
// M rows (whisper-tiny 384 x 51968 = 20 MB, large-v3 66.5 MB) — 2M flops
// a byte, under the card's flop/byte ratio for any M here. Design: the
// batched matvec of batched_matvec.cuh spreads the columns over N/32
// blocks and carries up to 16 rows per weight read.
// K4's pass 1 writes each block's (max, first argmax, sum of
// exp(logit - max)) per row into [M, N/32] partials; pass 2, one block per
// row, merges them in column order by strict ">", so ties keep the FIRST
// index of the row's maximum, as jnp.argmax does.
#include <limits.h>

#include "batched_matvec.cuh"

namespace wa {
namespace {

template <typename XT, int ROWS>
__global__ void __launch_bounds__(MV_THREADS) head_part_kernel(
        const XT* __restrict__ x, int M, int K,
        const int8_t* __restrict__ w, int N, const float* __restrict__ bias,
        int n_vocab, float* __restrict__ pm, float* __restrict__ pz,
        int* __restrict__ pi) {
    __shared__ BmvShared<ROWS> s;
    const int r0 = blockIdx.y * ROWS;
    const int nb = min(ROWS, M - r0);
    bmv_block<XT, ROWS>(x, K, r0, nb, w, N, s);
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const int n = blockIdx.x * MV_COLS + lane;      // MV_COLS == 32
    for (int r = wid; r < nb; r += BMV_WARPS) {     // one warp per row
        const float lg = n < n_vocab ? s.out[r][lane] + bias[n] : -INFINITY;
        const float m = warp_max(lg);
        const int idx = warp_min_int(lg == m ? n : INT_MAX);
        const float e = m == -INFINITY ? 0.f : expf(lg - m);
        const float z = warp_sum(e);
        if (lane == 0) {
            const size_t o = (size_t)(r0 + r) * gridDim.x + blockIdx.x;
            pm[o] = m;
            pz[o] = z;
            pi[o] = idx;
        }
    }
}

constexpr int FIN_THREADS = 1024;

// One block per row: merge the row's nb block partials.
__global__ void __launch_bounds__(FIN_THREADS) head_final_kernel(
        const float* __restrict__ pm, const float* __restrict__ pz,
        const int* __restrict__ pi, int nb, int* __restrict__ tok,
        float* __restrict__ mx, float* __restrict__ lse) {
    __shared__ float scratch[32];
    __shared__ int iscratch[32];
    const int row = blockIdx.x;
    pm += (size_t)row * nb;
    pz += (size_t)row * nb;
    pi += (size_t)row * nb;
    float m = -INFINITY;
    for (int b = threadIdx.x; b < nb; b += FIN_THREADS) m = fmaxf(m, pm[b]);
    const float M = block_max(m, scratch);
    float z = 0.f;
    int idx = INT_MAX;
    for (int b = threadIdx.x; b < nb; b += FIN_THREADS) {
        const float mb = pm[b];
        if (mb != -INFINITY) z += pz[b] * expf(mb - M);
        if (mb == M && pi[b] < idx) idx = pi[b];
    }
    const float Z = block_sum(z, scratch);
    idx = warp_min_int(idx);
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    if (lane == 0) iscratch[wid] = idx;
    __syncthreads();
    if (threadIdx.x == 0) {
        int best = INT_MAX;
        for (int i = 0; i < FIN_THREADS / 32; ++i) best = min(best, iscratch[i]);
        // every logit -inf: token 0, as the JAX kernel's initial index
        tok[row] = M == -INFINITY ? 0 : best;
        mx[row] = M;
        lse[row] = M + logf(fmaxf(Z, 1e-30f));
    }
}

template <typename XT>
cudaError_t greedy_head_t(const void* x, int M, int K, const int8_t* w,
                          int N, const float* bias, int n_vocab, float* pm,
                          float* pz, int* pi, int* tok, float* mx,
                          float* lse, cudaStream_t st) {
    const int nb = N / MV_COLS;
    cudaError_t e = with_row_tile(M, [&](auto rows) {
        constexpr int R = decltype(rows)::value;
        head_part_kernel<XT, R><<<dim3(nb, (M + R - 1) / R), MV_THREADS, 0,
                                  st>>>(static_cast<const XT*>(x), M, K, w, N,
                                        bias, n_vocab, pm, pz, pi);
        return cudaGetLastError();
    });
    if (e != cudaSuccess) return e;
    head_final_kernel<<<M, FIN_THREADS, 0, st>>>(pm, pz, pi, nb, tok, mx,
                                                 lse);
    return cudaGetLastError();
}

}  // namespace
}  // namespace wa

using namespace wa;

// x [M, K] (K-side scale already folded, compute dtype); w [K, N] int8;
// bias [N] f32; scratch pm/pz/pi [M, N / 32]; outputs [M] int32 and two
// [M] f32.
extern "C" int wa_greedy_head(const void* x, int x_dtype, int M, int K,
                              const void* w, int N, const void* bias,
                              int n_vocab, void* pm, void* pz, void* pi,
                              void* tok, void* mx, void* lse, void* stream) {
    if (N % MV_COLS != 0 || n_vocab > N || n_vocab < 1 || M < 1
            || M > BMV_MAX_B || K < 1)
        return ERR_SHAPE;
    auto st = static_cast<cudaStream_t>(stream);
#define WA_HEAD(XT)                                                          \
    greedy_head_t<XT>(x, M, K, (const int8_t*)w, N, (const float*)bias,      \
                      n_vocab, (float*)pm, (float*)pz, (int*)pi, (int*)tok,  \
                      (float*)mx, (float*)lse, st)
    if (x_dtype == F32) return (int)WA_HEAD(float);
    if (x_dtype == BF16) return (int)WA_HEAD(__nv_bfloat16);
#undef WA_HEAD
    return ERR_DTYPE;
}
