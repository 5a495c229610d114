// The int8 weight matvec for a batch of activation rows on the CUDA
// cores: pass 1 of the fused greedy head K4 (qmatvec.cu). The k-quant
// matvec (kquant.cuh) shares its constants.
//
// out[b, n] = sum_k x[b, k] * w[k, n] for the rows b of a block's row
// tile and its MV_COLS columns, f32 accumulation. Each weight byte is
// loaded once per row tile and multiplied into all of the tile's rows: a
// block stages its rows' inputs in shared memory in chunks of BMV_KC
// values (2048 for a single row; f32: exact in either compute dtype), and
// each thread keeps ROWS x 4 accumulators for its four columns. The tile
// height ROWS (1, 4, 8 or 16) is the smallest that holds the batch, so a
// small batch keeps few registers and many blocks per SM; batches above
// 16 rows tile over gridDim.y and read the weights once per 16 rows
// (twice at the entries' limit of 32).
#pragma once

#include <type_traits>

#include "common.cuh"

// Kernels of a header live in an unnamed namespace: every translation unit
// that includes it registers its own copies.
namespace wa {
namespace {

constexpr int BMV_ROWS = 16;    // the tallest row tile
constexpr int BMV_KC = 256;     // input values per row staged at a time
constexpr int BMV_MAX_B = 32;   // rows an entry takes (two row tiles)
constexpr int BMV_WARPS = MV_THREADS / 32;

template <int ROWS>
struct BmvShared {
    // staged inputs [k][row]; a tile of 4+ rows is padded so that the
    // float4 reads of four k-lanes of a warp fall in different banks. A
    // single row stages 2048 values at a time (8 KB, a whole D-long input
    // at every Whisper width), as the batch-1 matvec stages its whole input
    static constexpr int PITCH = ROWS < 4 ? ROWS : ROWS + 4;
    static constexpr int KC = ROWS == 1 ? 2048 : BMV_KC;
    alignas(16) float hs[KC][PITCH];
    float red[BMV_WARPS][ROWS][MV_COLS];    // per-warp column partials
    float out[ROWS][MV_COLS + 1];           // the block's sums
};

// Rows [r0, r0 + nb) of x [*, K], nb <= ROWS; fills s.out[r][c] for the
// block's columns. Ends with a barrier.
template <typename IT, int ROWS>
__device__ __forceinline__ void bmv_block(
        const IT* __restrict__ x, int K, int r0, int nb,
        const int8_t* __restrict__ w, int N, BmvShared<ROWS>& s) {
    const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
    const int cg = tid % MV_CGROUPS;
    const int kl = tid / MV_CGROUPS;
    const int n0 = blockIdx.x * MV_COLS + cg * 4;
    float acc[ROWS][4];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
        acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
    constexpr int KC = BmvShared<ROWS>::KC;
    for (int k0 = 0; k0 < K; k0 += KC) {
        const int kc = min(KC, K - k0);
        __syncthreads();          // the previous chunk is consumed
        auto stage = [&](int r, int k) {
            s.hs[k][r] = to_f32(x[(size_t)(r0 + r) * K + k0 + k]);
        };
        // Two loop shapes, each the faster on an H100 for its tiles: a
        // row tile stages in one flat loop over (row, k), so that its row
        // loads issue together; a single row walks its chunk only
        if constexpr (ROWS == 1) {
            for (int r = 0; r < nb; ++r)
                for (int k = tid; k < kc; k += MV_THREADS) stage(r, k);
        } else {
            for (int i = tid; i < nb * KC; i += MV_THREADS) {
                const int r = i / KC, k = i % KC;
                if (k < kc) stage(r, k);
            }
        }
        __syncthreads();
        const int8_t* wp = w + (size_t)k0 * N + n0;
#pragma unroll 4
        for (int k = kl; k < kc; k += MV_KLANES) {
            const char4 q = __ldg(
                reinterpret_cast<const char4*>(wp + (size_t)k * N));
            const float q0 = q.x, q1 = q.y, q2 = q.z, q3 = q.w;
            if constexpr (ROWS < 4) {
#pragma unroll
                for (int r = 0; r < ROWS; ++r) {
                    const float h = s.hs[k][r];
                    acc[r][0] += h * q0;
                    acc[r][1] += h * q1;
                    acc[r][2] += h * q2;
                    acc[r][3] += h * q3;
                }
            } else {
                // four rows per float4 read; rows >= nb of the last group
                // accumulate stale values that are never written out
#pragma unroll
                for (int g = 0; g < ROWS / 4; ++g) {
                    if (4 * g < nb) {
                        const float4 h = *reinterpret_cast<const float4*>(
                            &s.hs[k][4 * g]);
                        const float hv[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
                        for (int j = 0; j < 4; ++j) {
                            acc[4 * g + j][0] += hv[j] * q0;
                            acc[4 * g + j][1] += hv[j] * q1;
                            acc[4 * g + j][2] += hv[j] * q2;
                            acc[4 * g + j][3] += hv[j] * q3;
                        }
                    }
                }
            }
        }
    }
    // the 32 k-lanes of a column: 4 per warp (lanes 8 and 16 apart) by
    // shuffles, then the 8 warps through shared memory
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
        for (int g = 0; g < BMV_WARPS; ++g) v += s.red[g][r][c];
        s.out[r][c] = v;
    }
    __syncthreads();
}

// Calls f(std::integral_constant<int, ROWS>{}) with the row tile for B.
template <typename F>
cudaError_t with_row_tile(int B, F&& f) {
    if (B <= 1) return f(std::integral_constant<int, 1>{});
    if (B <= 4) return f(std::integral_constant<int, 4>{});
    if (B <= 8) return f(std::integral_constant<int, 8>{});
    return f(std::integral_constant<int, BMV_ROWS>{});
}

}  // namespace
}  // namespace wa
