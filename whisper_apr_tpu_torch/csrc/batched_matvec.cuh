// The int8 weight matvec for a batch of activation rows, the building
// block of the batched decode kernels (K5-K7), K8, K9 and the fused head
// K4.
//
// out[b, n] = sum_k h[b, k] * w[k, n] for the rows b of a block's row
// tile and its MV_COLS columns, h = [LN](x) [rounded to bf16], f32
// accumulation. Each weight byte is loaded once per row tile and
// multiplied into all of the tile's rows: a block stages its rows'
// inputs in shared memory in chunks of BMV_KC values (2048 for a single
// row; f32: exact in either compute dtype), and each thread keeps
// ROWS x 4 accumulators for its four columns. The tile height ROWS (1,
// 4, 8 or 16) is the smallest that holds the batch, so a small batch
// keeps few registers and many blocks per SM; batches above 16 rows tile
// over gridDim.y and read the weights once per 16 rows (twice at the
// entries' limit of 32).
// LayerNorm statistics (f32, two passes, as the JAX kernels' _ln_rows)
// are computed per block, one warp per row.
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
    float mean[ROWS];
    float rstd[ROWS];
};

// Rows [r0, r0 + nb) of x [*, K], nb <= ROWS; fills s.out[r][c] for the
// block's columns. Ends with a barrier.
template <typename IT, int ROWS>
__device__ __forceinline__ void bmv_block(
        const IT* __restrict__ x, int K, int r0, int nb,
        const float* __restrict__ ln_w, const float* __restrict__ ln_b,
        int round_to_bf16, const int8_t* __restrict__ w, int N,
        BmvShared<ROWS>& s) {
    const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
    const int cg = tid % MV_CGROUPS;
    const int kl = tid / MV_CGROUPS;
    const int n0 = blockIdx.x * MV_COLS + cg * 4;
    if (ln_w != nullptr) {
        for (int r = wid; r < nb; r += BMV_WARPS) {
            const IT* xr = x + (size_t)(r0 + r) * K;
            float sum = 0.f;
            for (int i = lane; i < K; i += 32) sum += to_f32(xr[i]);
            const float mean = warp_sum(sum) / (float)K;
            float v = 0.f;
            for (int i = lane; i < K; i += 32) {
                const float d = to_f32(xr[i]) - mean;
                v += d * d;
            }
            const float var = warp_sum(v) / (float)K;
            if (lane == 0) {
                s.mean[r] = mean;
                s.rstd[r] = rsqrtf(var + LN_EPS);
            }
        }
    }
    float acc[ROWS][4];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
        acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
    constexpr int KC = BmvShared<ROWS>::KC;
    for (int k0 = 0; k0 < K; k0 += KC) {
        const int kc = min(KC, K - k0);
        __syncthreads();          // the previous chunk is consumed
        auto stage = [&](int r, int k) {
            float v = to_f32(x[(size_t)(r0 + r) * K + k0 + k]);
            if (ln_w != nullptr)
                v = (v - s.mean[r]) * s.rstd[r] * ln_w[k0 + k] + ln_b[k0 + k];
            if (round_to_bf16) v = round_bf16(v);
            s.hs[k][r] = v;
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

enum BmvEpi {
    BEPI_AFFINE = 0, BEPI_GELU = 1, BEPI_RESID = 2, BEPI_SCALE = 3,
    BEPI_RAW = 4
};

// out[b, n] = epilogue(sum_k h[b, k] * w[k, n]) for x [B, K], w [K, N]:
//   BEPI_AFFINE: acc * scale + bias                  (OT = float)
//   BEPI_GELU:   gelu(acc * scale + bias) [bf16-rounded] (OT = float)
//   BEPI_RESID:  acc * scale + bias + resid[b, n]    (OT = resid's type)
//   BEPI_SCALE:  acc * scale                         (K8)
//   BEPI_RAW:    acc, rounded to OT                  (K9's fc2)
// Grid (N / MV_COLS, ceil(B / ROWS)).
template <typename IT, typename OT, int EPI, int ROWS>
__global__ void __launch_bounds__(MV_THREADS) bmv_kernel(
        const IT* __restrict__ x, int B, int K, int N,
        const float* __restrict__ ln_w, const float* __restrict__ ln_b,
        int round_to_bf16, const int8_t* __restrict__ w,
        const float* __restrict__ scale, const float* __restrict__ bias,
        const OT* __restrict__ resid, OT* __restrict__ out) {
    __shared__ BmvShared<ROWS> s;
    const int r0 = blockIdx.y * ROWS;
    const int nb = min(ROWS, B - r0);
    bmv_block<IT, ROWS>(x, K, r0, nb, ln_w, ln_b, round_to_bf16, w, N, s);
    for (int i = threadIdx.x; i < nb * MV_COLS; i += MV_THREADS) {
        const int r = i / MV_COLS, c = i % MV_COLS;
        const int n = blockIdx.x * MV_COLS + c;
        const size_t o = (size_t)(r0 + r) * N + n;
        if constexpr (EPI == BEPI_RAW) {
            out[o] = from_f32<OT>(s.out[r][c]);
            continue;
        }
        const float y = s.out[r][c] * scale[n];
        if constexpr (EPI == BEPI_SCALE) {
            out[o] = from_f32<OT>(y);
        } else if constexpr (EPI == BEPI_AFFINE) {
            out[o] = y + bias[n];
        } else if constexpr (EPI == BEPI_GELU) {
            const float z = y + bias[n];
            float g = 0.5f * z * (1.0f + erff(z * 0.7071067811865475f));
            if (round_to_bf16) g = round_bf16(g);
            out[o] = g;
        } else {
            out[o] = from_f32<OT>(y + bias[n] + to_f32(resid[o]));
        }
    }
}

// Calls f(std::integral_constant<int, ROWS>{}) with the row tile for B.
template <typename F>
cudaError_t with_row_tile(int B, F&& f) {
    if (B <= 1) return f(std::integral_constant<int, 1>{});
    if (B <= 4) return f(std::integral_constant<int, 4>{});
    if (B <= 8) return f(std::integral_constant<int, 8>{});
    return f(std::integral_constant<int, BMV_ROWS>{});
}

template <typename IT, typename OT, int EPI>
cudaError_t launch_bmv(const void* x, int B, int K, int N, const float* ln_w,
                       const float* ln_b, int round_to_bf16, const int8_t* w,
                       const float* scale, const float* bias,
                       const void* resid, void* out, cudaStream_t st) {
    return with_row_tile(B, [&](auto rows) {
        constexpr int R = decltype(rows)::value;
        const dim3 grid(N / MV_COLS, (B + R - 1) / R);
        bmv_kernel<IT, OT, EPI, R><<<grid, MV_THREADS, 0, st>>>(
            static_cast<const IT*>(x), B, K, N, ln_w, ln_b, round_to_bf16,
            w, scale, bias, static_cast<const OT*>(resid),
            static_cast<OT*>(out));
        return cudaGetLastError();
    });
}

}  // namespace
}  // namespace wa
