// K17 and K18: matmuls over int8 and packed-int4 weights.
//
// K17 replaces the Pallas kernel of whisper_apr_tpu/ops/int8_matmul.py
// (_int8_matmul_kernel / int8_matmul, pallas_call at :72), K18 the one of
// whisper_apr_tpu/ops/int4_matmul.py (_int4_matmul_kernel / int4_matmul,
// pallas_call at :115). Both compute
//
//   y[m, n] = (sum_k x[m, k] * w[k, n]) * scale[n]     (f32 sum)
//
// cast to x's dtype, with w[k, n] the int8 weight (K17) or, for K18, the
// nibble of byte wq[k, n / 2] (low nibble for even n, high for odd),
// ((v & 15) ^ 8) - 8. The scale is one value for every column (n_scale
// == 1) or one per column; columns past n_scale take 0 (an odd int4
// width's last, padded column, which the caller cuts). The weights are
// converted inside the tile loop, so device memory sees only their int8
// or packed bytes.
//
// Bound: at the encoder's 1500 rows the operations (2 M N K), at a few
// decode rows the weight bytes. Three kernels, by the rows and the type:
//
// - M <= 16 (a serving tick's slots, a short prompt): dequant_mv_kernel,
//   bytes-bound, on the CUDA cores. A block owns 64 columns and a range
//   of K, its 256 threads 16 groups of 4 neighbouring columns by 16
//   K-lanes; x is staged in 256-deep slices in shared memory, each thread
//   keeps the M x 4 sums of its lane in registers (its 4 weights one
//   4-byte or 2-byte load), and the K-lanes are summed in shared memory
//   at the end. A warp reads two weight rows of 64 bytes. K is split over enough blocks to give the card two a
//   multiprocessor; the splits write f32 partials that a second pass
//   (dequant_mv_reduce) sums in split order, so the result does not
//   depend on the order blocks run in.
// - bf16 and M > 16 (the encoder, the cross K/V, the prefill):
//   dequant_mma_kernel on the tensor cores, mma.sync m16n8k16 with f32
//   sums (integers of at most 8 bits are exact in bf16, and so are
//   their products with bf16 values in f32: the JAX kernel's
//   arithmetic). A block owns a 64 x 64 output tile, each of its four
//   warps 32 x 32; 32-deep slices of x and of the converted weights
//   (stored N-major) sit in shared memory with a 40-element row stride,
//   so each fragment load of a warp touches 32 banks.
// - f32 and M > 16: dequant_mm_kernel on the CUDA cores in f32 (tensor
//   cores would round f32 to TF32): a 64 x 64 tile, 256 threads of 4
//   rows by 4 columns (16 apart: neighbouring threads read neighbouring
//   banks), 32-deep slices of x and of the converted weights in shared
//   memory.
//
// Ragged M, N and K edges are masked, so every shape is taken.
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

// --------------------------------------------------------------------------
// M <= 16: bytes-bound rows
// --------------------------------------------------------------------------

constexpr int MV_ROWS = 16;
constexpr int MV_KC = 256;             // x slice staged per pass
constexpr int MV_LANES = 16;           // K-lanes; 16 column groups of 4

// w[gk, c0 .. c0 + 3] (c0 a multiple of 4) with one 4-byte (int8) or
// 2-byte (packed int4) load where the row allows it; columns past N are 0
template <int WBITS>
__device__ __forceinline__ void weights4(const int8_t* __restrict__ w, int wN,
                                         int N, int gk, int c0,
                                         float (&wv)[4]) {
    const size_t at = (size_t)gk * wN + (WBITS == 8 ? c0 : c0 / 2);
    if (c0 + 3 < N
            && reinterpret_cast<uintptr_t>(w + at) % (WBITS == 8 ? 4 : 2) == 0) {
        if (WBITS == 8) {
            const char4 q = *reinterpret_cast<const char4*>(w + at);
            wv[0] = q.x; wv[1] = q.y; wv[2] = q.z; wv[3] = q.w;
        } else {
            const char2 q = *reinterpret_cast<const char2*>(w + at);
            wv[0] = nibble(q.x, 0); wv[1] = nibble(q.x, 1);
            wv[2] = nibble(q.y, 0); wv[3] = nibble(q.y, 1);
        }
        return;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
        wv[j] = c0 + j < N ? weight<WBITS>(w, wN, gk, c0 + j) : 0.f;
}

constexpr int N_SMS = 132;             // H100 SXM multiprocessors
constexpr int MV_UNIT = 32;            // K rows: the split granularity

// grid (column blocks, splits); split s takes K rows [s * k_split, ...);
// with one split it writes y, else its partial sums to part [splits, M, N]
template <typename XT, int WBITS>
__global__ void __launch_bounds__(DM_THREADS) dequant_mv_kernel(
        const XT* __restrict__ x, const int8_t* __restrict__ w,
        const float* __restrict__ scale, int n_scale, XT* __restrict__ y,
        float* __restrict__ part, int M, int K, int N, int k_split) {
    __shared__ float xs[MV_ROWS][MV_KC];
    __shared__ float red[MV_LANES][DM_BN + 1];
    const int tid = threadIdx.x, cg = tid % 16, kl = tid / 16;
    const int n0 = blockIdx.x * DM_BN, c0 = n0 + cg * 4;
    const int wN = WBITS == 8 ? N : N / 2;
    float acc[MV_ROWS][4];
#pragma unroll
    for (int m = 0; m < MV_ROWS; ++m)
        acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;
    const int k_end = min(K, (int)(blockIdx.y + 1) * k_split);
    for (int k0 = blockIdx.y * k_split; k0 < k_end; k0 += MV_KC) {
        __syncthreads();
        for (int e = tid; e < M * MV_KC; e += DM_THREADS) {
            const int m = e / MV_KC, c = e % MV_KC;
            xs[m][c] = k0 + c < K ? to_f32(x[(size_t)m * K + k0 + c]) : 0.f;
        }
        __syncthreads();
        const int kend = min(MV_KC, k_end - k0);
#pragma unroll 4
        for (int kk = kl; kk < kend; kk += MV_LANES) {
            float wv[4];
            weights4<WBITS>(w, wN, N, k0 + kk, c0, wv);
#pragma unroll
            for (int m = 0; m < MV_ROWS; ++m) {
                if (m < M) {
                    const float a = xs[m][kk];
#pragma unroll
                    for (int j = 0; j < 4; ++j) acc[m][j] += a * wv[j];
                }
            }
        }
    }
#pragma unroll
    for (int m = 0; m < MV_ROWS; ++m) {
        if (m < M) {                    // the same for the whole block
            __syncthreads();
#pragma unroll
            for (int j = 0; j < 4; ++j) red[kl][cg * 4 + j] = acc[m][j];
            __syncthreads();
            if (tid < DM_BN && n0 + tid < N) {
                float sum = 0.f;
#pragma unroll
                for (int l = 0; l < MV_LANES; ++l) sum += red[l][tid];
                if (gridDim.y == 1)
                    y[(size_t)m * N + n0 + tid] = from_f32<XT>(
                        sum * col_scale(scale, n_scale, n0 + tid));
                else
                    part[((size_t)blockIdx.y * M + m) * N + n0 + tid] = sum;
            }
        }
    }
}

template <typename XT>
__global__ void dequant_mv_reduce(const float* __restrict__ part,
                                  int splits, const float* __restrict__ scale,
                                  int n_scale, XT* __restrict__ y, int M,
                                  int N) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= M * N) return;
    float sum = 0.f;
    for (int sp = 0; sp < splits; ++sp) sum += part[(size_t)sp * M * N + i];
    y[i] = from_f32<XT>(sum * col_scale(scale, n_scale, i % N));
}

// --------------------------------------------------------------------------
// bf16, M > 16: tensor cores
// --------------------------------------------------------------------------

constexpr int MM_BM = 64, MM_BK = 32, MM_LD = MM_BK + 8;
constexpr int MM_THREADS = 128;

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
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

template <int WBITS>
__global__ void __launch_bounds__(MM_THREADS) dequant_mma_kernel(
        const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
        const float* __restrict__ scale, int n_scale,
        __nv_bfloat16* __restrict__ y, int M, int K, int N) {
    __shared__ __align__(16) __nv_bfloat16 xs[MM_BM][MM_LD];
    __shared__ __align__(16) __nv_bfloat16 wt[DM_BN][MM_LD];   // [n][k]
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
    const int m0 = blockIdx.y * MM_BM, n0 = blockIdx.x * DM_BN;
    const int wN = WBITS == 8 ? N : N / 2;
    float acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
    for (int k0 = 0; k0 < K; k0 += MM_BK) {
        for (int e = tid; e < MM_BM * MM_BK; e += MM_THREADS) {
            const int r = e / MM_BK, c = e % MM_BK;
            const int gm = m0 + r, gk = k0 + c;
            xs[r][c] = gm < M && gk < K ? x[(size_t)gm * K + gk]
                                        : __float2bfloat16_rn(0.f);
        }
        for (int e = tid; e < MM_BK * DM_BN; e += MM_THREADS) {
            const int r = e / DM_BN, c = e % DM_BN;
            const int gk = k0 + r, gn = n0 + c;
            wt[c][r] = __float2bfloat16_rn(
                gk < K && gn < N ? weight<WBITS>(w, wN, gk, gn) : 0.f);
        }
        __syncthreads();
#pragma unroll
        for (int kc = 0; kc < MM_BK / 16; ++kc) {
            uint32_t a[2][4];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const __nv_bfloat16* xr = &xs[wm + i * 16 + g][kc * 16 + 2 * t];
                a[i][0] = ld_pair(xr);
                a[i][1] = ld_pair(xr + 8 * MM_LD);
                a[i][2] = ld_pair(xr + 8);
                a[i][3] = ld_pair(xr + 8 * MM_LD + 8);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const __nv_bfloat16* wr = &wt[wn + j * 8 + g][kc * 16 + 2 * t];
                const uint32_t b0 = ld_pair(wr), b1 = ld_pair(wr + 8);
#pragma unroll
                for (int i = 0; i < 2; ++i) mma_bf16(acc[i][j], a[i], b0, b1);
            }
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int gm = m0 + wm + i * 16 + g + (e < 2 ? 0 : 8);
                const int gn = n0 + wn + j * 8 + 2 * t + (e & 1);
                if (gm < M && gn < N)
                    y[(size_t)gm * N + gn] = __float2bfloat16_rn(
                        acc[i][j][e] * col_scale(scale, n_scale, gn));
            }
}

template <typename XT, int WBITS>
int launch(const void* x, const int8_t* w, const float* scale, int n_scale,
           void* y, float* part, int M, int K, int N, cudaStream_t st) {
    const int n_blocks = (N + DM_BN - 1) / DM_BN;
    const auto xp = static_cast<const XT*>(x);
    const auto yp = static_cast<XT*>(y);
    if (M <= MV_ROWS) {
        // K in units of MV_UNIT rows over enough splits for 2 blocks an SM
        const int units = (K + MV_UNIT - 1) / MV_UNIT;
        const int want = min(units, (2 * N_SMS + n_blocks - 1) / n_blocks);
        const int per = (units + want - 1) / want;
        const int splits = (units + per - 1) / per;
        dequant_mv_kernel<XT, WBITS><<<dim3(n_blocks, splits), DM_THREADS, 0,
                                       st>>>(xp, w, scale, n_scale, yp, part,
                                             M, K, N, per * MV_UNIT);
        if (splits > 1)
            dequant_mv_reduce<XT><<<(M * N + 255) / 256, 256, 0, st>>>(
                part, splits, scale, n_scale, yp, M, N);
    } else if (std::is_same<XT, __nv_bfloat16>::value) {
        dequant_mma_kernel<WBITS><<<dim3(n_blocks, (M + MM_BM - 1) / MM_BM),
                                    MM_THREADS, 0, st>>>(
            reinterpret_cast<const __nv_bfloat16*>(x), w, scale, n_scale,
            reinterpret_cast<__nv_bfloat16*>(y), M, K, N);
    } else {
        dequant_mm_kernel<XT, WBITS><<<dim3(n_blocks, (M + 63) / 64),
                                       DM_THREADS, 0, st>>>(
            xp, w, scale, n_scale, yp, M, K, N);
    }
    return (int)cudaGetLastError();
}

template <int WBITS>
int dispatch(const void* x, int dtype, int M, int K, const int8_t* w, int N,
             const float* scale, int n_scale, void* y, float* part,
             void* stream) {
    if (M < 1 || K < 1 || N < 1 || n_scale < 1 || (WBITS == 4 && N % 2)
            || (M + 15) / 16 > 65535)
        return ERR_SHAPE;
    auto st = static_cast<cudaStream_t>(stream);
    if (dtype == F32)
        return launch<float, WBITS>(x, w, scale, n_scale, y, part, M, K,
                                    N, st);
    if (dtype == BF16)
        return launch<__nv_bfloat16, WBITS>(x, w, scale, n_scale, y, part,
                                            M, K, N, st);
    return ERR_DTYPE;
}

}  // namespace
}  // namespace wa

// K17: x [M, K] (f32 or bf16), wq [K, N] int8, scale [n_scale] f32 (1 or
// per column), y [M, N] in x's dtype; part: f32 scratch of
// min(ceil(K / 32), ceil(264 / ceil(N / 64))) * M * N values when M <= 16
// (else unused).
extern "C" int wa_int8_matmul(const void* x, int dtype, int M, int K,
                              const int8_t* wq, int N, const float* scale,
                              int n_scale, void* y, float* part,
                              void* stream) {
    return wa::dispatch<8>(x, dtype, M, K, wq, N, scale, n_scale, y, part,
                           stream);
}

// K18: x [M, K], wq [K, N / 2] packed int4 bytes (N even: both nibbles of
// every byte), scale [n_scale] f32, y [M, N] in x's dtype; part as K17's.
extern "C" int wa_int4_matmul(const void* x, int dtype, int M, int K,
                              const int8_t* wq, int N, const float* scale,
                              int n_scale, void* y, float* part,
                              void* stream) {
    return wa::dispatch<4>(x, dtype, M, K, wq, N, scale, n_scale, y, part,
                           stream);
}
