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
// decode rows the weight bytes.
//
// K17, three kernels by the rows and the type:
//
// - M <= 16 (a serving tick's slots, a short prompt): dequant_mv_kernel,
//   bytes-bound, on the CUDA cores. A block owns 64 columns and a range
//   of K, its 256 threads 16 groups of 4 neighbouring columns by 16
//   K-lanes; x is staged in 256-deep slices in shared memory, each thread
//   keeps the M x 4 sums of its lane in registers (its 4 weights one
//   4-byte load), and the K-lanes are summed in shared memory at the
//   end. K is split over enough blocks to give the card two a
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
//   memory. K18 takes it too for f32 and M > 16 (the token checks).
//
// K18, redesigned for the H100, all on the tensor cores but f32 x above
// 16 rows (dequant_mm_kernel, for the token checks). Every nibble is
// widened without an int -> float convert (a quarter of the FMA rate):
// (v & 15) ^ 8 goes into the mantissa of 128 as a bf16 (0x4300 | u) and
// 136 is subtracted, two values a register, exactly. Integers of at most
// 4 bits are exact in bf16, and so are their products with bf16 values
// in f32: the JAX kernel's arithmetic.
//
// - M <= 16 (a decode step, a serving tick, a short prompt):
//   int4_mv_mma_kernel, bytes-bound, one launch. y^T = W^T x^T through
//   mma.sync m16n8k16: the weights are A (16 output columns by 16 K rows),
//   x is B (8 rows a tile, two tiles above 8). A block owns a strip of 256
//   columns (8 vectors of 16 packed bytes) and a range of K rows; lane
//   (g, t) of each warp reads whole 16-byte vectors (ld.global.nc.v4) of
//   4 K rows at vector g, the next step's in flight while it multiplies
//   this one's, and a byte permute pairs two rows' nibbles as the A
//   fragment wants them. f32 x is fed as three bf16 terms whose sum is x
//   (each product exact, the sums f32). The warps' sums meet in shared
//   memory; where K is split (ops/int4_matmul.int4_plan), a strip's splits
//   are one thread block cluster: each stores its sums into the blocks of
//   the cluster that own them (distributed shared memory) and, after the
//   cluster's barrier, each block sums its share in split order. No
//   scratch, one launch, and a result that does not depend on the order
//   blocks run in.
// - bf16 and M > 16 (the encoder, the cross K/V, a long prompt):
//   int4_mma_kernel, operations-bound: a 128 x 128 output tile, 8 warps of
//   64 x 32, 64-deep slices, a 3-stage ring of 16-byte cp.async copies of
//   x's tile and of the packed tile (a quarter of the bf16 tile's bytes).
//   The block widens the next slice's packed tile into a bf16 [k][n] tile
//   (16 bytes of a row become 32 values, four 16-byte stores; two tiles,
//   so one barrier a slice) while it multiplies this one: A from
//   ldmatrix.x4 on x's tile, B from ldmatrix.x4.trans on the widened one,
//   padded row strides (144 and 272 bytes) keeping both free of bank
//   conflicts; the per-column scale and paired stores in the epilogue.
//
// Ragged M, N and K edges are masked, so every shape is taken; rows whose
// addresses are not 16-byte aligned take the kernels' byte-wise loads.
#include <type_traits>

#include "common.cuh"
#include "cp_async.cuh"

#include <cooperative_groups.h>

namespace wa {
namespace {

namespace cg = cooperative_groups;

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

// w[gk, c0 .. c0 + 3] (c0 a multiple of 4) with one 4-byte load where the
// row allows it; columns past N are 0
template <int WBITS>
__device__ __forceinline__ void weights4(const int8_t* __restrict__ w, int wN,
                                         int N, int gk, int c0,
                                         float (&wv)[4]) {
    static_assert(WBITS == 8, "K18 has its own kernels");
    const size_t at = (size_t)gk * wN + c0;
    if (c0 + 3 < N && reinterpret_cast<uintptr_t>(w + at) % 4 == 0) {
        const char4 q = *reinterpret_cast<const char4*>(w + at);
        wv[0] = q.x; wv[1] = q.y; wv[2] = q.z; wv[3] = q.w;
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

// --------------------------------------------------------------------------
// K18: the nibbles widened exactly, without an int -> float convert
// --------------------------------------------------------------------------

// the low nibble of each 16-bit half of v, ((u & 15) ^ 8) - 8, as a bf16
// pair: the nibble ^ 8 in the mantissa of 128 (0x4300 | u) minus 136
// (0x4308); exact. `magic` holds 0x43084308 in a register (wa_magic), so
// the mask and the xor are one lop3.
__device__ __forceinline__ uint32_t wa_magic() {
    uint32_t m;
    asm("mov.b32 %0, 0x43084308;" : "=r"(m));
    return m;
}

__device__ __forceinline__ uint32_t widen_pair(uint32_t v, uint32_t magic) {
    uint32_t t;
    asm("lop3.b32 %0, %1, 0x000F000F, %2, 0x6a;" : "=r"(t) : "r"(v),
        "r"(magic));                        // (v & 0x000F000F) ^ magic
    const __nv_bfloat162 d = __hsub2(
        *reinterpret_cast<const __nv_bfloat162*>(&t),
        *reinterpret_cast<const __nv_bfloat162*>(&magic));
    return *reinterpret_cast<const uint32_t*>(&d);
}

// byte B of w as (low nibble, high nibble), a bf16 pair; w4 = w >> 4
template <int B>
__device__ __forceinline__ uint32_t nib_bf16x2(uint32_t w, uint32_t w4,
                                               uint32_t magic) {
    return widen_pair(__byte_perm(w, w4, B | ((4 + B) << 8)), magic);
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

// --------------------------------------------------------------------------
// K18, M <= 16: decode rows on the tensor cores, one launch
// --------------------------------------------------------------------------

constexpr int Q4_VECS = 8;                  // 16-byte vectors a block row
constexpr int Q4_STRIP = 32 * Q4_VECS;      // output columns a block owns
constexpr int Q4_W = 8;                     // warps a block
constexpr int Q4_THREADS = 32 * Q4_W;
constexpr int Q4_RS = Q4_VECS * 33;         // a slot's row: padded vectors
constexpr int Q4_MAX_SPLIT = 16;            // blocks of a cluster
static_assert(Q4_THREADS == Q4_STRIP, "a scale a thread");

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

// y^T = W^T x^T by mma.sync m16n8k16, bf16 in, f32 sums: A holds 16
// output columns by 16 K rows of the weights, B 16 K rows by 8 rows of x
// (NT tiles of 8 rows; f32 x as three bf16 terms, each its own product
// into the same sums). Lane (g, t) reads rows 2t, 2t + 1, 2t + 8, 2t + 9
// of each 16-row step at vector g of the strip, 16 bytes each: the K rows
// its A and B fragments hold. mma j takes byte j of the vectors: A's row
// g is the byte's low nibble (column 2j of vector g), row g + 8 its high
// nibble (2j + 1); a byte permute pairs two K rows' nibbles in a register.
// Warp w takes steps w, w + W, ..; each stores its sums to its slot of
// shared memory and the block sums the slots in order. Split K: the
// grid's splits of a strip are one cluster (ops/int4_matmul.int4_plan);
// split b stores its sums of outputs [r C, (r + 1) C) into block r's
// shared memory, and after the cluster's barrier block r sums them in
// split order and writes them.
template <typename XT, int NT, bool ALIGNED>
__global__ void __launch_bounds__(Q4_THREADS) int4_mv_mma_kernel(
        const XT* __restrict__ x, const uint8_t* __restrict__ w,
        const float* __restrict__ scale, int n_scale, XT* __restrict__ y,
        int M, int K, int N, int split_rows) {
    constexpr int TERMS = std::is_same<XT, float>::value ? 3 : 1;
    extern __shared__ __align__(16) float q4_smem[];
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int rowb = N / 2, vec = blockIdx.x * Q4_VECS + g;
    const bool active = vec < (rowb + 15) / 16;
    const int k0 = blockIdx.y * split_rows;
    const int kend = min(K, k0 + split_rows);
    const int steps = (kend - k0 + 15) / 16;
    const int rows[4] = {2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9};
    float acc[NT][16][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 16; ++j)
            acc[nt][j][0] = acc[nt][j][1] = acc[nt][j][2] = acc[nt][j][3] =
                0.f;
    // this thread's column's scale, requested with the first vectors and
    // kept in shared memory for the epilogues (Q4_THREADS == Q4_STRIP)
    const int my_col = blockIdx.x * Q4_STRIP + tid;
    const float my_scale = my_col < N ? col_scale(scale, n_scale, my_col)
                                      : 0.f;
    // the next step's weight vectors and x pairs, requested while this
    // step's products run
    uint4 q[4];
    XPair<XT> xq[NT][2];
    const auto fetch = [&](int s) {
        const int kb = k0 + 16 * s;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int k = kb + rows[i];
            q[i] = active && k < kend ? load_vec<ALIGNED>(w, rowb, k, vec)
                                      : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h)
                xq[nt][h] = x_pair<XT>(x, M, K, kend, 8 * nt + g,
                                       kb + 2 * t + 8 * h);
    };
    fetch(warp);
    for (int s = warp; s < steps; s += Q4_W) {
        uint32_t r[4][4], b[NT][2][TERMS];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            r[i][0] = q[i].x; r[i][1] = q[i].y;
            r[i][2] = q[i].z; r[i][3] = q[i].w;
        }
        const uint32_t magic = wa_magic();
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) x_terms(xq[nt][h], b[nt][h]);
        fetch(s + Q4_W);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            // byte j of rows 2t, 2t + 1 (and + 8) side by side, and of the
            // rows' words >> 4 (the high nibbles)
            const int sel = (j % 4) | ((4 + j % 4) << 8), wd = j / 4;
            const uint32_t a[4] = {
                widen_pair(__byte_perm(r[0][wd], r[1][wd], sel), magic),
                widen_pair(__byte_perm(r[0][wd] >> 4, r[1][wd] >> 4, sel),
                           magic),
                widen_pair(__byte_perm(r[2][wd], r[3][wd], sel), magic),
                widen_pair(__byte_perm(r[2][wd] >> 4, r[3][wd] >> 4, sel),
                           magic)};
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int i = 0; i < TERMS; ++i)
                    mma_bf16(acc[nt][j], a, b[nt][0][i], b[nt][1][i]);
        }
    }

    // lane (g, t) holds rows 8 nt + 2t (+1) of columns 32 g + 2j (+1); a
    // slot is [M rows][8 vectors of 33]. Warps past the block's steps
    // hold nothing.
    const int busy = min(Q4_W, steps);
    const int n_split = gridDim.y, total = M * Q4_STRIP;
    const int chunk = (total + n_split - 1) / n_split;
    float* sums = q4_smem + Q4_W * M * Q4_RS;       // [split][chunk]
    float* col_scales = sums + (n_split > 1 ? n_split * chunk : 0);
    col_scales[tid] = my_scale;
    float* slot = q4_smem + warp * M * Q4_RS + 33 * g;
#pragma unroll
    for (int nt = 0; nt < NT && warp < busy; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int m = 8 * nt + 2 * t + (e & 1);
            if (m < M) {
#pragma unroll
                for (int j = 0; j < 16; ++j)
                    slot[m * Q4_RS + 2 * j + (e >> 1)] = acc[nt][j][e];
            }
        }
    __syncthreads();

    // the slots summed in order; with split K, split b stores its sums of
    // outputs [r C, (r + 1) C) into block r's shared memory, and after
    // the cluster's barrier block r sums them in split order
    for (int e = tid; e < total; e += Q4_THREADS) {
        const int m = e / Q4_STRIP, n = e % Q4_STRIP;
        const float* s = q4_smem + m * Q4_RS + 33 * (n / 32) + n % 32;
        float v = s[0];
#pragma unroll
        for (int i = 1; i < Q4_W; ++i)
            if (i < busy) v += s[i * M * Q4_RS];
        const int gn = blockIdx.x * Q4_STRIP + n;
        if (n_split > 1) {
            const int r = e / chunk;
            cg::this_cluster().map_shared_rank(sums, r)[
                blockIdx.y * chunk + e - r * chunk] = v;
        } else if (gn < N) {
            y[(size_t)m * N + gn] = from_f32<XT>(v * col_scales[n]);
        }
    }
    if (n_split == 1) return;
    cg::this_cluster().sync();      // every split's sums have arrived
    for (int i = tid; i < chunk; i += Q4_THREADS) {
        const int e = blockIdx.y * chunk + i;
        if (e >= total) break;
        float a[Q4_MAX_SPLIT];
#pragma unroll
        for (int sp = 0; sp < Q4_MAX_SPLIT; ++sp)
            a[sp] = sp < n_split ? sums[sp * chunk + i] : 0.f;
        float v = a[0];
#pragma unroll
        for (int sp = 1; sp < Q4_MAX_SPLIT; ++sp)
            if (sp < n_split) v += a[sp];
        const int n = e % Q4_STRIP, gn = blockIdx.x * Q4_STRIP + n;
        if (gn < N)
            y[(size_t)(e / Q4_STRIP) * N + gn] = from_f32<XT>(
                v * col_scales[n]);
    }
}

// shared memory of a decode launch: the warps' slots, with split K every
// split's share of the block's outputs, and the strip's scales
__host__ __forceinline__ size_t mv_smem(int M, int n_split) {
    const size_t total = (size_t)M * Q4_STRIP;
    return sizeof(float)
           * ((size_t)Q4_W * M * Q4_RS
              + (n_split > 1 ? n_split * ((total + n_split - 1) / n_split)
                             : 0)
              + Q4_STRIP);
}

template <typename XT, int NT, bool ALIGNED>
int launch_mv(const void* x, const uint8_t* w, const float* scale,
              int n_scale, void* y, int M, int K, int N, int n_split,
              int split_rows, cudaStream_t st) {
    const auto kernel = int4_mv_mma_kernel<XT, NT, ALIGNED>;
    const int smem = (int)mv_smem(M, n_split);
    static int opted_in = 0;                // the most asked of this kernel
    if (smem > opted_in) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e == cudaSuccess && opted_in == 0)    // clusters of up to 16
            e = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (e != cudaSuccess) return (int)e;
        opted_in = smem;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((N + Q4_STRIP - 1) / Q4_STRIP, n_split);
    cfg.blockDim = dim3(Q4_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = 1;
    cluster[0].val.clusterDim.y = n_split;
    cluster[0].val.clusterDim.z = 1;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    return (int)cudaLaunchKernelEx(&cfg, kernel, static_cast<const XT*>(x),
                                   w, scale, n_scale, static_cast<XT*>(y), M,
                                   K, N, split_rows);
}

// --------------------------------------------------------------------------
// K18, bf16 and M > 16: tensor cores
// --------------------------------------------------------------------------

constexpr int T4_BM = 128, T4_BN = 128, T4_BK = 64, T4_STAGES = 3;
constexpr int T4_THREADS = 256;
constexpr int T4_XLD = T4_BK + 8;       // x tile row: 144 bytes
constexpr int T4_WLD = T4_BN + 8;       // widened tile row: 272 bytes
constexpr int T4_PB = T4_BN / 2;        // packed bytes of a tile row

// dynamic shared memory (102400 bytes: two blocks an SM)
struct T4Smem {
    __nv_bfloat16 xs[T4_STAGES][T4_BM][T4_XLD];
    uint8_t wp[T4_STAGES][T4_BK][T4_PB];
    __nv_bfloat16 wt[2][T4_BK][T4_WLD];     // [k][n], two slices
};

// stage the slice at k0 of x's tile and of the packed tile: 16-byte
// cp.async copies (zero-filled past M, K and the row), or, when rows are
// not 16-byte aligned, element loads
template <bool ALIGNED>
__device__ __forceinline__ void t4_stage(
        T4Smem& s, int st, const __nv_bfloat16* __restrict__ x,
        const uint8_t* __restrict__ w, int M, int K, int N, int m0, int n0,
        int k0, int tid) {
    const int rowb = N / 2;
    if (ALIGNED) {
#pragma unroll
        for (int e = tid; e < T4_BM * (T4_BK / 8); e += T4_THREADS) {
            const int r = e / (T4_BK / 8), c = 8 * (e % (T4_BK / 8));
            const bool ok = m0 + r < M && k0 + c < K;
            cp_async16(&s.xs[st][r][c],
                       ok ? x + (size_t)(m0 + r) * K + k0 + c : x,
                       ok ? 16 : 0);
        }
#pragma unroll
        for (int e = tid; e < T4_BK * (T4_PB / 16); e += T4_THREADS) {
            const int r = e / (T4_PB / 16), c = 16 * (e % (T4_PB / 16));
            const bool ok = k0 + r < K && n0 / 2 + c < rowb;
            cp_async16(&s.wp[st][r][c],
                       ok ? w + (size_t)(k0 + r) * rowb + n0 / 2 + c : w,
                       ok ? 16 : 0);
        }
        return;
    }
    for (int e = tid; e < T4_BM * T4_BK; e += T4_THREADS) {
        const int r = e / T4_BK, c = e % T4_BK;
        s.xs[st][r][c] = m0 + r < M && k0 + c < K
            ? x[(size_t)(m0 + r) * K + k0 + c] : __float2bfloat16_rn(0.f);
    }
    for (int e = tid; e < T4_BK * T4_PB; e += T4_THREADS) {
        const int r = e / T4_PB, c = e % T4_PB;
        s.wp[st][r][c] = k0 + r < K && n0 / 2 + c < rowb
            ? w[(size_t)(k0 + r) * rowb + n0 / 2 + c] : (uint8_t)0;
    }
}

// widen stage st's packed slice into wt[buf]: each thread 16 bytes of a
// row, 32 bf16 values, four 16-byte stores
__device__ __forceinline__ void t4_widen(T4Smem& s, int st, int buf,
                                         int tid) {
    const int r = tid / (T4_PB / 16), c = 16 * (tid % (T4_PB / 16));
    const uint4 q = *reinterpret_cast<const uint4*>(&s.wp[st][r][c]);
    const uint32_t words[4] = {q.x, q.y, q.z, q.w};
    const uint32_t magic = wa_magic();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const uint32_t v = words[j], v4 = v >> 4;
        *reinterpret_cast<uint4*>(&s.wt[buf][r][2 * c + 8 * j]) = make_uint4(
            nib_bf16x2<0>(v, v4, magic), nib_bf16x2<1>(v, v4, magic),
            nib_bf16x2<2>(v, v4, magic), nib_bf16x2<3>(v, v4, magic));
    }
}

// one barrier a slice: at slice it, stage it + 1 has landed and slice it
// is widened; the block requests stage it + 2 (into the ring slot that
// slice it - 1 freed), widens slice it + 1 into the other wt buffer and
// runs slice it's products
template <bool ALIGNED>
__global__ void __launch_bounds__(T4_THREADS) int4_mma_kernel(
        const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
        const float* __restrict__ scale, int n_scale,
        __nv_bfloat16* __restrict__ y, int M, int K, int N) {
    static_assert(T4_THREADS == T4_BK * (T4_PB / 16), "one vector each");
    extern __shared__ __align__(16) unsigned char t4_smem[];
    T4Smem& s = *reinterpret_cast<T4Smem*>(t4_smem);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
    const int m0 = blockIdx.y * T4_BM, n0 = blockIdx.x * T4_BN;
    const int nk = (K + T4_BK - 1) / T4_BK;
    float acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
    t4_stage<ALIGNED>(s, 0, x, w, M, K, N, m0, n0, 0, tid);
    cp_async_commit();
    if (nk > 1) t4_stage<ALIGNED>(s, 1, x, w, M, K, N, m0, n0, T4_BK, tid);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    t4_widen(s, 0, 0, tid);
    for (int it = 0; it < nk; ++it) {
        const int st = it % T4_STAGES, buf = it & 1;
        cp_async_wait<0>();
        __syncthreads();
        if (it + 2 < nk)
            t4_stage<ALIGNED>(s, (it + 2) % T4_STAGES, x, w, M, K, N, m0,
                              n0, (it + 2) * T4_BK, tid);
        cp_async_commit();
        if (it + 1 < nk) t4_widen(s, (it + 1) % T4_STAGES, buf ^ 1, tid);
#pragma unroll
        for (int kc = 0; kc < T4_BK / 16; ++kc) {
            uint32_t a[4][4], b[4][2];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                ldmatrix_x4(a[i], &s.xs[st][wm + 16 * i + (lane & 15)]
                                       [16 * kc + 8 * (lane >> 4)]);
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
                uint32_t r[4];
                ldmatrix_x4_trans(
                    r, &s.wt[buf][16 * kc + (lane & 15)]
                                 [wn + 16 * jj + 8 * (lane >> 4)]);
                b[2 * jj][0] = r[0]; b[2 * jj][1] = r[1];
                b[2 * jj + 1][0] = r[2]; b[2 * jj + 1][1] = r[3];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
        }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int gn = n0 + wn + 8 * j + 2 * t;     // even; N is even
        if (gn >= N) continue;
        const float s0 = col_scale(scale, n_scale, gn);
        const float s1 = col_scale(scale, n_scale, gn + 1);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int gm = m0 + wm + 16 * i + g + 8 * h;
                if (gm < M)
                    *reinterpret_cast<__nv_bfloat162*>(
                        y + (size_t)gm * N + gn) = __floats2bfloat162_rn(
                        acc[i][j][2 * h] * s0, acc[i][j][2 * h + 1] * s1);
            }
    }
}

template <typename XT>
int launch_int4(const void* x, const uint8_t* w, const float* scale,
                int n_scale, void* y, int M, int K, int N, int n_split,
                int split_rows, cudaStream_t st) {
    const int rowb = N / 2;
    if (M <= 16) {
        if (n_split < 1 || n_split > Q4_MAX_SPLIT || split_rows < 1
                || split_rows % 16 || (long long)n_split * split_rows < K
                || (long long)(n_split - 1) * split_rows >= K)
            return ERR_SHAPE;
        const bool al = reinterpret_cast<uintptr_t>(w) % 16 == 0
                        && rowb % 16 == 0;
        if (M <= 8)
            return al ? launch_mv<XT, 1, true>(x, w, scale, n_scale, y, M, K,
                                               N, n_split, split_rows, st)
                      : launch_mv<XT, 1, false>(x, w, scale, n_scale, y, M,
                                                K, N, n_split, split_rows,
                                                st);
        return al ? launch_mv<XT, 2, true>(x, w, scale, n_scale, y, M, K, N,
                                           n_split, split_rows, st)
                  : launch_mv<XT, 2, false>(x, w, scale, n_scale, y, M, K, N,
                                            n_split, split_rows, st);
    }
    if (n_split != 1) return ERR_SHAPE;
    if (std::is_same<XT, __nv_bfloat16>::value) {
        const bool al = reinterpret_cast<uintptr_t>(x) % 16 == 0 && K % 8 == 0
                        && reinterpret_cast<uintptr_t>(w) % 16 == 0
                        && rowb % 16 == 0;
        const dim3 grid((N + T4_BN - 1) / T4_BN, (M + T4_BM - 1) / T4_BM);
        const auto xp = static_cast<const __nv_bfloat16*>(x);
        const auto yp = static_cast<__nv_bfloat16*>(y);
        const auto kernel = al ? int4_mma_kernel<true>
                               : int4_mma_kernel<false>;
        const int smem = (int)sizeof(T4Smem);
        static bool opted_in[2] = {false, false};   // once per kernel
        if (!opted_in[al]) {
            const cudaError_t e = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
            if (e != cudaSuccess) return (int)e;
            opted_in[al] = true;
        }
        kernel<<<grid, T4_THREADS, smem, st>>>(xp, w, scale, n_scale, yp, M,
                                               K, N);
    } else {
        dequant_mm_kernel<XT, 4><<<dim3((N + DM_BN - 1) / DM_BN,
                                        (M + 63) / 64), DM_THREADS, 0, st>>>(
            static_cast<const XT*>(x), reinterpret_cast<const int8_t*>(w),
            scale, n_scale, static_cast<XT*>(y), M, K, N);
    }
    return (int)cudaGetLastError();
}

int dispatch_int4(const void* x, int dtype, int M, int K, const uint8_t* w,
                  int N, const float* scale, int n_scale, void* y,
                  int n_split, int split_rows, void* stream) {
    if (M < 1 || K < 1 || N < 2 || N % 2 || n_scale < 1
            || (M + T4_BM - 1) / T4_BM > 65535)
        return ERR_SHAPE;
    auto st = static_cast<cudaStream_t>(stream);
    if (dtype == F32)
        return launch_int4<float>(x, w, scale, n_scale, y, M, K, N, n_split,
                                  split_rows, st);
    if (dtype == BF16)
        return launch_int4<__nv_bfloat16>(x, w, scale, n_scale, y, M, K, N,
                                          n_split, split_rows, st);
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
// every byte), scale [n_scale] f32, y [M, N] in x's dtype. For M <= 16
// the caller's plan (ops/int4_matmul.int4_plan): n_split blocks over K
// (at most 16: one cluster), each split_rows rows (a multiple of 16);
// for M > 16, n_split 1. No scratch.
extern "C" int wa_int4_matmul(const void* x, int dtype, int M, int K,
                              const int8_t* wq, int N, const float* scale,
                              int n_scale, void* y, int n_split,
                              int split_rows, void* stream) {
    return wa::dispatch_int4(x, dtype, M, K,
                             reinterpret_cast<const uint8_t*>(wq), N, scale,
                             n_scale, y, n_split, split_rows, stream);
}
