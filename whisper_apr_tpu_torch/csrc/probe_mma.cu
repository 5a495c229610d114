// P1-P3: the lowering probes of the JAX package's kernel-measuring tool.
//
// Replaces the Pallas kernels of tools/probe_layer_kernel.py:
//   P1  int8dot_probe, pallas_call at :427 -- int8 [M, K] x int8 [K, N]
//       -> int32 (jax.lax.dot, preferred_element_type int32), exact;
//   P2  int8dot_probe, pallas_call at :447 -- int8 [M, K] x bf16 [K, N]
//       -> f32;
//   P3  tricks_probe, pallas_call at :479 (try_kernel, sub-probes (a)-(j)
//       at :491-631) -- dot / dot_general over f32, bf16 and int8 operands
//       with an f32 result, a transposed left operand (contracting dim 0)
//       and a leading batch axis, and 2-D f32 transposes.
// Each computes what the Pallas body computes; the tiling is this card's.
//
// Bound: at the probes' shapes (256^3 for P1/P2; bt=128, D=1280, H=32, B=8
// for P3) every call moves well under a few MB and does at most 42 MFLOP,
// so the bounds are a fraction of a microsecond to a few microseconds and
// the launch latency (a few us) is what the card shows. The probes ask
// whether a form runs and is exact, not how fast it can be made.
//
// Design. Output tiles of 64 x 64 per block, K in chunks; tiles past the
// edges are zero-filled when staged and masked when stored, so any shape
// runs. Operands are read from device memory in their own dtype and
// converted in registers on the way into shared memory: there is no
// separate cast pass over memory, which is the question the probes ask
// for the int8 K/V rows of the batched attention kernels.
//   int8_mma_kernel (P1): mma.sync m16n8k32 s8.s8 -> s32. sm_90's ldmatrix
//     transposes 16-bit elements only, so B [K, N] (row-major) is
//     transposed while it is staged: shared memory holds it [N][K], and
//     each B fragment register is four k-neighbouring bytes of one column,
//     one 32-bit load. A fragments are 32-bit loads of its rows.
//   mixed_mma_kernel (P2, P3 (b), (i)): Hopper has no mixed int8 x bf16
//     MMA. int8 converts to bf16 exactly (|v| <= 127 needs 7 bits), f32
//     rounds to nearest even (case (i)'s in-kernel cast), both in
//     registers; A is staged [M][K] (a transposed A [K, M] is transposed
//     while staged), B [N][K]; then mma.sync m16n8k16 bf16 with f32 sums.
//     Products of bf16 and int8 values are exact in f32.
//   f32_dot_kernel (P3 (a), (c), (e)-(h), (j)): any f32 operand stays on
//     the CUDA cores in f32 (int8 converted in registers): the tensor
//     cores would round f32 inputs to TF32 (about 3 digits), and the
//     contract is an f32 dot. 256 threads, 4 x 4 outputs each.
//   transpose_kernel (P3 (d)): a 32 x 33 shared-memory tile (the pad
//     column keeps the transposed reads off one bank); exact.
#include "common.cuh"

namespace wa {
namespace {

constexpr int PT = 64;               // output tile rows and columns
constexpr int MMA_K = 32;            // K chunk of the tensor-core kernels
constexpr int MMA_THREADS = 128;     // 4 warps x 16 rows
constexpr int F_K = 16;              // K chunk of the CUDA-core kernel
constexpr int F_THREADS = 256;       // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const void* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ __nv_bfloat16 to_bf16(float v) {
    return __float2bfloat16_rn(v);
}
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 v) {
    return v;
}
__device__ __forceinline__ __nv_bfloat16 to_bf16(int8_t v) {
    return __float2bfloat16_rn((float)v);
}

template <typename T> __device__ __forceinline__ T zero_of() { return T(0); }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
    return __float2bfloat16_rn(0.f);
}

// element (m, k) of A, given [M, K] or (TA_T) [K, M]; 0 past the edges
template <typename T, bool TA_T>
__device__ __forceinline__ T a_at(const T* a, int m, int k, int M, int K) {
    if (m >= M || k >= K) return zero_of<T>();
    return TA_T ? a[(size_t)k * M + m] : a[(size_t)m * K + k];
}

template <typename T>
__device__ __forceinline__ T b_at(const T* b, int k, int n, int K, int N) {
    return (k < K && n < N) ? b[(size_t)k * N + n] : zero_of<T>();
}

// which (row, k) of a PT x KC tile element e stands for: along k for a
// row-major source, along the rows for a transposed one (coalesced reads)
template <bool ALONG_ROWS, int KC>
__device__ __forceinline__ void tile_pos(int e, int& r, int& k) {
    if (ALONG_ROWS) {
        k = e / PT;
        r = e % PT;
    } else {
        r = e / KC;
        k = e % KC;
    }
}

// P1: C [M, N] int32 = A [M, K] int8 . B [K, N] int8
__global__ void __launch_bounds__(MMA_THREADS) int8_mma_kernel(
        const int8_t* __restrict__ a, const int8_t* __restrict__ b,
        int32_t* __restrict__ c, int M, int K, int N) {
    constexpr int LD = MMA_K + 4;    // bytes; keeps 32-bit alignment
    __shared__ __align__(16) int8_t as[PT][LD];    // [m][k]
    __shared__ __align__(16) int8_t bs[PT][LD];    // [n][k]
    const int m0 = blockIdx.y * PT, n0 = blockIdx.x * PT;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    int acc[PT / 8][4];
#pragma unroll
    for (int i = 0; i < PT / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] =
        acc[i][3] = 0;
    for (int k0 = 0; k0 < K; k0 += MMA_K) {
        __syncthreads();
        for (int e = tid; e < PT * MMA_K; e += MMA_THREADS) {
            int r, k;
            tile_pos<false, MMA_K>(e, r, k);
            as[r][k] = a_at<int8_t, false>(a, m0 + r, k0 + k, M, K);
            tile_pos<true, MMA_K>(e, r, k);
            bs[r][k] = b_at(b, k0 + k, n0 + r, K, N);
        }
        __syncthreads();
        const int r = warp * 16 + g;
        const uint32_t af[4] = {ld32(&as[r][4 * t]), ld32(&as[r + 8][4 * t]),
                                ld32(&as[r][16 + 4 * t]),
                                ld32(&as[r + 8][16 + 4 * t])};
#pragma unroll
        for (int nt = 0; nt < PT / 8; ++nt) {
            const int8_t* bp = bs[nt * 8 + g];
            mma_s8(acc[nt], af, ld32(bp + 4 * t), ld32(bp + 16 + 4 * t));
        }
    }
    const int r0 = m0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
    for (int nt = 0; nt < PT / 8; ++nt) {
        const int col = n0 + nt * 8 + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int row = e < 2 ? r0 : r1, cc = col + (e & 1);
            if (row < M && cc < N) c[(size_t)row * N + cc] = acc[nt][e];
        }
    }
}

// P2, P3 (b), (i): C [M, N] f32 = A . B on the tensor cores in bf16, A
// [M, K] or (TA_T) [K, M] of TA in {f32, bf16, int8}, B [K, N] of TB in
// {bf16, int8}; blockIdx.z walks a leading batch axis
template <typename TA, typename TB, bool TA_T>
__global__ void __launch_bounds__(MMA_THREADS) mixed_mma_kernel(
        const TA* __restrict__ a, const TB* __restrict__ b,
        float* __restrict__ c, int M, int K, int N) {
    constexpr int LD = MMA_K + 8;    // bf16 elements: 80-byte rows
    __shared__ __align__(16) __nv_bfloat16 as[PT][LD];   // [m][k]
    __shared__ __align__(16) __nv_bfloat16 bs[PT][LD];   // [n][k]
    a += (size_t)blockIdx.z * M * K;
    b += (size_t)blockIdx.z * K * N;
    c += (size_t)blockIdx.z * M * N;
    const int m0 = blockIdx.y * PT, n0 = blockIdx.x * PT;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    float acc[PT / 8][4];
#pragma unroll
    for (int i = 0; i < PT / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] =
        acc[i][3] = 0.f;
    for (int k0 = 0; k0 < K; k0 += MMA_K) {
        __syncthreads();
        for (int e = tid; e < PT * MMA_K; e += MMA_THREADS) {
            int r, k;
            tile_pos<TA_T, MMA_K>(e, r, k);
            as[r][k] = to_bf16(a_at<TA, TA_T>(a, m0 + r, k0 + k, M, K));
            tile_pos<true, MMA_K>(e, r, k);
            bs[r][k] = to_bf16(b_at(b, k0 + k, n0 + r, K, N));
        }
        __syncthreads();
        const int r = warp * 16 + g;
#pragma unroll
        for (int kc = 0; kc < MMA_K; kc += 16) {
            const int kb = kc + 2 * t;
            const uint32_t af[4] = {ld32(&as[r][kb]), ld32(&as[r + 8][kb]),
                                    ld32(&as[r][kb + 8]),
                                    ld32(&as[r + 8][kb + 8])};
#pragma unroll
            for (int nt = 0; nt < PT / 8; ++nt) {
                const __nv_bfloat16* bp = &bs[nt * 8 + g][kb];
                mma_bf16(acc[nt], af, ld32(bp), ld32(bp + 8));
            }
        }
    }
    const int r0 = m0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
    for (int nt = 0; nt < PT / 8; ++nt) {
        const int col = n0 + nt * 8 + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int row = e < 2 ? r0 : r1, cc = col + (e & 1);
            if (row < M && cc < N) c[(size_t)row * N + cc] = acc[nt][e];
        }
    }
}

// P3 (a), (c), (e)-(h), (j): the same contraction on the CUDA cores in f32
template <typename TA, typename TB, bool TA_T>
__global__ void __launch_bounds__(F_THREADS) f32_dot_kernel(
        const TA* __restrict__ a, const TB* __restrict__ b,
        float* __restrict__ c, int M, int K, int N) {
    __shared__ float as[F_K][PT + 4];    // [k][m]
    __shared__ float bs[F_K][PT + 4];    // [k][n]
    a += (size_t)blockIdx.z * M * K;
    b += (size_t)blockIdx.z * K * N;
    c += (size_t)blockIdx.z * M * N;
    const int m0 = blockIdx.y * PT, n0 = blockIdx.x * PT;
    const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += F_K) {
        __syncthreads();
        for (int e = tid; e < PT * F_K; e += F_THREADS) {
            int r, k;
            tile_pos<TA_T, F_K>(e, r, k);
            as[k][r] = to_f32(a_at<TA, TA_T>(a, m0 + r, k0 + k, M, K));
            tile_pos<true, F_K>(e, r, k);
            bs[k][r] = to_f32(b_at(b, k0 + k, n0 + r, K, N));
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < F_K; ++k) {
            float av[4], bv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                av[i] = as[k][ty * 4 + i];
                bv[i] = bs[k][tx * 4 + i];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = m0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int col = n0 + tx * 4 + j;
            if (row < M && col < N) c[(size_t)row * N + col] = acc[i][j];
        }
    }
}

// P3 (d): O [C, R] = A [R, C]ᵀ, f32
__global__ void __launch_bounds__(256) transpose_kernel(
        const float* __restrict__ a, float* __restrict__ o, int R, int C) {
    __shared__ float tile[32][33];
    const int r0 = blockIdx.y * 32, c0 = blockIdx.x * 32;
    const int tx = threadIdx.x, ty = threadIdx.y;
    for (int i = ty; i < 32; i += 8) {
        const int r = r0 + i, cc = c0 + tx;
        if (r < R && cc < C) tile[i][tx] = a[(size_t)r * C + cc];
    }
    __syncthreads();
    for (int i = ty; i < 32; i += 8) {
        const int orow = c0 + i, ocol = r0 + tx;
        if (orow < C && ocol < R) o[(size_t)orow * R + ocol] = tile[tx][i];
    }
}

dim3 tiles(int M, int N, int batch) {
    return dim3((N + PT - 1) / PT, (M + PT - 1) / PT, batch);
}

bool bad_shape(int batch, int M, int K, int N) {
    return batch < 1 || batch > 65535 || M < 1 || K < 1 || N < 1
        || (M + PT - 1) / PT > 65535;
}

template <template <typename, typename, bool> class Launch, typename TA,
          typename TB>
int by_trans(int trans_a, const void* a, const void* b, void* c, int batch,
             int M, int K, int N, cudaStream_t st) {
    if (trans_a)
        Launch<TA, TB, true>::run(a, b, c, batch, M, K, N, st);
    else
        Launch<TA, TB, false>::run(a, b, c, batch, M, K, N, st);
    return (int)cudaGetLastError();
}

template <typename TA, typename TB, bool TA_T>
struct MixedLaunch {
    static void run(const void* a, const void* b, void* c, int batch, int M,
                    int K, int N, cudaStream_t st) {
        mixed_mma_kernel<TA, TB, TA_T><<<tiles(M, N, batch), MMA_THREADS, 0,
                                         st>>>(
            static_cast<const TA*>(a), static_cast<const TB*>(b),
            static_cast<float*>(c), M, K, N);
    }
};

template <typename TA, typename TB, bool TA_T>
struct F32Launch {
    static void run(const void* a, const void* b, void* c, int batch, int M,
                    int K, int N, cudaStream_t st) {
        f32_dot_kernel<TA, TB, TA_T><<<tiles(M, N, batch), F_THREADS, 0,
                                       st>>>(
            static_cast<const TA*>(a), static_cast<const TB*>(b),
            static_cast<float*>(c), M, K, N);
    }
};

}  // namespace
}  // namespace wa

// P1: a [M, K] int8, b [K, N] int8, c [M, N] int32, all contiguous.
extern "C" int wa_probe_int8_mma(const void* a, const void* b, void* c,
                                 int M, int K, int N, void* stream) {
    using namespace wa;
    if (bad_shape(1, M, K, N)) return ERR_SHAPE;
    int8_mma_kernel<<<tiles(M, N, 1), MMA_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
        static_cast<int32_t*>(c), M, K, N);
    return (int)cudaGetLastError();
}

// P2, P3 (b), (i): c [batch, M, N] f32 = a . b on the tensor cores; a
// [batch, M, K] or (trans_a) [batch, K, M] of dtype ta (f32, bf16, int8),
// b [batch, K, N] of dtype tb (bf16, int8), all contiguous.
extern "C" int wa_probe_mma_bf16(const void* a, int ta, int trans_a,
                                 const void* b, int tb, void* c, int batch,
                                 int M, int K, int N, void* stream) {
    using namespace wa;
    if (bad_shape(batch, M, K, N)) return ERR_SHAPE;
    auto st = static_cast<cudaStream_t>(stream);
#define WA_MIXED(TA_CODE, TA)                                               \
    if (ta == TA_CODE && tb == BF16)                                        \
        return by_trans<MixedLaunch, TA, __nv_bfloat16>(trans_a, a, b, c,   \
                                                        batch, M, K, N, st); \
    if (ta == TA_CODE && tb == I8)                                          \
        return by_trans<MixedLaunch, TA, int8_t>(trans_a, a, b, c, batch, M, \
                                                 K, N, st);
    WA_MIXED(F32, float)
    WA_MIXED(BF16, __nv_bfloat16)
    WA_MIXED(I8, int8_t)
#undef WA_MIXED
    return ERR_DTYPE;
}

// P3 (a), (c), (e)-(h), (j): the same contraction on the CUDA cores in
// f32; ta and tb each f32 or int8.
extern "C" int wa_probe_dot_f32(const void* a, int ta, int trans_a,
                                const void* b, int tb, void* c, int batch,
                                int M, int K, int N, void* stream) {
    using namespace wa;
    if (bad_shape(batch, M, K, N)) return ERR_SHAPE;
    auto st = static_cast<cudaStream_t>(stream);
    if (ta == F32 && tb == F32)
        return by_trans<F32Launch, float, float>(trans_a, a, b, c, batch, M,
                                                 K, N, st);
    if (ta == F32 && tb == I8)
        return by_trans<F32Launch, float, int8_t>(trans_a, a, b, c, batch,
                                                  M, K, N, st);
    if (ta == I8 && tb == F32)
        return by_trans<F32Launch, int8_t, float>(trans_a, a, b, c, batch,
                                                  M, K, N, st);
    return ERR_DTYPE;
}

// P3 (d): out [C, R] = a [R, C]ᵀ, f32, contiguous.
extern "C" int wa_probe_transpose(const void* a, void* out, int R, int C,
                                  void* stream) {
    using namespace wa;
    if (R < 1 || C < 1 || (R + 31) / 32 > 65535) return ERR_SHAPE;
    transpose_kernel<<<dim3((C + 31) / 32, (R + 31) / 32), dim3(32, 8), 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(a), static_cast<float*>(out), R, C);
    return (int)cudaGetLastError();
}
