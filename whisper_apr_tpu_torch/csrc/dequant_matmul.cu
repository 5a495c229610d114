// K18: the matmul over packed-int4 weights.
//
// K18 replaces the Pallas kernel of whisper_apr_tpu/ops/int4_matmul.py
// (_int4_matmul_kernel / int4_matmul, pallas_call at :115). It computes
//
//   y[m, n] = (sum_k x[m, k] * w[k, n]) * scale[n]     (f32 sum)
//
// cast to x's dtype, with w[k, n] the nibble of byte wq[k, n / 2] (low
// nibble for even n, high for odd), ((v & 15) ^ 8) - 8. The scale is one
// value for every column (n_scale == 1) or one per column; columns past
// n_scale take 0 (an odd int4 width's last, padded column, which the
// caller cuts). The weights are converted inside the tile loop, so device
// memory sees only their packed bytes. K17 and K8, the same product over
// int8 weights, are in int8_matmul.cu; quant_mma.cuh holds what the two
// files share.
//
// Bound: at the encoder's 1500 rows the operations (2 M N K), at a few
// decode rows the weight bytes.
//
// K18, redesigned for the H100, all on the tensor cores, f32 x as three
// bf16 terms whose sum is x (each multiplied by the exactly widened
// weight into the same f32 sums). Every nibble is
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
// - M > 16 (the encoder, the cross K/V, a long prompt): int4_mma_kernel,
//   operations-bound: a 128 x 128 output tile, 8 warps, 64-deep slices, a
//   3-stage ring of 16-byte cp.async copies of x's tile and of the packed
//   tile (a quarter of the bf16 tile's bytes). The block widens the next
//   slice's packed tile into a bf16 [k][n] tile (16 bytes of a row become
//   32 values, four 16-byte stores; two tiles, so one barrier a slice)
//   while it multiplies this one: B from ldmatrix.x4.trans on the widened
//   tile, padded row strides keeping the loads free of bank conflicts; the
//   per-column scale and paired stores in the epilogue. x's side is K17's
//   (quant_mma.cuh): bf16 by ldmatrix.x4, warps of 64 x 32, two blocks an
//   SM; f32 split into three terms as each A fragment is built, warps of
//   32 x 64, three products a fragment pair summed apart and added to the
//   running sum once a step, one block an SM.
//
// Ragged M, N and K edges are masked, so every shape is taken; rows whose
// addresses are not 16-byte aligned take the kernels' byte-wise loads.
#include "quant_mma.cuh"
#include "cp_async.cuh"

#include <cooperative_groups.h>

namespace wa {
namespace {

namespace cg = cooperative_groups;

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
// K18, M > 16: 128 x 128 tiles (x's side in quant_mma.cuh)
// --------------------------------------------------------------------------

constexpr int T4_PB = TM_BN / 2;        // packed bytes of a tile row

// dynamic shared memory: bf16 x 102400 bytes (two blocks an SM), f32 x
// 157696 (one)
template <typename XT>
struct T4Smem {
    XT xs[TM_STAGES][TM_BM][TM_XLD];
    uint8_t wp[TM_STAGES][TM_BK][T4_PB];
    __nv_bfloat16 wt[2][TM_BK][TM_WLD];     // [k][n], two slices
};

// stage the slice at k0 of x's tile and of the packed tile: 16-byte
// cp.async copies (zero-filled past M, K and the row), or, when rows are
// not 16-byte aligned, element loads
template <typename XT, bool ALIGNED>
__device__ __forceinline__ void t4_stage(
        T4Smem<XT>& s, int st, const XT* __restrict__ x,
        const uint8_t* __restrict__ w, int M, int K, int N, int m0, int n0,
        int k0, int tid) {
    const int rowb = N / 2;
    tile_stage_x<XT, ALIGNED>(s.xs[st], x, M, K, m0, k0, tid);
    if (ALIGNED) {
#pragma unroll
        for (int e = tid; e < TM_BK * (T4_PB / 16); e += TM_THREADS) {
            const int r = e / (T4_PB / 16), c = 16 * (e % (T4_PB / 16));
            const bool ok = k0 + r < K && n0 / 2 + c < rowb;
            cp_async16(&s.wp[st][r][c],
                       ok ? w + (size_t)(k0 + r) * rowb + n0 / 2 + c : w,
                       ok ? 16 : 0);
        }
        return;
    }
    for (int e = tid; e < TM_BK * T4_PB; e += TM_THREADS) {
        const int r = e / T4_PB, c = e % T4_PB;
        s.wp[st][r][c] = k0 + r < K && n0 / 2 + c < rowb
            ? w[(size_t)(k0 + r) * rowb + n0 / 2 + c] : (uint8_t)0;
    }
}

// widen stage st's packed slice into wt[buf]: each thread 16 bytes of a
// row, 32 bf16 values, four 16-byte stores
template <typename XT>
__device__ __forceinline__ void t4_widen(T4Smem<XT>& s, int st, int buf,
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
template <typename XT, bool ALIGNED>
__global__ void __launch_bounds__(TM_THREADS, TileX<XT>::BLOCKS)
int4_mma_kernel(
        const XT* __restrict__ x, const uint8_t* __restrict__ w,
        const float* __restrict__ scale, int n_scale, XT* __restrict__ y,
        int M, int K, int N) {
    static_assert(TM_THREADS == TM_BK * (T4_PB / 16), "one vector each");
    using TX = TileX<XT>;
    constexpr int I = TX::WM / 16, J = TX::WN / 8, WC = TM_BN / TX::WN;
    extern __shared__ __align__(16) unsigned char t4_smem[];
    T4Smem<XT>& s = *reinterpret_cast<T4Smem<XT>*>(t4_smem);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int wm = (warp / WC) * TX::WM, wn = (warp % WC) * TX::WN;
    const int m0 = blockIdx.y * TM_BM, n0 = blockIdx.x * TM_BN;
    const int nk = (K + TM_BK - 1) / TM_BK;
    float acc[I][J][4];
#pragma unroll
    for (int i = 0; i < I; ++i)
#pragma unroll
        for (int j = 0; j < J; ++j)
            acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
    t4_stage<XT, ALIGNED>(s, 0, x, w, M, K, N, m0, n0, 0, tid);
    cp_async_commit();
    if (nk > 1)
        t4_stage<XT, ALIGNED>(s, 1, x, w, M, K, N, m0, n0, TM_BK, tid);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    t4_widen(s, 0, 0, tid);
    for (int it = 0; it < nk; ++it) {
        const int st = it % TM_STAGES, buf = it & 1;
        cp_async_wait<0>();
        __syncthreads();
        if (it + 2 < nk)
            t4_stage<XT, ALIGNED>(s, (it + 2) % TM_STAGES, x, w, M, K, N, m0,
                                  n0, (it + 2) * TM_BK, tid);
        cp_async_commit();
        if (it + 1 < nk) t4_widen(s, (it + 1) % TM_STAGES, buf ^ 1, tid);
#pragma unroll
        for (int kc = 0; kc < TM_BK / 16; ++kc)
            tile_step<XT>(acc, s.xs[st], s.wt[buf], wm, wn, kc, lane);
    }
    tile_store<XT>(acc, scale, n_scale, y, M, N, m0 + wm, n0 + wn, lane);
}

template <typename XT>
int launch_int4(const void* x, const uint8_t* w, const float* scale,
                int n_scale, void* y, int M, int K, int N, int n_split,
                int split_rows, int* tile, cudaStream_t st) {
    const int rowb = N / 2;
    if (tile != nullptr) *tile = M > 16;
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
    const bool al = tile_x_aligned<XT>(x, K)
                    && reinterpret_cast<uintptr_t>(w) % 16 == 0
                    && rowb % 16 == 0;
    const dim3 grid((N + TM_BN - 1) / TM_BN, (M + TM_BM - 1) / TM_BM);
    const auto kernel = al ? int4_mma_kernel<XT, true>
                           : int4_mma_kernel<XT, false>;
    const int smem = (int)sizeof(T4Smem<XT>);
    static bool opted_in[2] = {false, false};   // once per kernel
    if (!opted_in[al]) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
        opted_in[al] = true;
    }
    kernel<<<grid, TM_THREADS, smem, st>>>(static_cast<const XT*>(x), w,
                                           scale, n_scale,
                                           static_cast<XT*>(y), M, K, N);
    return (int)cudaGetLastError();
}

int dispatch_int4(const void* x, int dtype, int M, int K, const uint8_t* w,
                  int N, const float* scale, int n_scale, void* y,
                  int n_split, int split_rows, int* tile, void* stream) {
    if (M < 1 || K < 1 || N < 2 || N % 2 || n_scale < 1
            || (M + TM_BM - 1) / TM_BM > 65535)
        return ERR_SHAPE;
    auto st = static_cast<cudaStream_t>(stream);
    if (dtype == F32)
        return launch_int4<float>(x, w, scale, n_scale, y, M, K, N, n_split,
                                  split_rows, tile, st);
    if (dtype == BF16)
        return launch_int4<__nv_bfloat16>(x, w, scale, n_scale, y, M, K, N,
                                          n_split, split_rows, tile, st);
    return ERR_DTYPE;
}

}  // namespace
}  // namespace wa

// K18: x [M, K], wq [K, N / 2] packed int4 bytes (N even: both nibbles of
// every byte), scale [n_scale] f32, y [M, N] in x's dtype. For M <= 16
// the caller's plan (ops/int4_matmul.int4_plan): n_split blocks over K
// (at most 16: one cluster), each split_rows rows (a multiple of 16);
// for M > 16, n_split 1. No scratch. *tile (unless null) is set to 1
// where the launch is the tile kernel's (M > 16), else 0.
extern "C" int wa_int4_matmul(const void* x, int dtype, int M, int K,
                              const int8_t* wq, int N, const float* scale,
                              int n_scale, void* y, int n_split,
                              int split_rows, int* tile, void* stream) {
    return wa::dispatch_int4(x, dtype, M, K,
                             reinterpret_cast<const uint8_t*>(wq), N, scale,
                             n_scale, y, n_split, split_rows, tile, stream);
}
