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
// work.
//
// What bounds them on the card: the weight bytes of one layer (0.75 a
// weight for Q4_K, 1.25 for Q5_K and Q6_K: large-v3's fc1 [1280, 5120] is
// 4.9 MB in Q4_K, 8.2 MB in Q5_K), read once per call; two flops a weight
// per row. The entry takes M <= 32 and the wrapper launches once per
// 32-row chunk.
//
// K11 (Q5_K, Q6_K): the CUDA-core reader of kquant.cuh over row tiles of
// 1, 4 or 8 rows (the smallest that holds M; M > 8 reads the weights once
// per 8 rows).
//
// K10 (Q4_K), on the tensor cores: q4k_mv_mma_kernel, the decode-row design
// of K8 and K18 (int8_matmul.cu, dequant_matmul.cu). y^T = W^T x^T by
// mma.sync m16n8k16: the weights are A (16 output columns by 16 K values),
// x is B in NT tiles of 8 rows. A Q4_K byte holds K values 2r and 2r + 1
// of one column, exactly the pair one A register holds for one row of the
// fragment, so each byte becomes one bf16x2 register without an int ->
// float convert (a quarter of the FMA rate): the nibbles go into the
// mantissa of 128 (0x4300 | q) and 128 is taken off both halves, exactly.
// A block owns a strip of 128 columns (8 vectors of 16 bytes) and a range
// of whole 32-groups of K; warp w takes groups w, w + 8, .., lane (g, t)
// reading byte rows t, t + 4, t + 8, t + 12 of the group at vector g (16
// bytes each, ld.global.nc.v4) and its x pairs (as K8 reads them), the
// next group's weights, x and scales in flight while it multiplies this
// one's (measured faster than two groups ahead, PERF.md). A group is two
// k16 steps into a fresh accumulator p, then acc += S[g, n] p - Z[g, n]
// sum(x[m, g]); sum(x) comes from the same B fragments times an A of
// ones (two more products a group), in registers where the lane needs it:
// measured faster on the H100 than staging x and its group sums in shared
// memory (PERF.md). f32 x is fed as three bf16 terms whose sum is x
// (x_terms), so each product is exact and the sums are f32. The warps'
// sums meet in shared memory in warp order; K is split over a thread
// block cluster in whole groups (ops/q4k.q4k_plan: power-of-2 clusters,
// at most 120 blocks, a block holding its SM at 200+ registers a thread)
// and the splits are summed through distributed shared memory in split
// order: one launch, no scratch, the same bits every run.
#include "kquant.cuh"
#include "quant_mma.cuh"

#include <cooperative_groups.h>

namespace wa {
namespace {

namespace cg = cooperative_groups;

constexpr int K4_VECS = 8;                  // 16-byte vectors a block row
constexpr int K4_STRIP = 16 * K4_VECS;      // output columns a block owns
constexpr int K4_W = 8;                     // warps a block
constexpr int K4_THREADS = 32 * K4_W;
constexpr int K4_GROUP = 32;                // K values a Q4_K group
constexpr int K4_RS = K4_VECS * 17;         // a slot's row: padded vectors
constexpr int K4_MAX_SPLIT = 16;            // blocks of a cluster
static_assert(K4_THREADS >= K4_STRIP, "a column a thread in the epilogue");

// byte b of w (a word of Q4_K bytes; w4 = w >> 4) as the bf16 pair (low
// nibble, high nibble): the two nibbles in the mantissa of 128, then 128
// off both halves; exact
__device__ __forceinline__ uint32_t nib_pair(uint32_t w, uint32_t w4, int b) {
    const uint32_t v = (__byte_perm(w, w4, b | ((4 + b) << 8)) & 0x000F000Fu)
        | 0x43004300u;
    const uint32_t c128 = 0x43004300u;
    const __nv_bfloat162 d = __hsub2(
        *reinterpret_cast<const __nv_bfloat162*>(&v),
        *reinterpret_cast<const __nv_bfloat162*>(&c128));
    return *reinterpret_cast<const uint32_t*>(&d);
}

// one of the 16 floats of a float4[4], index i known at compile time
__device__ __forceinline__ float f16at(const float4 (&v)[4], int i) {
    const float4 q = v[i / 4];
    return i % 4 == 0 ? q.x : i % 4 == 1 ? q.y : i % 4 == 2 ? q.z : q.w;
}

// the floats of a block's shared memory: the warps' slots [K4_W][M][K4_RS]
// and, with split K, every split's share of the block's outputs
__host__ __device__ inline int q4k_smem_floats(int M, int n_split) {
    const int total = M * K4_STRIP;
    return K4_W * M * K4_RS
        + (n_split > 1 ? n_split * ((total + n_split - 1) / n_split) : 0);
}

// see above; grid (ceil(N / 128), n_split), clusters (1, n_split, 1)
template <typename XT, int NT>
__global__ void __launch_bounds__(K4_THREADS) q4k_mv_mma_kernel(
        const XT* __restrict__ x, const uint8_t* __restrict__ w,
        const float* __restrict__ sc, const float* __restrict__ zr,
        XT* __restrict__ y, int M, int K, int N, int split_rows) {
    constexpr int TERMS = std::is_same<XT, float>::value ? 3 : 1;
    // the next group's weights, x and (PRE, as registers allow) scales
    // are fetched while this group's products run
    constexpr bool PRE = NT <= 2;
    extern __shared__ __align__(16) float k4_smem[];
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int vec = blockIdx.x * K4_VECS + g;
    const bool active = vec < N / 16;
    const int n_split = gridDim.y;
    // the cluster's first barrier phase: every block has started before
    // any stores into another's shared memory (waited on below)
    if (n_split > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;");
    const int k0 = blockIdx.y * split_rows;
    const int kend = min(K, k0 + split_rows);
    const int groups = (kend - k0) / K4_GROUP;

    // group gi's byte rows t, t + 4, t + 8, t + 12 at vector g (zero past
    // the block's groups or N)
    const auto fetch_w = [&](int gi, uint4 (&q)[4]) {
        const int br = k0 / 2 + 16 * gi;    // the group's first byte row
#pragma unroll
        for (int i = 0; i < 4; ++i)
            q[i] = active && gi < groups
                ? __ldg(reinterpret_cast<const uint4*>(
                      w + (size_t)(br + 4 * i + t) * N + 16 * vec))
                : make_uint4(0u, 0u, 0u, 0u);
    };
    // its scales and zeros of vector g's 16 columns
    const auto fetch_sz = [&](int gi, float4 (&S)[4], float4 (&Z)[4]) {
        const size_t o = (size_t)(k0 / K4_GROUP + gi) * N + 16 * vec;
        const bool in = active && gi < groups;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            S[i] = in ? __ldg(reinterpret_cast<const float4*>(sc + o) + i)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
            Z[i] = in ? __ldg(reinterpret_cast<const float4*>(zr + o) + i)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
        }
    };
    // its x pairs: rows 8 nt + g, K 2t (+ 8) of each k16 step (zero past M
    // and the block's groups)
    const auto fetch_x = [&](int gi, XPair<XT> (&xq)[2][NT][2]) {
        const int kb = k0 + K4_GROUP * gi;
        const int ke = gi < groups ? kend : kb;
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                    xq[s][nt][h] = x_pair<XT>(x, M, K, ke, 8 * nt + g,
                                              kb + 16 * s + 2 * t + 8 * h);
    };
    uint4 qn[4];
    float4 Sn[4], Zn[4];
    XPair<XT> xn[2][NT][2];
    fetch_w(warp, qn);
    if constexpr (PRE) fetch_sz(warp, Sn, Zn);
    fetch_x(warp, xn);

    float acc[NT][8][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 8; ++j)
            acc[nt][j][0] = acc[nt][j][1] = acc[nt][j][2] = acc[nt][j][3] =
                0.f;
    for (int gi = warp; gi < groups; gi += K4_W) {
        uint32_t r[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            r[i][0] = qn[i].x; r[i][1] = qn[i].y;
            r[i][2] = qn[i].z; r[i][3] = qn[i].w;
        }
        float4 S[4], Z[4];
        uint32_t b[2][NT][2][TERMS];        // x as B fragments
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int h = 0; h < 2; ++h) x_terms(xn[s][nt][h], b[s][nt][h]);
        if constexpr (PRE) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                S[i] = Sn[i];
                Z[i] = Zn[i];
            }
            fetch_sz(gi + K4_W, Sn, Zn);
        }
        fetch_w(gi + K4_W, qn);
        fetch_x(gi + K4_W, xn);
        if constexpr (!PRE) fetch_sz(gi, S, Z);
        // sum(x) of rows 8 nt + 2t (+1) over the group: the same product
        // against ones (every A row the sum of the x row)
        float xsm[NT][2];
        const uint32_t ones[4] = {0x3F803F80u, 0x3F803F80u, 0x3F803F80u,
                                  0x3F803F80u};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            float cs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int s = 0; s < 2; ++s)
#pragma unroll
                for (int i = 0; i < TERMS; ++i)
                    mma_bf16(cs, ones, b[s][nt][0][i], b[s][nt][1][i]);
            xsm[nt][0] = cs[0];
            xsm[nt][1] = cs[1];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            // bytes 2j (A rows g: column 2j of vector g) and 2j + 1 (rows
            // g + 8) of byte rows t and t + 4 (step 0) or t + 8 and t + 12
            // (step 1): K 2t, 2t + 1 and 2t + 8, 2t + 9 of the step
            const int wd = j / 2, b0 = 2 * (j % 2), b1 = b0 + 1;
            float c[NT][4];
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
                c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
            for (int s = 0; s < 2; ++s) {
                const uint32_t lo = r[2 * s][wd], hi = r[2 * s + 1][wd];
                const uint32_t a[4] = {nib_pair(lo, lo >> 4, b0),
                                       nib_pair(lo, lo >> 4, b1),
                                       nib_pair(hi, hi >> 4, b0),
                                       nib_pair(hi, hi >> 4, b1)};
#pragma unroll
                for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                    for (int i = 0; i < TERMS; ++i)
                        mma_bf16(c[nt], a, b[s][nt][0][i], b[s][nt][1][i]);
            }
            // the group's scale and zero of columns 2j (c0, c1) and 2j + 1
            // (c2, c3), against rows 2t (c0, c2) and 2t + 1 (c1, c3)
            const float s0 = f16at(S, 2 * j), s1 = f16at(S, 2 * j + 1);
            const float z0 = f16at(Z, 2 * j), z1 = f16at(Z, 2 * j + 1);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                acc[nt][j][0] += s0 * c[nt][0] - z0 * xsm[nt][0];
                acc[nt][j][1] += s0 * c[nt][1] - z0 * xsm[nt][1];
                acc[nt][j][2] += s1 * c[nt][2] - z1 * xsm[nt][0];
                acc[nt][j][3] += s1 * c[nt][3] - z1 * xsm[nt][1];
            }
        }
    }

    // lane (g, t) holds rows 8 nt + 2t (+1) of columns 16 g + 2j (+1); a
    // slot is [M rows][8 vectors of 17]. Warps past the block's groups
    // hold nothing.
    const int busy = min(K4_W, groups);
    const int total = M * K4_STRIP;
    const int chunk = (total + n_split - 1) / n_split;
    float* sums = k4_smem + K4_W * M * K4_RS;      // [split][chunk]
    float* slot = k4_smem + warp * M * K4_RS + 17 * g;
#pragma unroll
    for (int nt = 0; nt < NT && warp < busy; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int m = 8 * nt + 2 * t + (e & 1);
            if (m < M) {
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    slot[m * K4_RS + 2 * j + (e >> 1)] = acc[nt][j][e];
            }
        }
    __syncthreads();
    if (n_split > 1) asm volatile("barrier.cluster.wait.aligned;");

    // the slots summed in order; with split K, split b stores its sums of
    // outputs [r C, (r + 1) C) into block r's shared memory, and after
    // the cluster's barrier block r sums them in split order
    for (int e = tid; e < total; e += K4_THREADS) {
        const int m = e / K4_STRIP, n = e % K4_STRIP;
        const float* s = k4_smem + m * K4_RS + 17 * (n / 16) + n % 16;
        float v = s[0];
#pragma unroll
        for (int i = 1; i < K4_W; ++i)
            if (i < busy) v += s[i * M * K4_RS];
        const int gn = blockIdx.x * K4_STRIP + n;
        if (n_split > 1) {
            const int rr = e / chunk;
            cg::this_cluster().map_shared_rank(sums, rr)[
                blockIdx.y * chunk + e - rr * chunk] = v;
        } else if (gn < N) {
            y[(size_t)m * N + gn] = from_f32<XT>(v);
        }
    }
    if (n_split == 1) return;
    cg::this_cluster().sync();      // every split's sums have arrived
    for (int i = tid; i < chunk; i += K4_THREADS) {
        const int e = blockIdx.y * chunk + i;
        if (e >= total) break;
        float a[K4_MAX_SPLIT];
#pragma unroll
        for (int sp = 0; sp < K4_MAX_SPLIT; ++sp)
            a[sp] = sp < n_split ? sums[sp * chunk + i] : 0.f;
        float v = a[0];
#pragma unroll
        for (int sp = 1; sp < K4_MAX_SPLIT; ++sp)
            if (sp < n_split) v += a[sp];
        const int gn = blockIdx.x * K4_STRIP + e % K4_STRIP;
        if (gn < N) y[(size_t)(e / K4_STRIP) * N + gn] = from_f32<XT>(v);
    }
}

template <typename XT, int NT>
int launch_q4k(const void* x, const uint8_t* w, const float* sc,
               const float* zr, void* y, int M, int K, int N, int n_split,
               int split_rows, cudaStream_t st) {
    const auto kernel = q4k_mv_mma_kernel<XT, NT>;
    const int smem = 4 * q4k_smem_floats(M, n_split);
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
    cfg.gridDim = dim3((N + K4_STRIP - 1) / K4_STRIP, n_split);
    cfg.blockDim = dim3(K4_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = 1;
    cluster[0].val.clusterDim.y = n_split;
    cluster[0].val.clusterDim.z = 1;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, kernel, static_cast<const XT*>(x), w, sc, zr,
        static_cast<XT*>(y), M, K, N, split_rows);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// K10 for M <= 32 rows: NT = ceil(M / 8) tiles of 8 rows, n_split blocks
// of split_rows K rows (whole groups, none empty) a strip
template <typename XT>
int q4k_rows(const void* x, const uint8_t* w, const float* sc,
             const float* zr, void* y, int M, int K, int N, int n_split,
             int split_rows, cudaStream_t st) {
    const uintptr_t bases = reinterpret_cast<uintptr_t>(w)
        | reinterpret_cast<uintptr_t>(sc) | reinterpret_cast<uintptr_t>(zr);
    if (n_split < 1 || n_split > K4_MAX_SPLIT || split_rows < K4_GROUP
            || split_rows % K4_GROUP || (long long)n_split * split_rows < K
            || (long long)(n_split - 1) * split_rows >= K || bases % 16
            || 4 * q4k_smem_floats(M, n_split) > 227 * 1024)
        return ERR_SHAPE;
#define WA_Q4K(NT)                                                           \
    launch_q4k<XT, NT>(x, w, sc, zr, y, M, K, N, n_split, split_rows, st)
    if (M <= 8) return WA_Q4K(1);
    if (M <= 16) return WA_Q4K(2);
    if (M <= 24) return WA_Q4K(3);
    return WA_Q4K(4);
#undef WA_Q4K
}

}  // namespace
}  // namespace wa

using namespace wa;

// x [M, K] f32 or bf16; fmt KQ_Q4K (wq [K/2, N]), KQ_Q5K or KQ_Q6K
// (wq [K, N]); sc and zr [K/sub, N] f32 (zr null for Q6_K), all at the
// layer; out [M, N] in x's dtype. Q4_K takes n_split blocks of split_rows
// K rows a strip (ops/q4k.q4k_plan); Q5_K and Q6_K ignore them.
extern "C" int wa_kq_matvec(const void* x, int x_dtype, int M, int K,
                            int fmt, const void* wq, int N, const void* sc,
                            const void* zr, void* out, int n_split,
                            int split_rows, void* stream) {
    if (!kq_shape_ok(fmt, K, N) || M < 1 || M > KQ_MAX_B) return ERR_SHAPE;
    if ((fmt == KQ_Q6K) != (zr == nullptr)) return ERR_DTYPE;
    if (x_dtype != F32 && x_dtype != BF16) return ERR_DTYPE;
    const bool f32 = x_dtype == F32;
    auto st = static_cast<cudaStream_t>(stream);
    return (int)with_kq_fmt(fmt, [&](auto f) -> cudaError_t {
        constexpr int FMT = decltype(f)::value;
        const auto w = static_cast<const int8_t*>(wq);
        const auto s = static_cast<const float*>(sc);
        const auto z = static_cast<const float*>(zr);
        if constexpr (FMT == KQ_Q4K) {
            const auto wb = reinterpret_cast<const uint8_t*>(w);
            return (cudaError_t)(
                f32 ? q4k_rows<float>(x, wb, s, z, out, M, K, N, n_split,
                                      split_rows, st)
                    : q4k_rows<__nv_bfloat16>(x, wb, s, z, out, M, K, N,
                                              n_split, split_rows, st));
        } else {
            return f32 ? launch_kq<FMT, float, float>(x, M, K, N, w, s, z,
                                                       out, st)
                       : launch_kq<FMT, __nv_bfloat16, __nv_bfloat16>(
                             x, M, K, N, w, s, z, out, st);
        }
    });
}


