// K10 q4k_matvec_stacked and K11 kq_matvec_stacked: y [M, N] = x [M, K]
// @ one layer of a planar k-quant weight stack.
//
// Replace the Pallas kernels of whisper_apr_tpu/ops/q4k.py
// (q4k_matvec_stacked/_q4k_kernel) and whisper_apr_tpu/ops/kquants.py
// (kq_matvec_stacked/_kq_kernel_asym, _kq_kernel_sym) and compute what they
// compute: per 32-group (16 for Q6_K) S * sum(x q) - Z * sum(x) (no zero
// term for Q6_K), with f32 accumulation, the group sums of x in f32 from x
// as given, and the output rounded to x's dtype. The TPU kernels expand x
// block-diagonally over the groups so that the partial dots become
// matrix-unit products, and optionally split Q4_K's nibbles algebraically
// to spare vector-unit work.
//
// What bounds them on the card: the weight bytes of one layer (0.75 a
// weight for Q4_K, 1.25 for Q5_K and Q6_K: large-v3's fc1 [1280, 5120] is
// 4.9 MB in Q4_K, 8.2 MB in Q5_K), read once per call; two flops a weight
// per row. The entry takes M <= 32 and the wrapper launches once per
// 32-row chunk.
//
// One kernel for the three formats, kq_mv_mma_kernel<FMT>, the decode-row
// design of K8 and K18 (int8_matmul.cu, dequant_matmul.cu), on the tensor
// cores. y^T = W^T x^T by mma.sync m16n8k16: the weights are A (16 output
// columns by 16 K values), x is B in NT = ceil(M / 8) tiles of 8 rows, so
// each weight byte is read once for every row of the chunk. A block owns
// a strip of 128 columns (8 vectors of 16 bytes) and a range of whole
// groups of K; warp w takes groups w, w + 8, .., lane (g, t) reading
// 16-byte vectors (ld.global.nc.v4) at vector g and its x pairs (as K8
// reads them), the next group's weights, x and scales in flight while it
// multiplies this one's (measured faster than two groups ahead, PERF.md).
// Each A register, one bf16 pair of K values 2t, 2t + 1 (or 2t + 8,
// 2t + 9) of one column, is made without an int -> float convert (a
// quarter of the FMA rate), exactly:
// - Q4_K: byte row r holds K values 2r and 2r + 1 of one column, exactly
//   the pair a register holds: lane (g, t) reads byte rows t, t + 4, t + 8,
//   t + 12 of the group, and the two nibbles go into the mantissa of 128
//   (0x4300 | q), 128 taken off both halves (nib_pair);
// - Q5_K, Q6_K: one value a byte; lane (g, t) reads value rows 2t, 2t + 1,
//   2t + 8, 2t + 9 of each k16 step, as K8 reads its [K, N] int8 weights,
//   and a byte permute pairs byte b of the even row with byte b of the odd
//   row; Q5_K's 0..31 goes into the mantissa of 128 as Q4_K's nibbles do,
//   Q6_K's -32..31 biased by 32 (bits 0-5 with bit 5 flipped) into that of
//   160, and 128 or 160 is taken off both halves (kq_pair).
// A group is its k16 steps (two, or one for Q6_K) into a fresh
// accumulator p, then acc += S[g, n] p - Z[g, n] sum(x[m, g]); sum(x)
// comes from the same B fragments times an A of ones (two more products a
// group; Q6_K has no zero and skips them), in registers where the lane
// needs it: measured faster on the H100 than staging x and its group sums
// in shared memory (PERF.md). f32 x is fed as three bf16 terms whose sum
// is x (x_terms), so each product is exact and the sums are f32. The
// warps' sums meet in shared memory in warp order; K is split over a
// thread block cluster in whole groups (ops/q4k.kq_plan: power-of-2
// clusters, at most 120 blocks, a block holding its SM at 200+ registers
// a thread) and the splits are summed through distributed shared memory
// in split order: one launch, no scratch, the same bits every run.
#include "kquant.cuh"
#include "quant_mma.cuh"

#include <cooperative_groups.h>

namespace wa {
namespace {

namespace cg = cooperative_groups;

constexpr int KM_VECS = 8;                  // 16-byte vectors a block row
constexpr int KM_STRIP = 16 * KM_VECS;      // output columns a block owns
constexpr int KM_W = 8;                     // warps a block
constexpr int KM_THREADS = 32 * KM_W;
constexpr int KM_RS = KM_VECS * 17;         // a slot's row: padded vectors
constexpr int KM_MAX_SPLIT = 16;            // blocks of a cluster
constexpr int KM_MAX_M = 32;                // rows a launch takes
static_assert(KM_THREADS >= KM_STRIP, "a column a thread in the epilogue");

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

// byte b of e and of o (words of the Q5_K or Q6_K values of an even and
// the next odd K row) as the bf16 pair (e's, o's). Q5_K's 0..31 as the
// mantissa of 128 (0x4300 | q); Q6_K's -32..31 as its low 6 bits with bit
// 5 flipped, q + 32 in 0..63, in the mantissa of 128: 160 + q. Then 128
// (Q5_K) or 160 (Q6_K) off both halves; exact
template <int FMT>
__device__ __forceinline__ uint32_t kq_pair(uint32_t e, uint32_t o, int b) {
    static_assert(FMT == KQ_Q5K || FMT == KQ_Q6K, "one value a byte");
    constexpr uint32_t MASK = FMT == KQ_Q5K ? 0x007F007Fu : 0x003F003Fu;
    constexpr uint32_t BIAS = FMT == KQ_Q5K ? 0x43004300u : 0x43204320u;
    const uint32_t v = (__byte_perm(e, o, b | ((4 + b) << 8)) & MASK) ^ BIAS;
    const uint32_t c = BIAS;
    const __nv_bfloat162 d = __hsub2(
        *reinterpret_cast<const __nv_bfloat162*>(&v),
        *reinterpret_cast<const __nv_bfloat162*>(&c));
    return *reinterpret_cast<const uint32_t*>(&d);
}

// one of the 16 floats of a float4[4], index i known at compile time
__device__ __forceinline__ float f16at(const float4 (&v)[4], int i) {
    const float4 q = v[i / 4];
    return i % 4 == 0 ? q.x : i % 4 == 1 ? q.y : i % 4 == 2 ? q.z : q.w;
}

// the floats of a block's shared memory: the warps' slots [KM_W][M][KM_RS]
// and, with split K, every split's share of the block's outputs
__host__ __device__ inline int kq_smem_floats(int M, int n_split) {
    const int total = M * KM_STRIP;
    return KM_W * M * KM_RS
        + (n_split > 1 ? n_split * ((total + n_split - 1) / n_split) : 0);
}

// see above; grid (ceil(N / 128), n_split), clusters (1, n_split, 1)
template <int FMT, typename XT, int NT>
__global__ void __launch_bounds__(KM_THREADS) kq_mv_mma_kernel(
        const XT* __restrict__ x, const uint8_t* __restrict__ w,
        const float* __restrict__ sc, const float* __restrict__ zr,
        XT* __restrict__ y, int M, int K, int N, int split_rows) {
    constexpr int TERMS = std::is_same<XT, float>::value ? 3 : 1;
    constexpr int SUB = KqTraits<FMT>::SUB;
    constexpr bool ZERO = KqTraits<FMT>::ZERO;
    constexpr int STEPS = SUB / 16;             // k16 steps a group
    // 16-byte weight vectors a lane reads a group: Q4_K's 16 byte rows
    // hold 32 values, Q5_K's 32 rows and Q6_K's 16 one each
    constexpr int NQ = FMT == KQ_Q5K ? 8 : 4;
    constexpr int NZ = ZERO ? 4 : 1;
    // the next group's weights, x and (PRE, as registers allow) scales
    // are fetched while this group's products run
    constexpr bool PRE = FMT == KQ_Q5K ? NT == 1 : NT <= 2;
    extern __shared__ __align__(16) float km_smem[];
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int vec = blockIdx.x * KM_VECS + g;
    const bool active = vec < N / 16;
    const int n_split = gridDim.y;
    // the cluster's first barrier phase: every block has started before
    // any stores into another's shared memory (waited on below)
    if (n_split > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;");
    const int k0 = blockIdx.y * split_rows;
    const int kend = min(K, k0 + split_rows);
    const int groups = (kend - k0) / SUB;

    // group gi's vectors at vector g (zero past the block's groups or N):
    // Q4_K byte rows t, t + 4, t + 8, t + 12; Q5_K, Q6_K value rows 2t,
    // 2t + 1, 2t + 8, 2t + 9 of each k16 step
    const auto fetch_w = [&](int gi, uint4 (&q)[NQ]) {
        const bool in = active && gi < groups;
#pragma unroll
        for (int i = 0; i < NQ; ++i) {
            const int row = FMT == KQ_Q4K
                ? k0 / 2 + 16 * gi + 4 * i + t
                : k0 + SUB * gi + 16 * (i / 4) + 2 * t + (i & 1)
                      + 8 * ((i >> 1) & 1);
            q[i] = in ? __ldg(reinterpret_cast<const uint4*>(
                            w + (size_t)row * N + 16 * vec))
                      : make_uint4(0u, 0u, 0u, 0u);
        }
    };
    // its scales (and zeros) of vector g's 16 columns
    const auto fetch_sz = [&](int gi, float4 (&S)[4], float4 (&Z)[NZ]) {
        const size_t o = (size_t)(k0 / SUB + gi) * N + 16 * vec;
        const bool in = active && gi < groups;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            S[i] = in ? __ldg(reinterpret_cast<const float4*>(sc + o) + i)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
            if constexpr (ZERO)
                Z[i] = in ? __ldg(reinterpret_cast<const float4*>(zr + o) + i)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
        }
    };
    // its x pairs: rows 8 nt + g, K 2t (+ 8) of each k16 step (zero past M
    // and the block's groups)
    const auto fetch_x = [&](int gi, XPair<XT> (&xq)[STEPS][NT][2]) {
        const int kb = k0 + SUB * gi;
        const int ke = gi < groups ? kend : kb;
#pragma unroll
        for (int s = 0; s < STEPS; ++s)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                    xq[s][nt][h] = x_pair<XT>(x, M, K, ke, 8 * nt + g,
                                              kb + 16 * s + 2 * t + 8 * h);
    };
    uint4 qn[NQ];
    float4 Sn[4], Zn[NZ];
    XPair<XT> xn[STEPS][NT][2];
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
    for (int gi = warp; gi < groups; gi += KM_W) {
        uint32_t r[NQ][4];
#pragma unroll
        for (int i = 0; i < NQ; ++i) {
            r[i][0] = qn[i].x; r[i][1] = qn[i].y;
            r[i][2] = qn[i].z; r[i][3] = qn[i].w;
        }
        float4 S[4], Z[NZ];
        uint32_t b[STEPS][NT][2][TERMS];    // x as B fragments
#pragma unroll
        for (int s = 0; s < STEPS; ++s)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int h = 0; h < 2; ++h) x_terms(xn[s][nt][h], b[s][nt][h]);
        if constexpr (PRE) {
#pragma unroll
            for (int i = 0; i < 4; ++i) S[i] = Sn[i];
#pragma unroll
            for (int i = 0; i < NZ; ++i) Z[i] = Zn[i];
            fetch_sz(gi + KM_W, Sn, Zn);
        }
        fetch_w(gi + KM_W, qn);
        fetch_x(gi + KM_W, xn);
        if constexpr (!PRE) fetch_sz(gi, S, Z);
        // sum(x) of rows 8 nt + 2t (+1) over the group: the same product
        // against ones (every A row the sum of the x row)
        float xsm[NT][2];
        if constexpr (ZERO) {
            const uint32_t ones[4] = {0x3F803F80u, 0x3F803F80u, 0x3F803F80u,
                                      0x3F803F80u};
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                float cs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
                for (int s = 0; s < STEPS; ++s)
#pragma unroll
                    for (int i = 0; i < TERMS; ++i)
                        mma_bf16(cs, ones, b[s][nt][0][i], b[s][nt][1][i]);
                xsm[nt][0] = cs[0];
                xsm[nt][1] = cs[1];
            }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            // A rows g: column 2j of vector g, rows g + 8: column 2j + 1
            // (bytes 2j and 2j + 1 of a Q5_K / Q6_K row; Q4_K: of byte
            // rows t and t + 4, step 0, or t + 8 and t + 12, step 1); K
            // 2t, 2t + 1 (a0, a1) and 2t + 8, 2t + 9 (a2, a3) of the step
            const int wd = j / 2, b0 = 2 * (j % 2), b1 = b0 + 1;
            float c[NT][4];
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
                c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
            for (int s = 0; s < STEPS; ++s) {
                uint32_t a[4];
                if constexpr (FMT == KQ_Q4K) {
                    const uint32_t lo = r[2 * s][wd], hi = r[2 * s + 1][wd];
                    a[0] = nib_pair(lo, lo >> 4, b0);
                    a[1] = nib_pair(lo, lo >> 4, b1);
                    a[2] = nib_pair(hi, hi >> 4, b0);
                    a[3] = nib_pair(hi, hi >> 4, b1);
                } else {
                    a[0] = kq_pair<FMT>(r[4 * s][wd], r[4 * s + 1][wd], b0);
                    a[1] = kq_pair<FMT>(r[4 * s][wd], r[4 * s + 1][wd], b1);
                    a[2] = kq_pair<FMT>(r[4 * s + 2][wd], r[4 * s + 3][wd],
                                        b0);
                    a[3] = kq_pair<FMT>(r[4 * s + 2][wd], r[4 * s + 3][wd],
                                        b1);
                }
#pragma unroll
                for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                    for (int i = 0; i < TERMS; ++i)
                        mma_bf16(c[nt], a, b[s][nt][0][i], b[s][nt][1][i]);
            }
            // the group's scale (and zero) of columns 2j (c0, c1) and
            // 2j + 1 (c2, c3), against rows 2t (c0, c2) and 2t + 1 (c1, c3)
            const float s0 = f16at(S, 2 * j), s1 = f16at(S, 2 * j + 1);
            if constexpr (ZERO) {
                const float z0 = f16at(Z, 2 * j), z1 = f16at(Z, 2 * j + 1);
#pragma unroll
                for (int nt = 0; nt < NT; ++nt) {
                    acc[nt][j][0] += s0 * c[nt][0] - z0 * xsm[nt][0];
                    acc[nt][j][1] += s0 * c[nt][1] - z0 * xsm[nt][1];
                    acc[nt][j][2] += s1 * c[nt][2] - z1 * xsm[nt][0];
                    acc[nt][j][3] += s1 * c[nt][3] - z1 * xsm[nt][1];
                }
            } else {
#pragma unroll
                for (int nt = 0; nt < NT; ++nt) {
                    acc[nt][j][0] += s0 * c[nt][0];
                    acc[nt][j][1] += s0 * c[nt][1];
                    acc[nt][j][2] += s1 * c[nt][2];
                    acc[nt][j][3] += s1 * c[nt][3];
                }
            }
        }
    }

    // lane (g, t) holds rows 8 nt + 2t (+1) of columns 16 g + 2j (+1); a
    // slot is [M rows][8 vectors of 17]. Warps past the block's groups
    // hold nothing.
    const int busy = min(KM_W, groups);
    const int total = M * KM_STRIP;
    const int chunk = (total + n_split - 1) / n_split;
    float* sums = km_smem + KM_W * M * KM_RS;      // [split][chunk]
    float* slot = km_smem + warp * M * KM_RS + 17 * g;
#pragma unroll
    for (int nt = 0; nt < NT && warp < busy; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int m = 8 * nt + 2 * t + (e & 1);
            if (m < M) {
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    slot[m * KM_RS + 2 * j + (e >> 1)] = acc[nt][j][e];
            }
        }
    __syncthreads();
    if (n_split > 1) asm volatile("barrier.cluster.wait.aligned;");

    // the slots summed in order; with split K, split b stores its sums of
    // outputs [r C, (r + 1) C) into block r's shared memory, and after
    // the cluster's barrier block r sums them in split order
    for (int e = tid; e < total; e += KM_THREADS) {
        const int m = e / KM_STRIP, n = e % KM_STRIP;
        const float* s = km_smem + m * KM_RS + 17 * (n / 16) + n % 16;
        float v = s[0];
#pragma unroll
        for (int i = 1; i < KM_W; ++i)
            if (i < busy) v += s[i * M * KM_RS];
        const int gn = blockIdx.x * KM_STRIP + n;
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
    for (int i = tid; i < chunk; i += KM_THREADS) {
        const int e = blockIdx.y * chunk + i;
        if (e >= total) break;
        float a[KM_MAX_SPLIT];
#pragma unroll
        for (int sp = 0; sp < KM_MAX_SPLIT; ++sp)
            a[sp] = sp < n_split ? sums[sp * chunk + i] : 0.f;
        float v = a[0];
#pragma unroll
        for (int sp = 1; sp < KM_MAX_SPLIT; ++sp)
            if (sp < n_split) v += a[sp];
        const int gn = blockIdx.x * KM_STRIP + e % KM_STRIP;
        if (gn < N) y[(size_t)(e / KM_STRIP) * N + gn] = from_f32<XT>(v);
    }
}

template <int FMT, typename XT, int NT>
int launch_kq_mv(const void* x, const uint8_t* w, const float* sc,
              const float* zr, void* y, int M, int K, int N, int n_split,
              int split_rows, cudaStream_t st) {
    const auto kernel = kq_mv_mma_kernel<FMT, XT, NT>;
    const int smem = 4 * kq_smem_floats(M, n_split);
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
    cfg.gridDim = dim3((N + KM_STRIP - 1) / KM_STRIP, n_split);
    cfg.blockDim = dim3(KM_THREADS);
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

// K10 / K11 for M <= 32 rows: NT = ceil(M / 8) tiles of 8 rows, n_split
// blocks of split_rows K rows (whole groups, none empty) a strip
template <int FMT, typename XT>
int kq_rows(const void* x, const uint8_t* w, const float* sc,
            const float* zr, void* y, int M, int K, int N, int n_split,
            int split_rows, cudaStream_t st) {
    constexpr int SUB = KqTraits<FMT>::SUB;
    const uintptr_t bases = reinterpret_cast<uintptr_t>(w)
        | reinterpret_cast<uintptr_t>(sc) | reinterpret_cast<uintptr_t>(zr);
    if (n_split < 1 || n_split > KM_MAX_SPLIT || split_rows < SUB
            || split_rows % SUB || (long long)n_split * split_rows < K
            || (long long)(n_split - 1) * split_rows >= K || bases % 16
            || 4 * kq_smem_floats(M, n_split) > 227 * 1024)
        return ERR_SHAPE;
#define WA_KQ(NT)                                                            \
    launch_kq_mv<FMT, XT, NT>(x, w, sc, zr, y, M, K, N, n_split,            \
                              split_rows, st)
    if (M <= 8) return WA_KQ(1);
    if (M <= 16) return WA_KQ(2);
    if (M <= 24) return WA_KQ(3);
    return WA_KQ(4);
#undef WA_KQ
}

}  // namespace
}  // namespace wa

using namespace wa;

// x [M, K] f32 or bf16; fmt KQ_Q4K (wq [K/2, N]), KQ_Q5K or KQ_Q6K
// (wq [K, N]); sc and zr [K/sub, N] f32 (zr null for Q6_K), all at the
// layer; out [M, N] in x's dtype; n_split blocks of split_rows K rows a
// strip (ops/q4k.kq_plan).
extern "C" int wa_kq_matvec(const void* x, int x_dtype, int M, int K,
                            int fmt, const void* wq, int N, const void* sc,
                            const void* zr, void* out, int n_split,
                            int split_rows, void* stream) {
    if (!kq_shape_ok(fmt, K, N) || M < 1 || M > KM_MAX_M) return ERR_SHAPE;
    if (!zeros_ok(fmt, zr)) return ERR_DTYPE;
    if (x_dtype != F32 && x_dtype != BF16) return ERR_DTYPE;
    const bool f32 = x_dtype == F32;
    auto st = static_cast<cudaStream_t>(stream);
    const auto w = static_cast<const uint8_t*>(wq);
    const auto s = static_cast<const float*>(sc);
    const auto z = static_cast<const float*>(zr);
    return (int)with_kq_fmt(fmt, [&](auto f) -> cudaError_t {
        constexpr int FMT = decltype(f)::value;
        return (cudaError_t)(
            f32 ? kq_rows<FMT, float>(x, w, s, z, out, M, K, N, n_split,
                                      split_rows, st)
                : kq_rows<FMT, __nv_bfloat16>(x, w, s, z, out, M, K, N,
                                              n_split, split_rows, st));
    });
}
