// K16: tiled attention with an online softmax (flash attention).
//
// Replaces the Pallas kernel of whisper_apr_tpu/ops/flash_attention.py
// (_flash_kernel / flash_attention, pallas_call at :135). Per (batch,
// head), for query rows i and key rows j < Tk:
//
//   s[i, j] = (q[i] . k[j]) * sm_scale    f32 sum of the inputs' products
//   masked where j >= kv_valid or (causal) j > i: -0.7 * f32max
//   m, l    running max and sum of p = exp(s - m)   (f32, p unrounded)
//   acc    += round(p, v's dtype) . v                (f32)
//   out     = acc / (l == 0 ? 1 : l)                 cast to q's dtype
//
// so bf16 rounds p where the JAX kernel does (p.astype(v.dtype) before
// the p.v product); the score matrix never leaves the block.
//
// Bound: 4 * Tq * Tk * 64 operations per (batch, head) against the inputs'
// bytes: at Whisper's 1500 frames the work, not the bytes, bounds it
// (3.5 us for whisper-tiny's 6 heads at B=1 on an H100's 989 bf16
// TFLOP/s, 11.6 us for large-v3's 20).
//
// bf16 (flash_mma_kernel): the products run on the tensor cores with
// mma.sync m16n8k16 (bf16 in, f32 sums). A block holds 128 query rows, a
// warp two tiles of 16 with their q fragments in registers. Per 64-key
// tile the warp forms its 32 x 64 scores (64 mma), masks, rescales and
// exponentiates them in registers, packs p to bf16 straight into the A
// fragments of p . v (the score fragment's layout is the operand's) and
// adds 32 x 64 outputs (64 mma); each K or V fragment it loads feeds both
// row tiles, which also gives the tensor cores two independent chains.
// What the design does about latency, the limit at these sizes:
//   - K and V tiles stream through a ring of FM_STAGES shared-memory
//     stages filled by 16-byte cp.async copies: tiles kt + 1 and kt + 2
//     are in flight while tile kt is multiplied, with one barrier per
//     tile. Rows past Tk are zero-filled by the copy's src-size, not by a
//     branch.
//   - K and V stay as they lie, [key][dim]: K's B fragments of q . k^T
//     come from ldmatrix.x4, V's of p . v from ldmatrix.x4.trans (the
//     16-bit transpose sm_90 has), 16 of each per warp and tile. Each
//     128-byte row's 16-byte chunks are XOR-swizzled by the row's low
//     three bits, so the eight rows an ldmatrix phase reads, and the
//     chunks a warp's copies write, fall in distinct banks.
//   - Scores are kept in the log2 domain: sm_scale * log2(e) scales the
//     f32 sum and ex2.approx replaces expf; a masked score is the same
//     -0.7 * f32max there, whose exponential is 0 as before. Only tiles
//     that reach kv_valid or the diagonal evaluate the mask; the others
//     fold the scale into the exponent's fma.
//   - Two blocks share an SM (64 KB of shared memory and up to 255
//     registers a thread each). Where the grid fills at most half of that
//     wave, the key tiles are split over n_split blocks per (query tile,
//     head), as many as still fit in it (ops/flash_attention.flash_split
//     decides). Each writes its unnormalised f32 acc with its m and l to
//     scratch, and flash_combine_kernel rescales the splits to their
//     common max in split order and writes bf16: no atomics, the same
//     result each run.
// Requires 16-byte aligned rows (strides multiples of 8, as every
// caller's).
//
// f32 (flash_kernel; also bf16 operands that are not so aligned): CUDA
// cores in f32, as tensor cores would round f32 inputs to TF32. Two
// threads a query row, each with the row's q in registers, 32 of the 64
// scores of a key tile (keys 2j + half, so the pair reads neighbouring
// banks) and 32 of the 64 output dims; K and V tiles of 64 rows in shared
// memory as f32; the pair swaps its probabilities with one shuffle per
// key pair.
//
// Both skip key tiles wholly above the diagonal (causal), as the JAX
// kernel does, and address operands by their strides, so the
// combined-head [B, T, H * 64] layout needs no transpose.
#include "common.cuh"
#include "cp_async.cuh"

namespace wa {
namespace {

constexpr float FA_MASK = -0.7f * 3.4028234663852886e38f;
constexpr int FA_BQ = 64;
constexpr int FA_BK = 64;
constexpr int FA_THREADS = 2 * FA_BQ;

// strides in elements of the [B, H, T, 64] view of an operand
struct Strides {
    long long b, h, t;
};

template <typename T>
__global__ void __launch_bounds__(FA_THREADS) flash_kernel(
        const T* __restrict__ q, Strides sq, const T* __restrict__ k,
        Strides sk, const T* __restrict__ v, Strides sv, T* __restrict__ o,
        Strides so, int H, int Tq, int Tk, int kv_valid, float sm_scale,
        int causal) {
    __shared__ float ks[FA_BK][HD + 1];
    __shared__ float vs[FA_BK][HD];
    const int qt = blockIdx.x, h = blockIdx.y % H, b = blockIdx.y / H;
    const int tid = threadIdx.x, half = tid & 1;
    const int row = qt * FA_BQ + (tid >> 1);
    const T* qp = q + b * sq.b + h * sq.h;
    const T* kp = k + b * sk.b + h * sk.h;
    const T* vp = v + b * sv.b + h * sv.h;

    float qr[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d)
        qr[d] = row < Tq ? to_f32(qp[row * sq.t + d]) : 0.f;
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m = -INFINITY, l = 0.f;

    int n_tiles = (Tk + FA_BK - 1) / FA_BK;
    if (causal) {   // tiles past the block's last row hold no valid key
        const int last = min(qt * FA_BQ + FA_BQ - 1, Tk - 1);
        n_tiles = min(n_tiles, last / FA_BK + 1);
    }
    for (int kt = 0; kt < n_tiles; ++kt) {
        const int k0 = kt * FA_BK;
        __syncthreads();   // the previous tile's readers are done
        for (int e = tid; e < FA_BK * HD; e += FA_THREADS) {
            const int r = e / HD, c = e % HD, j = k0 + r;
            ks[r][c] = j < Tk ? to_f32(kp[j * sk.t + c]) : 0.f;
            vs[r][c] = j < Tk ? to_f32(vp[j * sv.t + c]) : 0.f;
        }
        __syncthreads();
        float s[FA_BK / 2];
#pragma unroll
        for (int jj = 0; jj < FA_BK / 2; ++jj) s[jj] = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) {   // whole: qr stays in registers
            const float qd = qr[d];
#pragma unroll
            for (int jj = 0; jj < FA_BK / 2; ++jj)
                s[jj] += qd * ks[2 * jj + half][d];
        }
        float tmax = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < FA_BK / 2; ++jj) {
            const int j = k0 + 2 * jj + half;
            const bool ok = j < kv_valid && j < Tk && (!causal || j <= row);
            s[jj] = ok ? s[jj] * sm_scale : FA_MASK;
            tmax = fmaxf(tmax, s[jj]);
        }
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
        const float m_new = fmaxf(m, tmax);
        const float alpha = expf(m - m_new);
        float psum = 0.f;
#pragma unroll
        for (int jj = 0; jj < FA_BK / 2; ++jj) {
            const float p = expf(s[jj] - m_new);
            psum += p;
            // p . v takes p in v's dtype, as the JAX kernel
            s[jj] = to_f32(from_f32<T>(p));
        }
        psum += __shfl_xor_sync(0xffffffffu, psum, 1);
        l = l * alpha + psum;
        m = m_new;
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha;
#pragma unroll
        for (int jj = 0; jj < FA_BK / 2; ++jj) {
            const float mine = s[jj];
            const float other = __shfl_xor_sync(0xffffffffu, mine, 1);
            const float pe = half ? other : mine;    // key 2 jj
            const float po = half ? mine : other;    // key 2 jj + 1
#pragma unroll
            for (int i = 0; i < HD / 2; ++i)
                acc[i] += pe * vs[2 * jj][2 * i + half]
                    + po * vs[2 * jj + 1][2 * i + half];
        }
    }
    if (row < Tq) {
        const float inv = 1.f / (l == 0.f ? 1.f : l);
        T* op = o + b * so.b + h * so.h + row * so.t;
#pragma unroll
        for (int i = 0; i < HD / 2; ++i)
            op[2 * i + half] = from_f32<T>(acc[i] * inv);
    }
}

// --------------------------------------------------------------------------
// bf16 on the tensor cores
// --------------------------------------------------------------------------

constexpr int FM_STAGES = 3;              // K/V tiles in the ring
constexpr int FM_TILE = FA_BK * HD;       // elements of one 64 x 64 tile
constexpr int FM_RT = 2;                  // 16-row query tiles a warp
constexpr int FM_BQ = 4 * 16 * FM_RT;     // query rows a block (4 warps)
// q's tiles, then per stage a K and a V tile (bf16): 64 KB
constexpr int FM_SMEM = (FM_BQ / FA_BK + 2 * FM_STAGES) * FM_TILE * 2;
// blocks an SM holds (2 x 64 KB of shared memory; up to 255 registers a
// thread)
constexpr int FM_BLOCKS_PER_SM = 2;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int FC_ROWS = 16;               // rows a combine block writes

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
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

// 2^x (ex2.approx: 2 ulp; results under 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// element offset of 16-byte chunk ch (8 dims) of row r in a swizzled
// 64 x 64 tile
__device__ __forceinline__ int swz(int r, int ch) {
    return r * HD + ((ch ^ (r & 7)) << 3);
}

// rows r0 .. r0 + ROWS - 1 of a [T, 64] operand (row stride st) into a
// swizzled tile, rows at or past T zero-filled
template <int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile,
                                          const __nv_bfloat16* src,
                                          long long st, int r0, int T,
                                          int tid) {
#pragma unroll
    for (int i = 0; i < ROWS * (HD / 8) / FA_THREADS; ++i) {
        const int e = tid + i * FA_THREADS, r = e >> 3, ch = e & 7;
        const bool in = r0 + r < T;
        cp_async16(tile + swz(r, ch),
                   in ? src + (r0 + r) * st + ch * 8 : src, in ? 16 : 0);
    }
}

// blockIdx.x = query tile * n_split + split, blockIdx.y = batch * H +
// head; a warp holds FM_RT tiles of 16 query rows, a block FM_BQ rows.
// Split s takes key tiles [s * split_tiles, (s + 1) * split_tiles); with
// n_split > 1 it writes part_acc [n_split, B * H, Tq, 64] and part_ml
// [n_split, B * H, Tq, 2] (m, l; log2 domain) instead of o.
__global__ void __launch_bounds__(FA_THREADS, FM_BLOCKS_PER_SM)
flash_mma_kernel(
        const __nv_bfloat16* __restrict__ q, Strides sq,
        const __nv_bfloat16* __restrict__ k, Strides sk,
        const __nv_bfloat16* __restrict__ v, Strides sv,
        __nv_bfloat16* __restrict__ o, Strides so, int H, int Tq, int Tk,
        int kv_valid, float scale_log2, int causal, int n_split,
        int split_tiles, float* __restrict__ part_acc,
        float* __restrict__ part_ml) {
    constexpr int RT = FM_RT, BQ = FM_BQ;
    extern __shared__ __align__(16) unsigned char fm_smem[];
    __nv_bfloat16* const qs = reinterpret_cast<__nv_bfloat16*>(fm_smem);
    __nv_bfloat16* const ring = qs + RT * FM_TILE;   // stage i: K, then V
    const int qt = blockIdx.x / n_split, split = blockIdx.x % n_split;
    const int bh = blockIdx.y, h = bh % H, b = bh / H;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;      // fragment row / column pair
    const int row0 = qt * BQ + warp * 16 * RT + g;   // tile rt: + 16 rt
    const __nv_bfloat16* qp = q + b * sq.b + h * sq.h;
    const __nv_bfloat16* kp = k + b * sk.b + h * sk.h;
    const __nv_bfloat16* vp = v + b * sv.b + h * sv.h;

    int n_tiles = (Tk + FA_BK - 1) / FA_BK;
    if (causal) {   // tiles past the block's last row hold no valid key
        const int last = min(qt * BQ + BQ - 1, Tk - 1);
        n_tiles = min(n_tiles, last / FA_BK + 1);
    }
    const int t0 = split * split_tiles;
    const int count = max(0, min(n_tiles, t0 + split_tiles) - t0);

    auto load_kv = [&](int i) {   // tile t0 + i into stage i % FM_STAGES
        __nv_bfloat16* st_ = ring + (i % FM_STAGES) * 2 * FM_TILE;
        load_tile<FA_BK>(st_, kp, sk.t, (t0 + i) * FA_BK, Tk, tid);
        load_tile<FA_BK>(st_ + FM_TILE, vp, sv.t, (t0 + i) * FA_BK, Tk, tid);
    };
    load_tile<BQ>(qs, qp, sq.t, qt * BQ, Tq, tid);   // in tile 0's group
#pragma unroll
    for (int i = 0; i < FM_STAGES - 1; ++i) {
        if (i < count) load_kv(i);
        cp_async_commit();
    }
    cp_async_wait<FM_STAGES - 2>();
    __syncthreads();
    uint32_t qa[RT][HD / 16][4];                // A fragments of q
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
        for (int kc = 0; kc < HD / 16; ++kc)
            ldmatrix_x4(qa[rt][kc], qs + swz((warp * RT + rt) * 16
                                             + (lane & 15),
                                             2 * kc + (lane >> 4)));

    float acc[RT][HD / 8][4];
    float m[RT][2], l[RT][2];                   // rows g and g + 8
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) {
#pragma unroll
        for (int i = 0; i < HD / 8; ++i)
            acc[rt][i][0] = acc[rt][i][1] = acc[rt][i][2] = acc[rt][i][3] =
                0.f;
        m[rt][0] = m[rt][1] = -INFINITY;
        l[rt][0] = l[rt][1] = 0.f;
    }

    // the lane's ldmatrix rows and chunks: K (x4: keys +0 / +8, dims
    // +0 / +8) and V (x4.trans: keys +0 / +8, dims +0 / +8)
    const int k_row = (lane & 7) + ((lane >> 4) << 3);
    const int k_ch = (lane >> 3) & 1;
    const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3);
    const int v_ch = lane >> 4;
    for (int it = 0; it < count; ++it) {
        cp_async_wait<FM_STAGES - 2>();
        __syncthreads();   // tile it has landed; tile it - 1 is done with
        if (it + FM_STAGES - 1 < count) load_kv(it + FM_STAGES - 1);
        cp_async_commit();
        const __nv_bfloat16* ks = ring + (it % FM_STAGES) * 2 * FM_TILE;
        const __nv_bfloat16* vs = ks + FM_TILE;
        const int k0 = (t0 + it) * FA_BK;

        float s[RT][FA_BK / 8][4];
#pragma unroll
        for (int rt = 0; rt < RT; ++rt)
#pragma unroll
            for (int nt = 0; nt < FA_BK / 8; ++nt)
                s[rt][nt][0] = s[rt][nt][1] = s[rt][nt][2] = s[rt][nt][3] =
                    0.f;
#pragma unroll
        for (int np = 0; np < FA_BK / 16; ++np) {
#pragma unroll
            for (int kc = 0; kc < HD / 16; ++kc) {
                uint32_t kb[4];
                ldmatrix_x4(kb, ks + swz(np * 16 + k_row, 2 * kc + k_ch));
#pragma unroll
                for (int rt = 0; rt < RT; ++rt) {
                    mma_bf16(s[rt][2 * np], qa[rt][kc], kb[0], kb[1]);
                    mma_bf16(s[rt][2 * np + 1], qa[rt][kc], kb[2], kb[3]);
                }
            }
        }
        // only a tile reaching kv_valid or (causal) the block's first row
        // holds a masked key
        const bool masked = k0 + FA_BK > kv_valid
            || (causal && k0 + FA_BK - 1 > qt * BQ);
        // the scaled score is f * s: a tile without masked keys keeps s
        // raw and folds the scale into the exponent's fma (its max scales
        // with it, the scale being positive); a masked one scales first
        float f = scale_log2;
        if (masked || !(scale_log2 > 0.f)) {
#pragma unroll
            for (int rt = 0; rt < RT; ++rt)
#pragma unroll
                for (int nt = 0; nt < FA_BK / 8; ++nt)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int j = k0 + nt * 8 + 2 * t + (e & 1);
                        const int row = row0 + 16 * rt + (e < 2 ? 0 : 8);
                        const bool ok = j < kv_valid
                            && (!causal || j <= row);
                        s[rt][nt][e] = ok ? s[rt][nt][e] * scale_log2
                                          : FA_MASK;
                    }
            f = 1.f;
        }
        uint32_t pa[RT][FA_BK / 16][4];         // p in bf16, A fragments
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
            float (&sr)[FA_BK / 8][4] = s[rt];
            float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
            for (int nt = 0; nt < FA_BK / 8; ++nt) {
                mx0 = fmaxf(mx0, fmaxf(sr[nt][0], sr[nt][1]));
                mx1 = fmaxf(mx1, fmaxf(sr[nt][2], sr[nt][3]));
            }
#pragma unroll
            for (int o_ = 1; o_ <= 2; o_ <<= 1) {   // the quad of a row
                mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
                mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
            }
            const float mn0 = fmaxf(m[rt][0], mx0 * f);
            const float mn1 = fmaxf(m[rt][1], mx1 * f);
            const float a0 = ex2(m[rt][0] - mn0), a1 = ex2(m[rt][1] - mn1);
            m[rt][0] = mn0;
            m[rt][1] = mn1;
            float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
            for (int nt = 0; nt < FA_BK / 8; ++nt) {
                sr[nt][0] = ex2(fmaf(sr[nt][0], f, -mn0));
                sr[nt][1] = ex2(fmaf(sr[nt][1], f, -mn0));
                sr[nt][2] = ex2(fmaf(sr[nt][2], f, -mn1));
                sr[nt][3] = ex2(fmaf(sr[nt][3], f, -mn1));
                ps0 += sr[nt][0] + sr[nt][1];
                ps1 += sr[nt][2] + sr[nt][3];
            }
            l[rt][0] = l[rt][0] * a0 + ps0;  // this thread's share; the
            l[rt][1] = l[rt][1] * a1 + ps1;  // quad sums at the end
#pragma unroll
            for (int i = 0; i < HD / 8; ++i) {
                acc[rt][i][0] *= a0;
                acc[rt][i][1] *= a0;
                acc[rt][i][2] *= a1;
                acc[rt][i][3] *= a1;
            }
            // p in bf16 (as the JAX kernel): the score fragments of key
            // tiles 2kc and 2kc+1 are the A fragment of keys 16kc..16kc+15
#pragma unroll
            for (int kc = 0; kc < FA_BK / 16; ++kc) {
                pa[rt][kc][0] = pack_bf16(sr[2 * kc][0], sr[2 * kc][1]);
                pa[rt][kc][1] = pack_bf16(sr[2 * kc][2], sr[2 * kc][3]);
                pa[rt][kc][2] = pack_bf16(sr[2 * kc + 1][0],
                                          sr[2 * kc + 1][1]);
                pa[rt][kc][3] = pack_bf16(sr[2 * kc + 1][2],
                                          sr[2 * kc + 1][3]);
            }
        }
#pragma unroll
        for (int kc = 0; kc < FA_BK / 16; ++kc) {
#pragma unroll
            for (int dp = 0; dp < HD / 16; ++dp) {
                uint32_t vb[4];
                ldmatrix_x4_trans(vb, vs + swz(kc * 16 + v_row,
                                               2 * dp + v_ch));
#pragma unroll
                for (int rt = 0; rt < RT; ++rt) {
                    mma_bf16(acc[rt][2 * dp], pa[rt][kc], vb[0], vb[1]);
                    mma_bf16(acc[rt][2 * dp + 1], pa[rt][kc], vb[2], vb[3]);
                }
            }
        }
    }
    cp_async_wait<0>();   // only empty groups remain; leave none behind
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) {
#pragma unroll
        for (int o_ = 1; o_ <= 2; o_ <<= 1) {
            l[rt][0] += __shfl_xor_sync(0xffffffffu, l[rt][0], o_);
            l[rt][1] += __shfl_xor_sync(0xffffffffu, l[rt][1], o_);
        }
    }
    if (n_split > 1) {   // the unnormalised partials, for the combine
        const size_t base = ((size_t)split * gridDim.y + bh) * Tq;
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {    // rows g, g + 8
                const int row = row0 + 16 * rt + 8 * hf;
                if (row >= Tq) continue;
                float* pr = part_acc + (base + row) * HD;
#pragma unroll
                for (int dn = 0; dn < HD / 8; ++dn)
                    *reinterpret_cast<float2*>(pr + dn * 8 + 2 * t) =
                        make_float2(acc[rt][dn][2 * hf],
                                    acc[rt][dn][2 * hf + 1]);
                if (t == 0)
                    *reinterpret_cast<float2*>(part_ml + (base + row) * 2) =
                        make_float2(m[rt][hf], l[rt][hf]);
            }
        }
        return;
    }
    __nv_bfloat16* op = o + b * so.b + h * so.h;
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            const int row = row0 + 16 * rt + 8 * hf;
            if (row >= Tq) continue;
            const float inv = 1.f / (l[rt][hf] == 0.f ? 1.f : l[rt][hf]);
#pragma unroll
            for (int dn = 0; dn < HD / 8; ++dn)
                *reinterpret_cast<uint32_t*>(op + row * so.t + dn * 8
                                             + 2 * t) =
                    pack_bf16(acc[rt][dn][2 * hf] * inv,
                              acc[rt][dn][2 * hf + 1] * inv);
        }
    }
}

// The split partials of flash_mma_kernel, combined in split order: m =
// max of the splits' m, l = sum l_s 2^(m_s - m), out = sum acc_s 2^(m_s -
// m) / (l == 0 ? 1 : l) in bf16. A thread writes 4 dims of one row;
// blockIdx.x = row block, blockIdx.y = batch * H + head.
__global__ void __launch_bounds__(FC_ROWS * HD / 4) flash_combine_kernel(
        const float* __restrict__ part_acc, const float* __restrict__ part_ml,
        __nv_bfloat16* __restrict__ o, Strides so, int H, int Tq,
        int n_split) {
    const int bh = blockIdx.y, h = bh % H, b = bh / H;
    const int row = blockIdx.x * FC_ROWS + threadIdx.x / (HD / 4);
    const int d = (threadIdx.x % (HD / 4)) * 4;
    if (row >= Tq) return;
    float mx = -INFINITY;
    for (int s = 0; s < n_split; ++s)
        mx = fmaxf(mx, part_ml[(((size_t)s * gridDim.y + bh) * Tq + row) * 2]);
    float l = 0.f, a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    for (int s = 0; s < n_split; ++s) {
        const size_t r = ((size_t)s * gridDim.y + bh) * Tq + row;
        const float2 ml = *reinterpret_cast<const float2*>(part_ml + r * 2);
        const float w = exp2f(ml.x - mx);       // 0 for an empty split
        const float4 a = *reinterpret_cast<const float4*>(part_acc + r * HD
                                                          + d);
        l += w * ml.y;
        a0 += w * a.x;
        a1 += w * a.y;
        a2 += w * a.z;
        a3 += w * a.w;
    }
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    *reinterpret_cast<uint2*>(o + b * so.b + h * so.h + row * so.t + d) =
        make_uint2(pack_bf16(a0 * inv, a1 * inv), pack_bf16(a2 * inv,
                                                            a3 * inv));
}

__host__ __forceinline__ bool rows_aligned(const void* p, Strides s) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0
        && s.h % 8 == 0 && s.t % 8 == 0;
}

int launch_mma(const void* q, Strides sq, const void* k, Strides sk,
               const void* v, Strides sv, void* o, Strides so, int B, int H,
               int Tq, int Tk, int kv_valid, float sm_scale, int causal,
               int n_split, int split_tiles, float* part_acc, float* part_ml,
               cudaStream_t st) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        flash_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        FM_SMEM);
    if (attr != cudaSuccess) return (int)attr;
    const dim3 grid((Tq + FM_BQ - 1) / FM_BQ * n_split, B * H);
    flash_mma_kernel<<<grid, FA_THREADS, FM_SMEM, st>>>(
        static_cast<const __nv_bfloat16*>(q), sq,
        static_cast<const __nv_bfloat16*>(k), sk,
        static_cast<const __nv_bfloat16*>(v), sv,
        static_cast<__nv_bfloat16*>(o), so, H, Tq, Tk, kv_valid,
        (float)(sm_scale * (double)LOG2E), causal, n_split, split_tiles,
        part_acc, part_ml);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || n_split == 1) return (int)err;
    flash_combine_kernel<<<dim3((Tq + FC_ROWS - 1) / FC_ROWS, B * H),
                           FC_ROWS * HD / 4, 0, st>>>(
        part_acc, part_ml, static_cast<__nv_bfloat16*>(o), so, H, Tq,
        n_split);
    return (int)cudaGetLastError();
}

}  // namespace
}  // namespace wa

// q [B, H, Tq, 64], k/v [B, H, Tk, 64], out [B, H, Tq, 64], each given by
// its pointer and its (batch, head, row) strides in elements, the last
// dim contiguous; one dtype for all (f32 or bf16); 1 <= kv_valid <= Tk.
// bf16 with 16-byte aligned rows runs flash_mma_kernel over n_split
// splits of split_tiles key tiles each (n_split > 1 needs part_acc, f32
// [n_split * B * H * Tq * 64], and part_ml, f32 [n_split * B * H * Tq *
// 2]); anything else runs flash_kernel and takes n_split = 1 only.
extern "C" int wa_flash_attention(
        const void* q, long long sqb, long long sqh, long long sqt,
        const void* k, long long skb, long long skh, long long skt,
        const void* v, long long svb, long long svh, long long svt,
        void* out, long long sob, long long soh, long long sot, int dtype,
        int B, int H, int Tq, int Tk, int kv_valid, float sm_scale,
        int causal, int n_split, int split_tiles, float* part_acc,
        float* part_ml, void* stream) {
    using namespace wa;
    const int n_tiles = (Tk + FA_BK - 1) / FA_BK;
    if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || kv_valid < 1 || kv_valid > Tk
            || (long long)B * H > 65535 || n_split < 1 || split_tiles < 1
            || (long long)n_split * split_tiles < n_tiles
            || (n_split - 1) * split_tiles >= n_tiles
            || (n_split > 1 && (part_acc == nullptr || part_ml == nullptr)))
        return ERR_SHAPE;
    auto st = static_cast<cudaStream_t>(stream);
    const Strides a{sqb, sqh, sqt}, b{skb, skh, skt}, c{svb, svh, svt},
        d{sob, soh, sot};
    if (dtype == BF16 && rows_aligned(q, a) && rows_aligned(k, b)
            && rows_aligned(v, c) && rows_aligned(out, d))
        return launch_mma(q, a, k, b, v, c, out, d, B, H, Tq, Tk, kv_valid,
                          sm_scale, causal, n_split, split_tiles, part_acc,
                          part_ml, st);
    if (n_split != 1) return ERR_SHAPE;
    const dim3 grid((Tq + FA_BQ - 1) / FA_BQ, B * H);
    if (dtype == F32)
        flash_kernel<float><<<grid, FA_THREADS, 0, st>>>(
            static_cast<const float*>(q), a, static_cast<const float*>(k), b,
            static_cast<const float*>(v), c, static_cast<float*>(out), d, H,
            Tq, Tk, kv_valid, sm_scale, causal);
    else if (dtype == BF16)
        flash_kernel<__nv_bfloat16><<<grid, FA_THREADS, 0, st>>>(
            static_cast<const __nv_bfloat16*>(q), a,
            static_cast<const __nv_bfloat16*>(k), b,
            static_cast<const __nv_bfloat16*>(v), c,
            static_cast<__nv_bfloat16*>(out), d, H, Tq, Tk, kv_valid,
            sm_scale, causal);
    else
        return ERR_DTYPE;
    return (int)cudaGetLastError();
}
