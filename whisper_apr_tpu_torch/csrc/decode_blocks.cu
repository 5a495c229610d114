// Per-block decode kernels for one token at batch 1: K1 self_block,
// K2 cross_block and K3 ffn_block, and K12 self_block_kq, K13
// cross_block_kq and K14 ffn_block_kq (K1, K2 and K3 over k-quant
// weights).
//
// Replace the Pallas kernels of whisper_apr_tpu/ops/decode_blocks.py
// (self_block/_self_kernel, cross_block/_cross_kernel,
// ffn_block/_ffn_kernel) and of whisper_apr_tpu/ops/decode_blocks_kq.py
// (self_block_kq/_self_kernel_kq, cross_block_kq/_cross_kernel_kq,
// ffn_block_kq/_ffn_kernel_kq), and compute what they compute:
//
//   K1 self_block : LN1 -> fused QKV int8 matvec x sqkv + bqkv -> the new
//                   k/v row in the cache's form (int8 + f32 row scale, or
//                   the cache dtype) -> softmax attention over cache rows
//                   < pos plus the current row -> o-proj int8 x wos + wob
//                   + residual
//   K2 cross_block: LN2 -> q int8 matvec -> attention over cross rows
//                   < enc_len -> o-proj + bias + residual
//   K3 ffn_block  : LN3 -> fc1 int8 x s1 + b1 -> exact GELU (erff) ->
//                   fc2 int8 (f32 accumulation) x fc2_s + fc2_b + residual
//   K12, K13, K14 : K1, K2, K3 with the matvecs over Q4_K / Q5_K / Q6_K
//                   planar weights (kquant.cuh), biases in f32; every
//                   matvec input (the LN output, the attention output, the
//                   GELU output) rounded to x's dtype before its dot and
//                   before its group sums
//
// What bounds them on the card: at batch 1 each call reads every int8
// weight byte of its sub-block once (large-v3: 6.55 MB QKV [1280, 3840]
// plus o-proj [1280, 1280], 3.3 MB q+o-proj, 13.1 MB fc1+fc2 per layer;
// Q4_K 0.75 bytes a weight, Q5_K and Q6_K 1.25)
// and, for attention, every live cache row once (cross8 large-v3: 1500
// int8 rows of K and V, 3.8 MB per layer). Arithmetic is two flops per
// byte, far under the card's flop/byte ratio, so the only lever is moving
// fewer bytes and keeping enough blocks in flight to pull the bandwidth.
//
// Design: one C entry per op, each a single launch on the rows the decode
// step uses (K1 and K12 on int8 self rows take two, below). At batch 1
// each step of a block moves well under a microsecond of bytes, so
// launches and the serial path inside each block set the time from the L2
// cache; from device memory (the decode step cycles through every layer's
// weights) the bytes a block copies at its start do. K1, K2, K12 and K13 share
// one kernel, templated on the weights' form: a thread block cluster per
// head (below). K3 and K14 share another, templated alike, that cuts the
// hidden layer over clusters (further below).
#include "attention.cuh"
#include "cluster.cuh"
#include "kquant.cuh"

namespace wa {
namespace {

// --------------------------------------------------------------------------
// K1 self_block, K2 cross_block, K12, K13: one thread block cluster a head
// --------------------------------------------------------------------------
//
// Grid (C, H) with clusters of (C, 1, 1): the C blocks of head h's cluster
// split the head's work three ways (ops/decode_blocks.cross_plan chooses
// C, the rows per block and the rows staged at a time):
//   - the head's projection, LN(x) . Wq[:, head's columns]: 64 columns
//     (q_h) for K2, 192 for K1 (q_h, k_h and v_h of the fused QKV); block
//     r sums Wq rows [r D / C, (r + 1) D / C) (K12, K13: whole groups,
//     below)
//     and stores its share into
//     every block of the cluster (st.async into distributed shared memory,
//     counted by the receiver's transaction barrier); each adds them in
//     rank order;
//   - K1: the current token's k/v row in the cache's form (block 0 writes
//     the head's 64 elements out) and its score, the same in every block;
//   - attention: block r takes cache rows [r rows, (r + 1) rows) below
//     n_loop, staged a chunk at a time: scores by groups of 4 threads a
//     row, the chunk's max through the warps, weights a row a thread, the
//     weighted V rows a dim a thread (a running max and sum across
//     chunks); its (m, l, acc[64]) goes to every block as the projection's
//     shares did, and each merges them in rank order (K1: then the
//     current row);
//   - o-proj: y = sum_h attn_h . Wo[64 h : 64 h + 64, :]; block r takes
//     the columns [16 (r U / C), 16 ((r + 1) U / C)), U = D / 16, writes
//     its head's partial to scratch, and the last of the H blocks of that
//     column range to finish (an atomic ticket) adds the H partials in
//     head order, then the scale, the bias and the residual.
// Every sum runs in a fixed order: two runs give the same bits.
// x, and the block's share of Wq, of Wo and its first chunk of K/V rows
// (and their row scales) are loaded as the block starts (cp.async into
// shared memory), so the LayerNorm, the projection and the first exchange
// overlap those loads. Measured on an H100 (PERF.md): from the L2 cache
// the time is the serial path of one block, a few hundred cycles to a
// microsecond a step, not the bytes.
//
// An int8 self cache quantizes the new k and v rows with one scale each
// over all D columns, so head h's current row depends on every head's
// projection: a dependency across clusters, which one launch could only
// meet by a grid-wide wait (safe only if every block is resident at
// once). K1 (and K12) on int8 rows is two launches of this kernel instead:
// HB_PROJECT writes the projection [3D] to scratch, HB_ATTEND reads it
// back (the scales from all of k and v) and goes on from the current row.
enum HeadKind { HB_CROSS = 0, HB_SELF = 1, HB_PROJECT = 2, HB_ATTEND = 3 };

// The form of the projections' weights, a template argument of the
// kernel: int8 with one f32 scale a column (K1, K2), or a k-quant planar
// form of kquant.cuh (K12, K13 over Q4_K, Q5_K or Q6_K): VPB K values a
// byte row, one scale (and a zero) a group of SUB values and column, the
// group's term S (h . q) - Z sum(h) taken row by row. A block's share of
// Wq's rows is then whole groups (K12: of each of the head's three
// 64-column pieces of the [D, 3D] QKV planes), and a head's 64 rows of Wo
// are 2 (Q4_K, Q5_K) or 4 (Q6_K) whole groups: each head's o-proj partial
// carries its own scales and zeros, and the ticket's sum adds only bias
// and residual.
struct WInt8 {
    static constexpr bool KQ = false, ZERO = false;
    static constexpr int VPB = 1, SUB = 0, PLANES = 0;
};
template <int FMT>
struct WKq {
    static constexpr bool KQ = true, ZERO = KqTraits<FMT>::ZERO;
    static constexpr int VPB = FMT == KQ_Q4K ? 2 : 1;
    static constexpr int SUB = KqTraits<FMT>::SUB;
    static constexpr int PLANES = ZERO ? 2 : 1;     // scale (and zero)
};

constexpr int CB_THREADS = 256;
constexpr int CB_GROUPS = CB_THREADS / 4;          // scores: 4 threads a row
constexpr int CB_MAX_CHUNK = CB_THREADS;           // rows staged at a time
constexpr int CB_XMAX = 8;                         // x elements a thread loads
constexpr int CB_MAX_CLUSTER = 16;
constexpr int CB_KLANES = CB_THREADS / 16;         // q matvec: 16 threads a row
constexpr int CB_RED = 1024;                       // floats of reduction scratch
constexpr unsigned FULL = 0xffffffffu;

// shared-memory layout of a K1 / K2 / K12 / K13 block, in bytes (every offset
// a multiple of 16); W projected columns (64 or 192); k-quant weights
// (sub > 0): vpb values a byte row, `planes` f32 planes (scale, zero) of
// a group of sub rows, both for Wq's share and the head's rows of Wo
struct HeadLayout {
    int wq_rows, wo_cols;                 // most rows / columns a block takes
    int xs, wq, sq, wo, wos, k, v, ks, vs, s, p, red, qall, pall, q, att,
        cur, flag, bars, total;
};

__host__ __device__ inline HeadLayout head_layout(int D, int C, int chunk,
                                                  int cache_size, int W,
                                                  int vpb = 1, int sub = 0,
                                                  int planes = 0) {
    HeadLayout L;
    const int groups = sub > 0 ? (D / sub + C - 1) / C : 0;  // most a block
    L.wq_rows = sub > 0 ? groups * sub / vpb : (D + C - 1) / C;
    L.wo_cols = 16 * ((D / 16 + C - 1) / C);
    int o = 0;
    L.xs = o;   o += D * 4;
    L.wq = o;   o += L.wq_rows * W;
    L.sq = o;   o += planes * groups * W * 4;
    L.wo = o;   o += HD / vpb * L.wo_cols;
    L.wos = o;  o += sub > 0 ? planes * (HD / sub) * L.wo_cols * 4 : 0;
    L.k = o;    o += chunk * HD * cache_size;
    L.v = o;    o += chunk * HD * cache_size;
    L.ks = o;   o += chunk * 4;
    L.vs = o;   o += chunk * 4;
    L.s = o;    o += chunk * 4;           // the chunk's scores
    L.p = o;    o += chunk * 4;           // and weights
    L.red = o;  o += (CB_RED > 8 * W ? CB_RED : 8 * W) * 4;
    L.qall = o; o += C * W * 4;           // each block's projection share
    L.pall = o; o += C * (HD + 4) * 4;    // each block's m, l, acc[64]
    L.q = o;    o += HD * 4;
    L.att = o;  o += HD * 4;
    L.cur = o;                            // K1: q, k, v of the head [W],
    if (W > HD) o += (W + 2 * HD + 20) * 4;  // its k, v rows, |k|, |v|
    L.flag = o; o += 16;                  // maxima [16] and score
    L.bars = o; o += 16;                  // the two barriers of the exchanges
    L.total = o;
    return L;
}

template <typename WF>
__host__ __device__ inline HeadLayout head_layout_wf(int D, int C, int chunk,
                                                     int cache_size, int W) {
    return head_layout(D, C, chunk, cache_size, W, WF::VPB, WF::SUB,
                       WF::PLANES);
}

// One byte row of k-quant weights, four columns: d[j] = the row's values
// . their inputs h (two K values a byte for Q4_K: low nibble, then high;
// the raw byte zero-extended), hs = the sum of those inputs
template <typename WF>
__device__ __forceinline__ void kq_row4(char4 w, const float* h, float (&d)[4],
                                        float& hs) {
    const int8_t b[4] = {w.x, w.y, w.z, w.w};
    if constexpr (WF::VPB == 2) {
        const float h0 = h[0], h1 = h[1];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const unsigned u = (unsigned)(unsigned char)b[j];
            d[j] = h0 * (float)(u & 15u) + h1 * (float)(u >> 4);
        }
        hs = h0 + h1;
    } else {
        const float h0 = h[0];
#pragma unroll
        for (int j = 0; j < 4; ++j) d[j] = h0 * (float)b[j];
        hs = h0;
    }
}

// LayerNorm statistics of xs[0, D) (f32 in shared memory): every warp
// takes them over all of x itself (the same sums in the same order), no
// block reduction
__device__ __forceinline__ void ln_stats(const float* xs, int D, float& mean,
                                         float& rstd) {
    const int lane = threadIdx.x & 31;
    float sum = 0.f;
    for (int i = lane; i < D; i += 32) sum += xs[i];
    mean = warp_sum(sum) / (float)D;
    float var = 0.f;
    for (int i = lane; i < D; i += 32) {
        const float d = xs[i] - mean;
        var += d * d;
    }
    rstd = rsqrtf(warp_sum(var) / (float)D + LN_EPS);
}

// K1 on int8 rows, second launch: the head's projection [q, k, v] back
// from the first launch's scratch qkv [3D], and every warp's max |k| and
// |v| over all of D (the rows' scales) into amax[0, 8) and amax[8, 16)
__device__ __forceinline__ void read_projection(const float* qkv, int D,
                                                int h, float* proj,
                                                float* amax) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    if (tid < 3 * HD)
        proj[tid] = qkv[(tid / HD) * D + h * HD + tid % HD];
    float ka = 0.f, va = 0.f;
    for (int i = tid; i < D; i += CB_THREADS) {
        ka = fmaxf(ka, fabsf(qkv[D + i]));
        va = fmaxf(va, fabsf(qkv[2 * D + i]));
    }
    ka = warp_max(ka);
    va = warp_max(va);
    if (lane == 0) {
        amax[warp] = ka;
        amax[8 + warp] = va;
    }
}

// K1: from the head's projection proj [q, k, v] (int8 rows: and the warps'
// maxima amax), the current token's k/v row in the cache's form (block 0
// of each head writes the head's 64 elements out), the row as attention
// reads it (kcur, vcur), the scaled query qf and the row's score s_cur
template <typename CT>
__device__ __forceinline__ void current_row(
        const float* proj, const float* amax, float* kcur, float* vcur,
        float* qf, float* s_cur, CT* __restrict__ k_row,
        CT* __restrict__ v_row, float* __restrict__ k_scale,
        float* __restrict__ v_scale, int h, int r) {
    constexpr bool I8 = std::is_same<CT, int8_t>::value;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    float ksc = 1.f, vsc = 1.f;        // int8: one scale over all D columns
    if constexpr (I8) {
        float ka = 0.f, va = 0.f;
#pragma unroll
        for (int w = 0; w < CB_THREADS / 32; ++w) {
            ka = fmaxf(ka, amax[w]);
            va = fmaxf(va, amax[8 + w]);
        }
        ksc = fmaxf(ka, 1e-12f) / 127.f;
        vsc = fmaxf(va, 1e-12f) / 127.f;
    }
    if (tid < HD) {
        const float k = proj[HD + tid], v = proj[2 * HD + tid];
        CT kr, vr;
        if constexpr (I8) {
            const float k8 = fminf(fmaxf(rintf(k / ksc), -127.f), 127.f);
            const float v8 = fminf(fmaxf(rintf(v / vsc), -127.f), 127.f);
            kr = (int8_t)k8;
            vr = (int8_t)v8;
            kcur[tid] = k8 * ksc;
            vcur[tid] = v8 * vsc;
        } else {
            kr = from_f32<CT>(k);
            vr = from_f32<CT>(v);
            kcur[tid] = to_f32(kr);
            vcur[tid] = to_f32(vr);
        }
        if (r == 0) {
            k_row[h * HD + tid] = kr;
            v_row[h * HD + tid] = vr;
        }
        qf[tid] = proj[tid] * QSCALE;
    }
    if (h == 0 && r == 0 && tid == 0) {
        *k_scale = ksc;
        *v_scale = vsc;
    }
    __syncthreads();
    if (warp == 0) {
        float sc = qf[2 * lane] * kcur[2 * lane]
            + qf[2 * lane + 1] * kcur[2 * lane + 1];
        sc = warp_sum(sc);
        if (lane == 0) *s_cur = sc;
    }
}

// grid (C, H), clusters (C, 1, 1); see above. K2: HB_CROSS; K1: HB_SELF
// (f32, bf16 and fp8 rows), or HB_PROJECT then HB_ATTEND (int8 rows);
// both over int8 weights (WInt8: sq, wos [N] column scales, zq, woz
// null). K13 as K2 and K12 as K1 over a k-quant form (WKq: sq, zq the
// [K / SUB, NP D] planes of Wq, wos, woz Wo's; zq, woz null for Q6_K).
template <typename XT, typename CT, int KIND, typename WF = WInt8>
__global__ void __launch_bounds__(CB_THREADS) head_block_kernel(
        const XT* __restrict__ x, int D, const float* __restrict__ ln_w,
        const float* __restrict__ ln_b, const int8_t* __restrict__ wq,
        const float* __restrict__ sq, const float* __restrict__ zq,
        const float* __restrict__ bq,
        const CT* __restrict__ kc, const CT* __restrict__ vc,
        const float* __restrict__ ks, const float* __restrict__ vs,
        int n_valid, int n_loop, int rows, int chunk,
        const int8_t* __restrict__ wo, const float* __restrict__ wos,
        const float* __restrict__ woz,
        const float* __restrict__ wob, XT* __restrict__ x_out,
        float* __restrict__ ypart, int* __restrict__ tickets,
        CT* __restrict__ k_row, CT* __restrict__ v_row,
        float* __restrict__ k_scale, float* __restrict__ v_scale,
        float* __restrict__ qkv) {
    constexpr bool SELF = KIND != HB_CROSS;
    constexpr bool PROJ = KIND != HB_ATTEND;   // computes the projection
    constexpr bool ATT = KIND != HB_PROJECT;   // attends and projects out
    constexpr int NP = SELF ? 3 : 1;           // 64-column pieces: q (k, v)
    constexpr int W = NP * HD;
    extern __shared__ __align__(16) unsigned char cb_smem[];
    const int C = gridDim.x, r = blockIdx.x, h = blockIdx.y, H = gridDim.y;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const HeadLayout lay = head_layout_wf<WF>(D, C, ATT ? chunk : 0,
                                              sizeof(CT), W);
    // the exchanges' barriers expect every block's projection share and
    // its (m, l, acc[64]); a block stores into the others only once all
    // have set theirs up: arrive here, wait before the first remote store
    uint64_t* bar_q = reinterpret_cast<uint64_t*>(cb_smem + lay.bars);
    uint64_t* bar_p = bar_q + 1;
    if (tid == 0) {
        if (PROJ) mbar_init_expect(bar_q, C * W * 4);
        if (ATT) mbar_init_expect(bar_p, C * (HD + 2) * 4);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    float* xs = reinterpret_cast<float*>(cb_smem + lay.xs);
    int8_t* wq_s = reinterpret_cast<int8_t*>(cb_smem + lay.wq);
    float* sq_s = reinterpret_cast<float*>(cb_smem + lay.sq);    // k-quant
    int8_t* wo_s = reinterpret_cast<int8_t*>(cb_smem + lay.wo);
    float* wos_s = reinterpret_cast<float*>(cb_smem + lay.wos);  // k-quant
    CT* k_s = reinterpret_cast<CT*>(cb_smem + lay.k);
    CT* v_s = reinterpret_cast<CT*>(cb_smem + lay.v);
    float* ks_s = reinterpret_cast<float*>(cb_smem + lay.ks);
    float* vs_s = reinterpret_cast<float*>(cb_smem + lay.vs);
    float* s_sh = reinterpret_cast<float*>(cb_smem + lay.s);
    float* p_sh = reinterpret_cast<float*>(cb_smem + lay.p);
    float* red = reinterpret_cast<float*>(cb_smem + lay.red);
    float* qall = reinterpret_cast<float*>(cb_smem + lay.qall);  // [C][W]
    float* pall = reinterpret_cast<float*>(cb_smem + lay.pall);  // [C][68]
    float* qf = reinterpret_cast<float*>(cb_smem + lay.q);
    float* att = reinterpret_cast<float*>(cb_smem + lay.att);
    float* proj = reinterpret_cast<float*>(cb_smem + lay.cur);   // [W]
    float* kcur = proj + W;           // the current row as the cache holds it
    float* vcur = kcur + HD;
    float* amax = vcur + HD;        // [16] the warps' max |k|, max |v|
    float* s_cur = amax + 16;       // the current row's score
    int* flag = reinterpret_cast<int*>(cb_smem + lay.flag);

    // this block's shares of Wq's rows (k-quant: whole groups), Wo's
    // columns and the cache rows
    int k0, k1;
    if constexpr (WF::KQ) {
        const int G = D / WF::SUB;
        k0 = WF::SUB * (r * G / C);
        k1 = WF::SUB * ((r + 1) * G / C);
    } else {
        k0 = r * D / C;
        k1 = (r + 1) * D / C;
    }
    const int U = D / 16;
    const int c0 = 16 * (r * U / C), c1 = 16 * ((r + 1) * U / C);
    const int t0 = min(n_loop, r * rows), t1 = min(n_loop, t0 + rows);
    const int n_chunks = (t1 - t0 + chunk - 1) / chunk;

    // 1. load x, and start the copies: Wq's rows, Wo's columns, the first
    //    chunk of K/V rows; three groups, in that order. Then the
    //    epilogue's operands of this block's columns (any block may finish
    //    last). HB_ATTEND reads the projection back instead (and, for the
    //    int8 row scales, every warp's max |k| and |v| over all of D)
    float xr[CB_XMAX];
    if constexpr (PROJ) {
#pragma unroll
        for (int j = 0; j < CB_XMAX; ++j) {
            const int i = tid + j * CB_THREADS;
            xr[j] = i < D ? to_f32(x[i]) : 0.f;
        }
        if constexpr (WF::KQ) {
            // the share's byte rows of the head's NP 64-column pieces
            // (rows NP D long), then its groups' scale (and zero) rows of
            // those columns
            const int b0 = k0 / WF::VPB, nb = (k1 - k0) / WF::VPB;
            for (int e = tid; e < nb * 4 * NP; e += CB_THREADS) {
                const int row = e / (4 * NP), pc = e % (4 * NP);
                const int c = (pc >> 2) * HD + (pc & 3) * 16;
                cp_async16(wq_s + row * W + c, wq + (size_t)(b0 + row) * NP
                           * D + (pc >> 2) * D + h * HD + (pc & 3) * 16, 16);
            }
            const int g0 = k0 / WF::SUB, ng = (k1 - k0) / WF::SUB;
            const int gmax = lay.wq_rows * WF::VPB / WF::SUB;
            for (int e = tid; e < WF::PLANES * ng * 16 * NP;
                 e += CB_THREADS) {
                const int c4 = e & 15, pc = (e >> 4) % NP;
                const int g = (e >> 4) / NP % ng, pl = (e >> 4) / NP / ng;
                cp_async16(sq_s + (pl * gmax + g) * W + pc * HD + 4 * c4,
                           (pl ? zq : sq) + (size_t)(g0 + g) * NP * D
                           + pc * D + h * HD + 4 * c4, 16);
            }
        } else {
            for (int e = tid; e < (k1 - k0) * 4 * NP; e += CB_THREADS) {
                const int row = e / (4 * NP), pc = e % (4 * NP);
                const int c = (pc >> 2) * HD + (pc & 3) * 16;  // 16 bytes
                cp_async16(wq_s + row * W + c, wq + (size_t)(k0 + row) * NP
                           * D + (pc >> 2) * D + h * HD + (pc & 3) * 16, 16);
            }
        }
        cp_async_commit();
    } else {
        read_projection(qkv, D, h, proj, amax);
    }
    float ep_s[CB_RED / CB_THREADS], ep_b[CB_RED / CB_THREADS],
        ep_x[CB_RED / CB_THREADS];
    auto stage_rows = [&](int ta, int n) {    // rows [ta, ta + n), one group
        constexpr int PER_ROW = HD * (int)sizeof(CT) / 16;
        constexpr int EL = 16 / (int)sizeof(CT);
        for (int e = tid; e < n * PER_ROW; e += CB_THREADS) {
            const int row = e / PER_ROW, c = (e % PER_ROW) * EL;
            const size_t src = (size_t)(ta + row) * D + h * HD + c;
            cp_async16(k_s + row * HD + c, kc + src, 16);
            cp_async16(v_s + row * HD + c, vc + src, 16);
        }
        if (ks != nullptr)
            for (int e = tid; e < n; e += CB_THREADS) {
                cp_async4(ks_s + e, ks + ta + e);
                cp_async4(vs_s + e, vs + ta + e);
            }
        cp_async_commit();
    };
    if constexpr (ATT) {
        const int wo_pieces = (c1 - c0) / 16;
        constexpr int WO_ROWS = HD / WF::VPB;       // byte rows of the head
        for (int e = tid; e < WO_ROWS * wo_pieces; e += CB_THREADS) {
            const int d = e / wo_pieces, c = (e % wo_pieces) * 16;
            cp_async16(wo_s + d * lay.wo_cols + c,
                       wo + (size_t)(h * WO_ROWS + d) * D + c0 + c, 16);
        }
        if constexpr (WF::KQ) {     // the head's groups' scale (and zero)
            constexpr int GO = HD / WF::SUB;        // rows, on these columns
            const int q4 = (c1 - c0) / 4;
            for (int e = tid; e < WF::PLANES * GO * q4; e += CB_THREADS) {
                const int pg = e / q4, c = (e % q4) * 4;
                const int pl = pg / GO, g = pg % GO;
                cp_async16(wos_s + pg * lay.wo_cols + c,
                           (pl ? woz : wos) + (size_t)(h * GO + g) * D + c0
                           + c, 16);
            }
        }
        cp_async_commit();
        stage_rows(t0, min(chunk, t1 - t0));
#pragma unroll
        for (int j = 0; j < CB_RED / CB_THREADS; ++j) {
            const int n = c0 + tid + j * CB_THREADS;
            const bool in = n < c1;
            ep_s[j] = in && !WF::KQ ? wos[n] : 0.f;
            ep_b[j] = in ? wob[n] : 0.f;
            ep_x[j] = in ? to_f32(x[n]) : 0.f;
        }
    }
    if constexpr (PROJ) {
#pragma unroll
        for (int j = 0; j < CB_XMAX; ++j) {
            const int i = tid + j * CB_THREADS;
            if (i < D) xs[i] = xr[j];
        }
    }
    __syncthreads();

    if constexpr (PROJ) {
        // 2. LayerNorm: the statistics over all of x (ln_stats); the
        //    block's Wq rows normalized and rounded to x's dtype
        float mean, rstd;
        ln_stats(xs, D, mean, rstd);
        __syncthreads();            // every warp has read x
        for (int i = k0 + tid; i < k1; i += CB_THREADS) {
            const float hv = (xs[i] - mean) * rstd * ln_w[i] + ln_b[i];
            xs[i] = sizeof(XT) == 2 ? round_bf16(hv) : hv;
        }
        if constexpr (ATT) cp_async_wait<2>();  // Wq's rows have landed
        else cp_async_wait<0>();
        __syncthreads();

        // 3. this block's share of each 64-column piece (16 threads of 4
        //    columns a row, 16 rows in flight), stored into every block of
        //    the cluster; each adds the shares in rank order
        const int c4 = tid & 15, kl = tid >> 4;
#pragma unroll
        for (int pc = 0; pc < NP; ++pc) {
            float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
            if constexpr (WF::KQ) {
                // byte row by byte row: S (h . q) - Z sum(h) of its group
                constexpr int BRG = WF::SUB / WF::VPB;  // byte rows a group
                const int gmax = lay.wq_rows / BRG;
                for (int br = kl; br < (k1 - k0) / WF::VPB;
                     br += CB_KLANES) {
                    const int o = pc * HD + 4 * c4;
                    const char4 w = *reinterpret_cast<const char4*>(
                        wq_s + br * W + o);
                    float dq[4], hs;
                    kq_row4<WF>(w, xs + k0 + WF::VPB * br, dq, hs);
                    const float4 S = *reinterpret_cast<const float4*>(
                        sq_s + (br / BRG) * W + o);
                    float4 Z = make_float4(0.f, 0.f, 0.f, 0.f);
                    if constexpr (WF::ZERO)
                        Z = *reinterpret_cast<const float4*>(
                            sq_s + (gmax + br / BRG) * W + o);
                    a0 += S.x * dq[0] - Z.x * hs;
                    a1 += S.y * dq[1] - Z.y * hs;
                    a2 += S.z * dq[2] - Z.z * hs;
                    a3 += S.w * dq[3] - Z.w * hs;
                }
            } else {
                for (int k = k0 + kl; k < k1; k += CB_KLANES) {
                    const char4 w = *reinterpret_cast<const char4*>(
                        wq_s + (k - k0) * W + pc * HD + 4 * c4);
                    const float hv = xs[k];
                    a0 += hv * (float)w.x;
                    a1 += hv * (float)w.y;
                    a2 += hv * (float)w.z;
                    a3 += hv * (float)w.w;
                }
            }
            a0 += __shfl_xor_sync(FULL, a0, 16);
            a1 += __shfl_xor_sync(FULL, a1, 16);
            a2 += __shfl_xor_sync(FULL, a2, 16);
            a3 += __shfl_xor_sync(FULL, a3, 16);
            if (lane < 16) {
                float* o = red + warp * W + pc * HD + 4 * c4;
                o[0] = a0; o[1] = a1; o[2] = a2; o[3] = a3;
            }
        }
        __syncthreads();
        asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
        {   // the 4 groups of 64 threads each store to every 4th block
            const int c = tid & (HD - 1);
#pragma unroll
            for (int pc = 0; pc < NP; ++pc) {
                float q = 0.f;
#pragma unroll
                for (int w = 0; w < CB_THREADS / 32; ++w)
                    q += red[w * W + pc * HD + c];
                for (int rr = tid >> 6; rr < C; rr += CB_THREADS / HD)
                    st_async(cluster_addr(qall + r * W + pc * HD + c, rr), q,
                             cluster_addr(bar_q, rr));
            }
        }
        mbar_wait(bar_q);           // every block's share is in place
        if (tid < W) {
            float qs[CB_MAX_CLUSTER];
#pragma unroll
            for (int rr = 0; rr < CB_MAX_CLUSTER; ++rr)
                qs[rr] = rr < C ? qall[rr * W + tid] : 0.f;
            float q = 0.f;
#pragma unroll
            for (int rr = 0; rr < CB_MAX_CLUSTER; ++rr)
                if (rr < C) q += qs[rr];
            const int col = (tid / HD) * D + h * HD + tid % HD;
            if constexpr (WF::KQ) {     // the groups' scales are in q
                const float p = q + bq[col];
                if constexpr (!SELF) {
                    qf[tid] = p * QSCALE;
                } else if constexpr (KIND == HB_PROJECT) {
                    if (r == 0) qkv[col] = p;
                } else {
                    proj[tid] = p;
                }
            } else if constexpr (!SELF) {
                qf[tid] = (q * sq[col] + bq[col]) * QSCALE;
            } else if constexpr (KIND == HB_PROJECT) {
                if (r == 0) qkv[col] = q * sq[col] + bq[col];
            } else {
                proj[tid] = q * sq[col] + bq[col];
            }
        }
        if constexpr (KIND == HB_PROJECT) return;
    } else {
        asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    }
    cp_async_wait<0>();             // Wo's columns and the first rows too
    __syncthreads();
    if constexpr (SELF)
        current_row(proj, amax, kcur, vcur, qf, s_cur, k_row, v_row,
                    k_scale, v_scale, h, r);
    float qv[16];                   // this thread's quarter of q_h
    const int quarter = tid & 3, rg = tid >> 2;
#pragma unroll
    for (int j = 0; j < 16; ++j) qv[j] = qf[quarter * 16 + j];

    // 4. attention over this block's rows, a chunk at a time, with a
    //    running max m and sum l (the same in every thread) and acc of
    //    one of the 64 dims over every 4th row (d = tid % 64):
    //    scores by row groups of 4 threads (16 elements each); the
    //    chunk's max through the warps; weights one row a thread; then
    //    the weighted V rows a dim a thread
    const int d = tid & (HD - 1), dg = tid >> 6;
    float m = -INFINITY, l = 0.f, acc = 0.f;
    float* wmax = red;              // [8] the warps' maxima, [8] sums
    float* wsum = red + 8;
    for (int ci = 0; ci < n_chunks; ++ci) {
        const int ta = t0 + ci * chunk, n = min(chunk, t1 - ta);
        if (ci > 0) {
            __syncthreads();        // the previous chunk is read
            stage_rows(ta, n);
            cp_async_wait<0>();
            __syncthreads();
        }
        float cm = -INFINITY;
        for (int i = 0; i * CB_GROUPS < n; ++i) {   // the same for the block
            const int lr = rg + i * CB_GROUPS;
            float kv[16];
            row16(k_s + lr * HD + quarter * 16, kv);
            float p4[4] = {0.f, 0.f, 0.f, 0.f};   // four chains in flight
#pragma unroll
            for (int j = 0; j < 16; ++j) p4[j & 3] += qv[j] * kv[j];
            float dot = (p4[0] + p4[1]) + (p4[2] + p4[3]);
            dot += __shfl_xor_sync(FULL, dot, 1);
            dot += __shfl_xor_sync(FULL, dot, 2);
            if (lr < n) {
                const float sc = ta + lr >= n_valid ? NEG
                    : (ks != nullptr ? dot * ks_s[lr] : dot);
                if (quarter == 0) s_sh[lr] = sc;
                cm = fmaxf(cm, sc);
            }
        }
        cm = warp_max(cm);
        if (lane == 0) wmax[warp] = cm;
        __syncthreads();
        float M = m;
#pragma unroll
        for (int w = 0; w < CB_THREADS / 32; ++w) M = fmaxf(M, wmax[w]);
        float p = 0.f;
        if (tid < n) {
            p = expf(s_sh[tid] - M);
            p_sh[tid] = vs != nullptr ? p * vs_s[tid] : p;
        }
        p = warp_sum(p);
        if (lane == 0) wsum[warp] = p;
        const float a = expf(m - M);    // 0 on the first chunk
        acc *= a;
        __syncthreads();
        float lc = 0.f;
#pragma unroll
        for (int w = 0; w < CB_THREADS / 32; ++w) lc += wsum[w];
        l = l * a + lc;
        m = M;
        const CT* vcol = v_s + d;
#pragma unroll 4
        for (int t = dg; t < n; t += CB_THREADS / HD)
            acc += p_sh[t] * elem(vcol + t * HD);
    }
    // the 4 dim groups added in order; the block's (m, l, acc[64])
    // stored into every block of the cluster
    __syncthreads();                // wmax, wsum and the chunk are read
    red[dg * HD + d] = acc;
    __syncthreads();
    {   // as the projection's shares: each group of 64 threads to every
        // 4th block
        const float A = red[d] + red[HD + d] + red[2 * HD + d]
            + red[3 * HD + d];
        for (int rr = dg; rr < C; rr += CB_THREADS / HD) {
            const uint32_t pr = cluster_addr(pall + r * (HD + 4), rr);
            const uint32_t bar = cluster_addr(bar_p, rr);
            if (d == 0) {
                st_async(pr, m, bar);
                st_async(pr + 4, l, bar);
            }
            st_async(pr + 4 * (2 + d), A, bar);
        }
    }
    // every block's (m, l, acc) is in place: each block's weight exp(m -
    // M) once (K1: the current row's too), then the sums in rank order
    mbar_wait(bar_p);
    float* fac = red + 4 * HD;
    if (tid < C) {
        float M = SELF ? *s_cur : -INFINITY;
#pragma unroll
        for (int rr = 0; rr < CB_MAX_CLUSTER; ++rr)
            if (rr < C) M = fmaxf(M, pall[rr * (HD + 4)]);
        fac[tid] = expf(pall[tid * (HD + 4)] - M);  // an empty block: 0
        if (SELF && tid == 0) fac[CB_MAX_CLUSTER] = expf(*s_cur - M);
    }
    __syncthreads();
    if (tid < HD) {
        float L = 0.f, A = 0.f;
#pragma unroll
        for (int rr = 0; rr < CB_MAX_CLUSTER; ++rr)
            if (rr < C) {
                L += pall[rr * (HD + 4) + 1] * fac[rr];
                A += pall[rr * (HD + 4) + 2 + tid] * fac[rr];
            }
        if constexpr (SELF) {
            L += fac[CB_MAX_CLUSTER];
            A += fac[CB_MAX_CLUSTER] * vcur[tid];
        }
        att[tid] = to_f32(from_f32<XT>(A / fmaxf(L, 1e-30f)));
    }
    __syncthreads();

    // 5. this head's share of the o-proj on this block's columns: G groups
    //    of 4 columns, the 64 rows of Wo cut into DS runs, summed in order
    const int ncols = c1 - c0, G = ncols / 4;
    if (G == 0) return;
    const int per = CB_THREADS / G;
    const int DS = per >= 8 ? 8 : per >= 4 ? 4 : per >= 2 ? 2 : 1;
    const int dlen = HD / DS;
    for (int e = tid; e < G * DS; e += CB_THREADS) {
        const int g = e % G, dc = e / G;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        if constexpr (WF::KQ) {
            // the run's byte rows, a group's S (attn . q) - Z sum(attn) at
            // a time (a run lies in one group or holds whole ones)
            constexpr int BRG = WF::SUB / WF::VPB;
            constexpr int GO = HD / WF::SUB;
            const int blen = HD / WF::VPB / DS;
            for (int b0 = dc * blen; b0 < (dc + 1) * blen; b0 += BRG) {
                float dq[4] = {0.f, 0.f, 0.f, 0.f}, as = 0.f;
                for (int br = b0; br < min(b0 + BRG, (dc + 1) * blen);
                     ++br) {
                    const char4 w = *reinterpret_cast<const char4*>(
                        wo_s + br * lay.wo_cols + 4 * g);
                    float dr[4], hs;
                    kq_row4<WF>(w, att + WF::VPB * br, dr, hs);
#pragma unroll
                    for (int j = 0; j < 4; ++j) dq[j] += dr[j];
                    as += hs;
                }
                const int gi = b0 / BRG;
                const float4 S = *reinterpret_cast<const float4*>(
                    wos_s + gi * lay.wo_cols + 4 * g);
                float4 Z = make_float4(0.f, 0.f, 0.f, 0.f);
                if constexpr (WF::ZERO)
                    Z = *reinterpret_cast<const float4*>(
                        wos_s + (GO + gi) * lay.wo_cols + 4 * g);
                a0 += S.x * dq[0] - Z.x * as;
                a1 += S.y * dq[1] - Z.y * as;
                a2 += S.z * dq[2] - Z.z * as;
                a3 += S.w * dq[3] - Z.w * as;
            }
        } else {
            for (int d = dc * dlen; d < (dc + 1) * dlen; ++d) {
                const char4 w = *reinterpret_cast<const char4*>(
                    wo_s + d * lay.wo_cols + 4 * g);
                const float av = att[d];
                a0 += av * (float)w.x;
                a1 += av * (float)w.y;
                a2 += av * (float)w.z;
                a3 += av * (float)w.w;
            }
        }
        float* o = red + dc * ncols + 4 * g;
        o[0] = a0; o[1] = a1; o[2] = a2; o[3] = a3;
    }
    __syncthreads();
    for (int n = tid; n < ncols; n += CB_THREADS) {
        float y = 0.f;
        for (int dc = 0; dc < DS; ++dc) y += red[dc * ncols + n];
        ypart[(size_t)h * D + c0 + n] = y;
    }
    // 6. the last of the H blocks on these columns adds the heads'
    //    partials in head order, then scale (int8), bias and residual
    if (!last_ticket(tickets + r, H, flag)) return;
#pragma unroll
    for (int j = 0; j < CB_RED / CB_THREADS; ++j) {
        const int n = c0 + tid + j * CB_THREADS;
        if (n < c1) {
            float y = 0.f;
            for (int hh = 0; hh < H; ++hh)
                y += __ldcg(ypart + (size_t)hh * D + n);
            if constexpr (WF::KQ)
                x_out[n] = from_f32<XT>(y + ep_b[j] + ep_x[j]);
            else
                x_out[n] = from_f32<XT>(y * ep_s[j] + ep_b[j] + ep_x[j]);
        }
    }
    if (tid == 0) tickets[r] = 0;   // ready for the next launch
}

template <typename XT, typename CT, int KIND, typename WF = WInt8>
int launch_head(const void* x, int D, int H, const float* ln_w,
                const float* ln_b, const int8_t* wq, const float* sq,
                const float* zq, const float* bq, const void* kc,
                const float* ks, const void* vc, const float* vs,
                int n_valid, int n_loop, int C, int rows, int chunk,
                const int8_t* wo, const float* wos, const float* woz,
                const float* wob, void* x_out, float* ypart, int* tickets,
                void* k_row, void* v_row, float* k_scale, float* v_scale,
                float* qkv, cudaStream_t st) {
    const auto kernel = head_block_kernel<XT, CT, KIND, WF>;
    const int smem = head_layout_wf<WF>(D, C, KIND == HB_PROJECT ? 0 : chunk,
                                        sizeof(CT),
                                        KIND == HB_CROSS ? HD : 3 * HD)
        .total;
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
    cfg.gridDim = dim3(C, H);
    cfg.blockDim = dim3(CB_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = C;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    cudaError_t e = cudaLaunchKernelEx(
        &cfg, kernel, static_cast<const XT*>(x), D, ln_w, ln_b, wq, sq, zq,
        bq, static_cast<const CT*>(kc), static_cast<const CT*>(vc), ks, vs,
        n_valid, n_loop, rows, chunk, wo, wos, woz, wob,
        static_cast<XT*>(x_out),
        ypart, tickets, static_cast<CT*>(k_row), static_cast<CT*>(v_row),
        k_scale, v_scale, qkv);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename XT>
int cross_block_t(int cache_dtype, const void* x, int D, int H,
                  const float* ln_w, const float* ln_b, const int8_t* wq,
                  const float* sq, const float* bq, const void* kc,
                  const float* ks, const void* vc, const float* vs,
                  int n_valid, int n_loop, int C, int rows, int chunk,
                  const int8_t* wo, const float* wos, const float* wob,
                  void* x_out, float* ypart, int* tickets, cudaStream_t st) {
    return with_cache_type(cache_dtype, [&](auto ct) {
        using CT = decltype(ct);
        return launch_head<XT, CT, HB_CROSS>(
            x, D, H, ln_w, ln_b, wq, sq, nullptr, bq, kc, ks, vc, vs,
            n_valid, n_loop, C, rows, chunk, wo, wos, nullptr, wob, x_out,
            ypart, tickets, nullptr, nullptr, nullptr, nullptr, nullptr, st);
    });
}

// K13: K2 over the k-quant form FMT (KqW: values, scale and zero planes)
template <int FMT, typename XT>
int cross_block_kq_t(int cache_dtype, const void* x, int D, int H,
                     const float* ln_w, const float* ln_b, KqW wq,
                     const float* bq, const void* kc, const float* ks,
                     const void* vc, const float* vs, int n_valid,
                     int n_loop, int C, int rows, int chunk, KqW wo,
                     const float* wob, void* x_out, float* ypart,
                     int* tickets, cudaStream_t st) {
    return with_cache_type(cache_dtype, [&](auto ct) {
        using CT = decltype(ct);
        return launch_head<XT, CT, HB_CROSS, WKq<FMT>>(
            x, D, H, ln_w, ln_b, wq.q, wq.s, wq.z, bq, kc, ks, vc, vs,
            n_valid, n_loop, C, rows, chunk, wo.q, wo.s, wo.z, wob, x_out,
            ypart, tickets, nullptr, nullptr, nullptr, nullptr, nullptr, st);
    });
}

// K1 (WInt8: sq, wos column scales, zq, woz null) and K12 (WKq<FMT>: the
// planes of the k-quant form): rows < pos are the history; int8 rows take
// two launches (above)
template <typename XT, typename WF = WInt8>
int self_block_t(int cache_dtype, const void* x, int D, int H,
                 const float* ln_w, const float* ln_b, const int8_t* wqkv,
                 const float* sqkv, const float* zqkv, const float* bqkv,
                 const void* kc, const float* ks, const void* vc,
                 const float* vs, int pos, int C, int rows, int chunk,
                 const int8_t* wo, const float* wos, const float* woz,
                 const float* wob, void* x_out, void* k_row, float* k_scale,
                 void* v_row, float* v_scale, float* ypart, int* tickets,
                 float* qkv, cudaStream_t st) {
    return with_cache_type(cache_dtype, [&](auto ct) {
        using CT = decltype(ct);
        if constexpr (std::is_same<CT, int8_t>::value) {
            const int e = launch_head<XT, CT, HB_PROJECT, WF>(
                x, D, H, ln_w, ln_b, wqkv, sqkv, zqkv, bqkv, nullptr,
                nullptr, nullptr, nullptr, 0, 0, C, rows, chunk, nullptr,
                nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                nullptr, nullptr, nullptr, nullptr, qkv, st);
            if (e != 0) return e;
            return launch_head<XT, CT, HB_ATTEND, WF>(
                x, D, H, nullptr, nullptr, nullptr, nullptr, nullptr,
                nullptr, kc, ks, vc, vs, pos, pos, C, rows, chunk, wo, wos,
                woz, wob, x_out, ypart, tickets, k_row, v_row, k_scale,
                v_scale, qkv, st);
        } else {
            return launch_head<XT, CT, HB_SELF, WF>(
                x, D, H, ln_w, ln_b, wqkv, sqkv, zqkv, bqkv, kc, ks, vc,
                vs, pos, pos, C, rows, chunk, wo, wos, woz, wob, x_out,
                ypart, tickets, k_row, v_row, k_scale, v_scale, nullptr, st);
        }
    });
}

// --------------------------------------------------------------------------
// K3 ffn_block, K14: one launch, the hidden layer cut over thread block
// clusters
// --------------------------------------------------------------------------
//
// Grid (C, G) with clusters of (C, 1, 1), C = FB_CLUSTER; block r of
// cluster g owns the U hidden units [U (g C + r), U (g C + r + 1)),
// G C U = 4D (ffn_units chooses U from 4D):
//   - h = LN3(x) over all of D, rounded to x's dtype (every warp takes the
//     statistics itself, as K2);
//   - fc1 on its units: t = h . W1[:, units] * s1 + b1, the D rows cut over
//     the block's threads; g = gelu(t) (exact erf) rounded to x's dtype;
//   - its share of fc2, y_b = g . W2[units, :], over all D columns; the
//     cluster adds its blocks' shares: block r takes the columns
//     [r D / C, (r + 1) D / C) of every block's y_b (st.async into its
//     shared memory, counted by its transaction barrier), in rank order;
//   - the last of the G blocks on a column range to finish (an atomic
//     ticket) adds the clusters' sums in cluster order, then fc2's scale,
//     its bias and the residual.
// The hidden layer never leaves the chip, as in the TPU kernel's VMEM
// accumulator. Each weight byte is read once, by 16-byte cp.async copies
// started as the block starts (W1's slab of U bytes a row, then W2's U
// contiguous rows), so the LayerNorm overlaps W1's copy and fc1 overlaps
// W2's. Every sum runs in a fixed order: two runs give the same bits.
//
// K14 is the same kernel over a k-quant form (WKq<FMT>, as K12 and K13):
// U is whole groups of fc2's input rows (ffn_units_kq: 32 for Q4_K and
// Q5_K, K3's 16 or 32 for Q6_K; whisper-base's Q4_K and Q5_K then take 64
// blocks, and two blocks a unit range, each half of fc1's rows and fc2's
// columns, measured slower there: PERF.md), so a block's W2 rows are
// U / VPB byte rows with their [U / SUB, D] scale (and zero) rows, and its
// W1 slab the U columns of the [D / VPB, Hd] values and of the
// [D / SUB, Hd] planes, all copied as K3 copies its slabs. The group sums
// of the rounded h are taken as the LayerNorm writes it (a warp's 32
// elements are whole groups, summed by shuffles), the rounded g's as the
// GELU writes it; fc1 takes
// each group's S (h . q) - Z sum(h) over whole groups a k-lane, and each
// block's fc2 share carries its own groups' scales and zeros (as each
// head's o-proj partial does in K12 and K13), so the ticket's sum adds
// only the bias and the residual. The weights are widened exactly without
// an int -> float convert (widen4; Q4_K's nibbles, nibbles4).

constexpr int FB_THREADS = 256;
constexpr int FB_WARPS = FB_THREADS / 32;
constexpr int FB_CLUSTER = 8;            // blocks of a cluster
constexpr int FB_MIN_BLOCKS = 96;        // blocks aimed for at least
static_assert(FB_CLUSTER <= CB_MAX_CLUSTER, "K3 takes K1's and K2's tickets");

// hidden units a block takes for a hidden layer of Hd: 32 where that still
// gives FB_MIN_BLOCKS blocks (large-v3: 160), else 16 (whisper-tiny: 96)
inline int ffn_units(int Hd) { return Hd / 32 >= FB_MIN_BLOCKS ? 32 : 16; }

// K14's: K3's, but at least a group of `sub` rows (whole groups of W2's
// rows a block; whisper-base's Q4_K and Q5_K: 64 blocks)
inline int ffn_units_kq(int Hd, int sub) {
    return ffn_units(Hd) > sub ? ffn_units(Hd) : sub;
}

struct FfnLayout {
    int xs, w1, s1, w2, s2, gs, red, g, yall, flag, bars, total;
};

// shared-memory layout of a K3 / K14 block, in bytes (every offset a
// multiple of 16 for D a multiple of 32); k-quant weights (sub > 0): vpb
// values a byte row, `planes` f32 planes (scale, zero) of each group of
// sub rows of W1's slab and of W2's rows, and the groups' sums of h and g
__host__ __device__ inline FfnLayout ffn_layout(int D, int U, int vpb = 1,
                                                int sub = 0, int planes = 0) {
    FfnLayout L;
    int o = 0;
    L.xs = o;   o += D * 4;
    L.w1 = o;   o += D / vpb * U;
    L.s1 = o;   o += sub > 0 ? planes * (D / sub) * U * 4 : 0;
    L.w2 = o;   o += U / vpb * D;
    L.s2 = o;   o += sub > 0 ? planes * (U / sub) * D * 4 : 0;
    L.gs = o;   o += sub > 0 ? 16 * ((D / sub + U / sub + 3) / 4) : 0;
    L.red = o;  o += FB_WARPS * U * 4;    // the warps' fc1 sums
    L.g = o;    o += U * 4;
    L.yall = o; o += D * 4;               // C shares of D / C columns
    L.flag = o; o += 16;
    L.bars = o; o += 16;
    L.total = o;
    return L;
}

template <typename WF>
__host__ __device__ inline FfnLayout ffn_layout_wf(int D, int U) {
    return ffn_layout(D, U, WF::VPB, WF::SUB, WF::PLANES);
}

// d[c] += the k-quant byte row's four columns (one 32-bit word) . their
// inputs h: Q4_K two K values a byte (low nibble h[0], high h[1]), else
// one (h[0]); widened exactly at the FMA rate
template <typename WF>
__device__ __forceinline__ void kq_dot4(uint32_t w, const float* h,
                                        float (&d)[4]) {
    if constexpr (WF::VPB == 2) {
        float lo[4], hi[4];
        nibbles4(w, lo, hi);
        const float h0 = h[0], h1 = h[1];
#pragma unroll
        for (int c = 0; c < 4; ++c) d[c] += h0 * lo[c] + h1 * hi[c];
    } else {
        float v[4];
        widen4(w, v);
        const float h0 = h[0];
#pragma unroll
        for (int c = 0; c < 4; ++c) d[c] += h0 * v[c];
    }
}

// d[c] += the BRG byte rows (a group) from `w` on, rows `pitch` bytes
// apart, four columns a row, against h, from row `rot` on (mod BRG: the
// k-lanes of a warp start on other rows, so other banks)
template <typename WF>
__device__ __forceinline__ void kq_group4(const int8_t* w, int pitch,
                                          const float* h, int rot,
                                          float (&d)[4]) {
    constexpr int BRG = WF::SUB / WF::VPB;
#pragma unroll 8
    for (int i = 0; i < BRG; ++i) {
        const int br = (i + rot) & (BRG - 1);
        kq_dot4<WF>(*reinterpret_cast<const uint32_t*>(w + br * pitch),
                    h + WF::VPB * br, d);
    }
}

// grid (FB_CLUSTER, G), clusters (FB_CLUSTER, 1, 1); see above. K3: WInt8
// (s1 [Hd], s2 [D] column scales, z1 and z2 null); K14: WKq<FMT> (s1, z1
// the [D / SUB, Hd] planes of W1, s2, z2 W2's [Hd / SUB, D]; z1, z2 null
// for Q6_K)
template <typename XT, int U, typename WF = WInt8>
__global__ void __launch_bounds__(FB_THREADS) ffn_block_kernel(
        const XT* __restrict__ x, int D, int Hd,
        const float* __restrict__ ln_w, const float* __restrict__ ln_b,
        const int8_t* __restrict__ w1, const float* __restrict__ s1,
        const float* __restrict__ z1, const float* __restrict__ b1,
        const int8_t* __restrict__ w2, const float* __restrict__ s2,
        const float* __restrict__ z2, const float* __restrict__ b2,
        XT* __restrict__ x_out, float* __restrict__ ypart,
        int* __restrict__ tickets) {
    extern __shared__ __align__(16) unsigned char fb_smem[];
    constexpr int C = FB_CLUSTER;
    constexpr int VPB = WF::VPB;
    const int r = blockIdx.x, cl = blockIdx.y, G = gridDim.y;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const FfnLayout lay = ffn_layout_wf<WF>(D, U);
    const int cols = D / C;                 // the block's column range
    const int j0 = (cl * C + r) * U;        // its first hidden unit
    uint64_t* bar = reinterpret_cast<uint64_t*>(fb_smem + lay.bars);
    if (tid == 0) {                 // every block's share of these columns
        mbar_init_expect(bar, D * 4);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    float* xs = reinterpret_cast<float*>(fb_smem + lay.xs);
    int8_t* w1_s = reinterpret_cast<int8_t*>(fb_smem + lay.w1);    // [D][U]
    int8_t* w2_s = reinterpret_cast<int8_t*>(fb_smem + lay.w2);    // [U][D]
    float* red = reinterpret_cast<float*>(fb_smem + lay.red);
    float* g_s = reinterpret_cast<float*>(fb_smem + lay.g);
    float* yall = reinterpret_cast<float*>(fb_smem + lay.yall);   // [C][cols]
    int* flag = reinterpret_cast<int*>(fb_smem + lay.flag);
    // k-quant: W1's planes [PLANES][D / SUB][U], W2's [PLANES][U / SUB][D],
    // the groups' sums of h [D / SUB] and of g [U / SUB]
    float* s1_s = reinterpret_cast<float*>(fb_smem + lay.s1);
    float* s2_s = reinterpret_cast<float*>(fb_smem + lay.s2);
    float* hsum = reinterpret_cast<float*>(fb_smem + lay.gs);
    float* gsum = hsum + D / (WF::KQ ? WF::SUB : D);

    // 1. load x; copy W1's slab (U bytes of each of the D rows), then W2's
    //    U rows: two groups. Then the epilogue's operands of this block's
    //    columns (any block may finish last)
    float xr[CB_XMAX];
#pragma unroll
    for (int j = 0; j < CB_XMAX; ++j) {
        const int i = tid + j * FB_THREADS;
        xr[j] = i < D ? to_f32(x[i]) : 0.f;
    }
    constexpr int PIECES = U / 16;          // 16-byte copies a row
    for (int e = tid; e < D / VPB * PIECES; e += FB_THREADS) {
        const int k = e / PIECES, c = (e % PIECES) * 16;
        cp_async16(w1_s + k * U + c, w1 + (size_t)k * Hd + j0 + c, 16);
    }
    if constexpr (WF::KQ) {         // its groups' scale (and zero) rows
        constexpr int Q = U / 4;
        const int G1 = D / WF::SUB;
        for (int e = tid; e < WF::PLANES * G1 * Q; e += FB_THREADS) {
            const int pg = e / Q, c = (e % Q) * 4;
            cp_async16(s1_s + pg * U + c, (pg >= G1 ? z1 : s1)
                       + (size_t)(pg % G1) * Hd + j0 + c, 16);
        }
    }
    cp_async_commit();
    const int8_t* w2_rows = w2 + (size_t)(j0 / VPB) * D;
    for (int e = tid; e < U / VPB * D / 16; e += FB_THREADS)
        cp_async16(w2_s + 16 * e, w2_rows + 16 * e, 16);
    if constexpr (WF::KQ) {         // its groups' scale (and zero) rows
        constexpr int G2 = U / WF::SUB;
        const int Q = D / 4;
        for (int e = tid; e < WF::PLANES * G2 * Q; e += FB_THREADS) {
            const int pg = e / Q, c = (e % Q) * 4;
            cp_async16(s2_s + pg * D + c, (pg >= G2 ? z2 : s2)
                       + (size_t)(j0 / WF::SUB + pg % G2) * D + c, 16);
        }
    }
    cp_async_commit();
    const int n_ep = r * cols + tid;        // cols <= FB_THREADS
    float ep_s = 0.f, ep_b = 0.f, ep_x = 0.f;
    if (tid < cols) {
        if constexpr (!WF::KQ) ep_s = s2[n_ep];
        ep_b = b2[n_ep];
        ep_x = to_f32(x[n_ep]);
    }
    float t_s = 0.f, t_b = 0.f;             // fc1's scale and bias
    if (tid < U) {
        if constexpr (!WF::KQ) t_s = s1[j0 + tid];
        t_b = b1[j0 + tid];
    }
#pragma unroll
    for (int j = 0; j < CB_XMAX; ++j) {
        const int i = tid + j * FB_THREADS;
        if (i < D) xs[i] = xr[j];
    }
    __syncthreads();

    // 2. LayerNorm over all of x, rounded to x's dtype (k-quant: and the
    //    groups' sums of it, a warp's 32 elements being whole groups)
    float mean, rstd;
    ln_stats(xs, D, mean, rstd);
    __syncthreads();                // every warp has read x
    for (int i = tid; i < D; i += FB_THREADS) {
        const float hv = (xs[i] - mean) * rstd * ln_w[i] + ln_b[i];
        xs[i] = sizeof(XT) == 2 ? round_bf16(hv) : hv;
        if constexpr (WF::KQ) {
            float s = xs[i];
#pragma unroll
            for (int o = WF::SUB / 2; o > 0; o >>= 1)
                s += __shfl_xor_sync(FULL, s, o);
            if (lane % WF::SUB == 0) hsum[i / WF::SUB] = s;
        }
    }
    cp_async_wait<1>();             // W1's slab has landed
    __syncthreads();

    // 3. fc1 on the block's U units: CG groups of 4 columns, the rows cut
    //    over KL lanes (k-quant: whole groups a lane); the lanes of a warp
    //    summed by shuffles, the warps in order; then the GELU
    {
        constexpr int CG = U / 4, KL = FB_THREADS / CG;
        const int cg = tid % CG, kl = tid / CG;
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        if constexpr (WF::KQ) {
            constexpr int BRG = WF::SUB / VPB;  // byte rows a group
            const int G1 = D / WF::SUB;
            for (int gi = kl; gi < G1; gi += KL) {
                float d[4] = {0.f, 0.f, 0.f, 0.f};
                kq_group4<WF>(w1_s + gi * BRG * U + 4 * cg, U,
                              xs + gi * WF::SUB, kl, d);
                const float4 S = *reinterpret_cast<const float4*>(
                    s1_s + gi * U + 4 * cg);
                float4 Z = make_float4(0.f, 0.f, 0.f, 0.f);
                if constexpr (WF::ZERO)
                    Z = *reinterpret_cast<const float4*>(
                        s1_s + (G1 + gi) * U + 4 * cg);
                const float hs = WF::ZERO ? hsum[gi] : 0.f;
                a[0] += S.x * d[0] - Z.x * hs;
                a[1] += S.y * d[1] - Z.y * hs;
                a[2] += S.z * d[2] - Z.z * hs;
                a[3] += S.w * d[3] - Z.w * hs;
            }
        } else {
#pragma unroll 4
            for (int k = kl; k < D; k += KL) {
                float w[4];
                widen4(*reinterpret_cast<const uint32_t*>(w1_s + k * U
                                                          + 4 * cg), w);
                const float hv = xs[k];
#pragma unroll
                for (int i = 0; i < 4; ++i) a[i] += hv * w[i];
            }
        }
#pragma unroll
        for (int o = CG; o < 32; o <<= 1)
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] += __shfl_xor_sync(FULL, a[i], o);
        if (lane < CG)
#pragma unroll
            for (int i = 0; i < 4; ++i) red[warp * U + 4 * cg + i] = a[i];
    }
    __syncthreads();
    if constexpr (WF::KQ) {
        // U <= 32: warp 0 holds the units, and the groups' sums of the
        // rounded g by shuffles
        if (warp == 0) {
            float gv = 0.f;
            if (lane < U) {
                float t = 0.f;
#pragma unroll
                for (int w = 0; w < FB_WARPS; ++w) t += red[w * U + lane];
                t += t_b;
                gv = 0.5f * t * (1.0f + erff(t * 0.7071067811865475f));
                gv = sizeof(XT) == 2 ? round_bf16(gv) : gv;
                g_s[lane] = gv;
            }
#pragma unroll
            for (int o = WF::SUB / 2; o > 0; o >>= 1)
                gv += __shfl_xor_sync(FULL, gv, o);
            if (lane < U && lane % WF::SUB == 0) gsum[lane / WF::SUB] = gv;
        }
    } else if (tid < U) {
        float t = 0.f;
#pragma unroll
        for (int w = 0; w < FB_WARPS; ++w) t += red[w * U + tid];
        t = t * t_s + t_b;
        const float gv = 0.5f * t * (1.0f + erff(t * 0.7071067811865475f));
        g_s[tid] = sizeof(XT) == 2 ? round_bf16(gv) : gv;
    }
    cp_async_wait<0>();             // W2's rows too
    __syncthreads();

    // 4. the block's share of fc2 over all D columns, 4 columns a thread
    //    (k-quant: its groups' S (g . q) - Z sum(g)); each 4 stored into
    //    the block that owns them (st.async)
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    for (int n4 = tid; n4 < D / 4; n4 += FB_THREADS) {
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        if constexpr (WF::KQ) {
            constexpr int G2 = U / WF::SUB, BRG = WF::SUB / VPB;
#pragma unroll
            for (int gi = 0; gi < G2; ++gi) {
                float d[4] = {0.f, 0.f, 0.f, 0.f};
                kq_group4<WF>(w2_s + gi * BRG * D + 4 * n4, D,
                              g_s + gi * WF::SUB, 0, d);
                const float4 S = *reinterpret_cast<const float4*>(
                    s2_s + gi * D + 4 * n4);
                float4 Z = make_float4(0.f, 0.f, 0.f, 0.f);
                if constexpr (WF::ZERO)
                    Z = *reinterpret_cast<const float4*>(
                        s2_s + (G2 + gi) * D + 4 * n4);
                const float gs = WF::ZERO ? gsum[gi] : 0.f;
                a[0] += S.x * d[0] - Z.x * gs;
                a[1] += S.y * d[1] - Z.y * gs;
                a[2] += S.z * d[2] - Z.z * gs;
                a[3] += S.w * d[3] - Z.w * gs;
            }
        } else {
#pragma unroll 8
            for (int j = 0; j < U; ++j) {
                float w[4];
                widen4(*reinterpret_cast<const uint32_t*>(w2_s + j * D
                                                          + 4 * n4), w);
                const float gv = g_s[j];
#pragma unroll
                for (int i = 0; i < 4; ++i) a[i] += gv * w[i];
            }
        }
        const int dst = 4 * n4 / cols;
        st_async4(cluster_addr(yall + r * cols + 4 * n4 - dst * cols, dst), a,
                  cluster_addr(bar, dst));
    }

    // 5. every block's share of this block's columns is in place: the
    //    cluster's sum, in rank order, to scratch
    mbar_wait(bar);
    if (tid < cols) {
        float y = 0.f;
        for (int rr = 0; rr < C; ++rr) y += yall[rr * cols + tid];
        ypart[(size_t)cl * D + n_ep] = y;
    }

    // 6. the last of the G blocks on these columns adds the clusters' sums
    //    in cluster order, then scale (int8), bias and residual
    if (!last_ticket(tickets + r, G, flag)) return;
    if (tid < cols) {
        float y = 0.f;
        for (int c = 0; c < G; ++c) y += __ldcg(ypart + (size_t)c * D + n_ep);
        if constexpr (WF::KQ)
            x_out[n_ep] = from_f32<XT>(y + ep_b + ep_x);
        else
            x_out[n_ep] = from_f32<XT>(y * ep_s + ep_b + ep_x);
    }
    if (tid == 0) tickets[r] = 0;   // ready for the next launch
}

template <typename XT, int U, typename WF = WInt8>
int launch_ffn(const void* x, int D, int Hd, const float* ln_w,
               const float* ln_b, const int8_t* w1, const float* s1,
               const float* z1, const float* b1, const int8_t* w2,
               const float* s2, const float* z2, const float* b2,
               void* x_out, float* ypart, int* tickets, cudaStream_t st) {
    const auto kernel = ffn_block_kernel<XT, U, WF>;
    const int smem = ffn_layout_wf<WF>(D, U).total;
    static int opted_in = 0;                // the most asked of this kernel
    if (smem > opted_in) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
        opted_in = smem;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(FB_CLUSTER, Hd / (FB_CLUSTER * U));
    cfg.blockDim = dim3(FB_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = FB_CLUSTER;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    cudaError_t e = cudaLaunchKernelEx(
        &cfg, kernel, static_cast<const XT*>(x), D, Hd, ln_w, ln_b, w1, s1,
        z1, b1, w2, s2, z2, b2, static_cast<XT*>(x_out), ypart, tickets);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// K3 (WInt8) and K14 (WKq<FMT>) with U hidden units a block
template <typename XT, typename WF = WInt8>
int ffn_block_t(int U, const void* x, int D, int Hd, const float* ln_w,
                const float* ln_b, const int8_t* w1, const float* s1,
                const float* z1, const float* b1, const int8_t* w2,
                const float* s2, const float* z2, const float* b2,
                void* x_out, float* ypart, int* tickets, cudaStream_t st) {
#define WA_FFN_U(UU)                                                         \
    launch_ffn<XT, UU, WF>(x, D, Hd, ln_w, ln_b, w1, s1, z1, b1, w2, s2, z2, \
                           b2, x_out, ypart, tickets, st)
    switch (U) {
        case 16:
            if constexpr (WF::SUB <= 16) return WA_FFN_U(16);  // whole groups
            return ERR_SHAPE;
        case 32: return WA_FFN_U(32);
        default: return ERR_SHAPE;
    }
#undef WA_FFN_U
}

// K3's and K14's plan: U hidden units a block from Hd, D's and Hd's
// multiples, the shared memory and the 16-byte alignment of the copied
// operands (`bases`: their addresses or'ed)
static bool ffn_plan_ok(int D, int Hd, int U, int smem, uintptr_t bases) {
    return D % (4 * FB_CLUSTER) == 0 && D % 32 == 0
        && D / FB_CLUSTER <= FB_THREADS && D <= FB_THREADS * CB_XMAX
        && Hd >= FB_CLUSTER * U && Hd % (FB_CLUSTER * U) == 0
        && smem <= 227 * 1024 && bases % 16 == 0;
}

}  // namespace
}  // namespace wa

using namespace wa;

// K1's, K2's, K12's and K13's launch plan for n_loop rows of cache_size
// bytes an element and W projected columns a head (k-quant weights: vpb
// values a byte row, `planes` f32 planes a group of sub rows), and the
// 16-byte alignment of the copied operands (`scales`: K12's or K13's four
// planes, or null)
static bool head_plan_ok(int D, int cluster, int rows, int chunk, int n_loop,
                         int cache_dtype, int W, const void* wq,
                         const void* wo, const void* kq, const void* vq,
                         int vpb = 1, int sub = 0, int planes = 0,
                         const void* const* scales = nullptr) {
    const int cache_size = cache_dtype == F32 ? 4
        : cache_dtype == BF16 ? 2 : 1;
    uintptr_t bases = reinterpret_cast<uintptr_t>(wq)
        | reinterpret_cast<uintptr_t>(wo) | reinterpret_cast<uintptr_t>(kq)
        | reinterpret_cast<uintptr_t>(vq);
    for (int i = 0; scales != nullptr && i < 4; ++i)
        bases |= reinterpret_cast<uintptr_t>(scales[i]);
    return D <= CB_THREADS * CB_XMAX && cluster >= 1
        && cluster <= CB_MAX_CLUSTER && rows >= 1
        && (long long)rows * cluster >= n_loop && chunk >= CB_GROUPS
        && chunk <= CB_MAX_CHUNK && chunk % CB_GROUPS == 0
        && head_layout(D, cluster, chunk, cache_size, W, vpb, sub, planes)
               .total <= 227 * 1024
        && 16 * ((D / 16 + cluster - 1) / cluster) <= CB_RED
        && bases % 16 == 0;
}

// K1: the cluster size C, the rows per block and the rows staged at a time
// come from ops/decode_blocks.cross_plan over the pos history rows; ypart
// is f32 [H, D] scratch, tickets int32 [16], zero before the first launch
// (each launch leaves them zero); qkv f32 [3D] scratch for int8 rows, else
// null.
extern "C" int wa_self_block(
        const void* x, int x_dtype, int D, int H, const void* ln_w,
        const void* ln_b, const void* wqkv, const void* sqkv,
        const void* bqkv, const void* kq, const void* ks, const void* vq,
        const void* vs, int cache_dtype, int T, int pos, const void* wo,
        const void* wos, const void* wob, void* x_out, void* k_row,
        void* k_scale, void* v_row, void* v_scale, int cluster, int rows,
        int chunk, void* ypart, void* tickets, void* qkv, void* stream) {
    if (!shape_ok(D, H) || pos < 0 || pos > T
            || !head_plan_ok(D, cluster, rows, chunk, pos, cache_dtype,
                             3 * HD, wqkv, wo, kq, vq))
        return ERR_SHAPE;
    if ((cache_dtype == I8) != (ks != nullptr && vs != nullptr)
            || (cache_dtype == I8 && qkv == nullptr))
        return ERR_DTYPE;
    auto st = static_cast<cudaStream_t>(stream);
#define WA_SELF(XT)                                                          \
    self_block_t<XT>(cache_dtype, x, D, H, (const float*)ln_w,               \
                     (const float*)ln_b, (const int8_t*)wqkv,                \
                     (const float*)sqkv, nullptr, (const float*)bqkv, kq,    \
                     (const float*)ks, vq, (const float*)vs, pos, cluster,   \
                     rows, chunk, (const int8_t*)wo, (const float*)wos,      \
                     nullptr, (const float*)wob, x_out, k_row,               \
                     (float*)k_scale, v_row, (float*)v_scale,                \
                     (float*)ypart, (int*)tickets, (float*)qkv, st)
    if (x_dtype == F32) return WA_SELF(float);
    if (x_dtype == BF16) return WA_SELF(__nv_bfloat16);
#undef WA_SELF
    return ERR_DTYPE;
}

// K2: the cluster size C, the rows per block and the rows staged at a time
// come from ops/decode_blocks.cross_plan; ypart is f32 [H, D] scratch,
// tickets int32 [16], zero before the first launch (each launch leaves
// them zero).
extern "C" int wa_cross_block(
        const void* x, int x_dtype, int D, int H, const void* ln_w,
        const void* ln_b, const void* wq, const void* sq, const void* bq,
        const void* kq, const void* ks, const void* vq, const void* vs,
        int cache_dtype, int T, int enc_len, const void* wo, const void* wos,
        const void* wob, void* x_out, int cluster, int rows, int chunk,
        void* ypart, void* tickets, void* stream) {
    if (!shape_ok(D, H) || T < 1 || enc_len < 0 || enc_len > T)
        return ERR_SHAPE;
    // no valid row at all: every padded row takes part at score NEG
    const int n_loop = enc_len > 0 ? enc_len : T;
    if (!head_plan_ok(D, cluster, rows, chunk, n_loop, cache_dtype, HD, wq,
                      wo, kq, vq))
        return ERR_SHAPE;
    if ((cache_dtype == I8) != (ks != nullptr && vs != nullptr))
        return ERR_DTYPE;
    auto st = static_cast<cudaStream_t>(stream);
#define WA_CROSS(XT)                                                         \
    cross_block_t<XT>(cache_dtype, x, D, H, (const float*)ln_w,              \
                      (const float*)ln_b, (const int8_t*)wq,                 \
                      (const float*)sq, (const float*)bq, kq,                \
                      (const float*)ks, vq, (const float*)vs, enc_len,       \
                      n_loop, cluster, rows, chunk, (const int8_t*)wo,       \
                      (const float*)wos, (const float*)wob, x_out,           \
                      (float*)ypart, (int*)tickets, st)
    if (x_dtype == F32) return WA_CROSS(float);
    if (x_dtype == BF16) return WA_CROSS(__nv_bfloat16);
#undef WA_CROSS
    return ERR_DTYPE;
}

// K13: K2 over k-quant weights, fmt KQ_Q4K ([D/2, D] nibble bytes) or
// KQ_Q5K / KQ_Q6K ([D, D] values) with f32 [D/sub, D] scale planes (and
// zero planes: not Q6_K) for Wq and Wo; biases [D] f32. Caches, plan and
// scratch as wa_cross_block's (the plan from
// ops/decode_blocks_kq.cross_kq_plan).
extern "C" int wa_cross_block_kq(
        const void* x, int x_dtype, int D, int H, int fmt, const void* ln_w,
        const void* ln_b, const void* wq, const void* sq, const void* zq,
        const void* bq, const void* kq, const void* ks, const void* vq,
        const void* vs, int cache_dtype, int T, int enc_len, const void* wo,
        const void* so, const void* zo, const void* bo, void* x_out,
        int cluster, int rows, int chunk, void* ypart, void* tickets,
        void* stream) {
    if (!shape_ok(D, H) || !kq_shape_ok(fmt, D, D) || T < 1 || enc_len < 0
            || enc_len > T)
        return ERR_SHAPE;
    // no valid row at all: every padded row takes part at score NEG
    const int n_loop = enc_len > 0 ? enc_len : T;
    const void* scales[4] = {sq, zq, so, zo};
    if (!head_plan_ok(D, cluster, rows, chunk, n_loop, cache_dtype, HD, wq,
                      wo, kq, vq, fmt == KQ_Q4K ? 2 : 1,
                      fmt == KQ_Q6K ? 16 : 32, fmt == KQ_Q6K ? 1 : 2,
                      scales))
        return ERR_SHAPE;
    if ((cache_dtype == I8) != (ks != nullptr && vs != nullptr)
            || !zeros_ok(fmt, zq) || !zeros_ok(fmt, zo))
        return ERR_DTYPE;
    auto st = static_cast<cudaStream_t>(stream);
    return (int)with_kq_fmt(fmt, [&](auto f) {
        constexpr int FMT = decltype(f)::value;
#define WA_CROSS_KQ(XT)                                                      \
        (cudaError_t)cross_block_kq_t<FMT, XT>(                              \
            cache_dtype, x, D, H, (const float*)ln_w, (const float*)ln_b,    \
            kqw(wq, sq, zq), (const float*)bq, kq, (const float*)ks, vq,     \
            (const float*)vs, enc_len, n_loop, cluster, rows, chunk,         \
            kqw(wo, so, zo), (const float*)bo, x_out, (float*)ypart,         \
            (int*)tickets, st)
        if (x_dtype == F32) return WA_CROSS_KQ(float);
        if (x_dtype == BF16) return WA_CROSS_KQ(__nv_bfloat16);
#undef WA_CROSS_KQ
        return (cudaError_t)ERR_DTYPE;
    });
}

// K12: K1 over k-quant weights, fmt KQ_Q4K ([D/2, 3D] and [D/2, D] nibble
// bytes) or KQ_Q5K / KQ_Q6K ([D, 3D], [D, D] values) with f32 [D/sub, 3D]
// and [D/sub, D] scale planes (and zero planes: not Q6_K) for the QKV and
// Wo; biases [3D], [D] f32. Caches, outputs, plan and scratch as
// wa_self_block's (the plan from ops/decode_blocks_kq.cross_kq_plan).
extern "C" int wa_self_block_kq(
        const void* x, int x_dtype, int D, int H, int fmt, const void* ln_w,
        const void* ln_b, const void* wqkv, const void* sqkv,
        const void* zqkv, const void* bqkv, const void* kq, const void* ks,
        const void* vq, const void* vs, int cache_dtype, int T, int pos,
        const void* wo, const void* so, const void* zo, const void* bo,
        void* x_out, void* k_row, void* k_scale, void* v_row, void* v_scale,
        int cluster, int rows, int chunk, void* ypart, void* tickets,
        void* qkv, void* stream) {
    const void* scales[4] = {sqkv, zqkv, so, zo};
    if (!shape_ok(D, H) || !kq_shape_ok(fmt, D, 3 * D) || pos < 0
            || pos > T
            || !head_plan_ok(D, cluster, rows, chunk, pos, cache_dtype,
                             3 * HD, wqkv, wo, kq, vq, fmt == KQ_Q4K ? 2 : 1,
                             fmt == KQ_Q6K ? 16 : 32, fmt == KQ_Q6K ? 1 : 2,
                             scales))
        return ERR_SHAPE;
    if ((cache_dtype == I8) != (ks != nullptr && vs != nullptr)
            || (cache_dtype == I8 && qkv == nullptr)
            || !zeros_ok(fmt, zqkv) || !zeros_ok(fmt, zo))
        return ERR_DTYPE;
    auto st = static_cast<cudaStream_t>(stream);
    return (int)with_kq_fmt(fmt, [&](auto f) {
        constexpr int FMT = decltype(f)::value;
#define WA_SELF_KQ(XT)                                                       \
        (cudaError_t)self_block_t<XT, WKq<FMT>>(                             \
            cache_dtype, x, D, H, (const float*)ln_w, (const float*)ln_b,    \
            (const int8_t*)wqkv, (const float*)sqkv, (const float*)zqkv,     \
            (const float*)bqkv, kq, (const float*)ks, vq, (const float*)vs,  \
            pos, cluster, rows, chunk, (const int8_t*)wo, (const float*)so,  \
            (const float*)zo, (const float*)bo, x_out, k_row,                \
            (float*)k_scale, v_row, (float*)v_scale, (float*)ypart,          \
            (int*)tickets, (float*)qkv, st)
        if (x_dtype == F32) return WA_SELF_KQ(float);
        if (x_dtype == BF16) return WA_SELF_KQ(__nv_bfloat16);
#undef WA_SELF_KQ
        return (cudaError_t)ERR_DTYPE;
    });
}

// K3's scratch: the f32 elements of ypart, a row of D for each cluster
// (K14's too: its U is at least K3's, so its clusters at most as many)
extern "C" int wa_ffn_scratch(int D, int Hd) {
    return Hd / (FB_CLUSTER * ffn_units(Hd)) * D;
}

// K3: ypart is f32 scratch of wa_ffn_scratch(D, Hd) elements, tickets
// int32 [CB_MAX_CLUSTER] as K1's and K2's, zero before the first launch
// (each launch leaves them zero).
extern "C" int wa_ffn_block(
        const void* x, int x_dtype, int D, int Hd, const void* ln_w,
        const void* ln_b, const void* w1, const void* s1, const void* b1,
        const void* w2, const void* s2, const void* b2, void* x_out,
        void* ypart, void* tickets, void* stream) {
    const uintptr_t bases = reinterpret_cast<uintptr_t>(w1)      // 16-byte
        | reinterpret_cast<uintptr_t>(w2);                       // copies
    const int U = ffn_units(Hd);
    if (!ffn_plan_ok(D, Hd, U, ffn_layout(D, U).total, bases))
        return ERR_SHAPE;
    auto st = static_cast<cudaStream_t>(stream);
#define WA_FFN(XT)                                                           \
    ffn_block_t<XT>(U, x, D, Hd, (const float*)ln_w, (const float*)ln_b,     \
                    (const int8_t*)w1, (const float*)s1, nullptr,            \
                    (const float*)b1, (const int8_t*)w2, (const float*)s2,   \
                    nullptr, (const float*)b2, x_out, (float*)ypart,         \
                    (int*)tickets, st)
    if (x_dtype == F32) return WA_FFN(float);
    if (x_dtype == BF16) return WA_FFN(__nv_bfloat16);
#undef WA_FFN
    return ERR_DTYPE;
}

// K14: K3 over k-quant weights, fmt KQ_Q4K ([D/2, Hd] and [Hd/2, D]
// nibble bytes) or KQ_Q5K / KQ_Q6K ([D, Hd], [Hd, D] values) with f32
// [D/sub, Hd] and [Hd/sub, D] scale planes (and zero planes: not Q6_K);
// biases [Hd], [D] f32. Scratch and tickets as wa_ffn_block's.
extern "C" int wa_ffn_block_kq(
        const void* x, int x_dtype, int D, int Hd, int fmt, const void* ln_w,
        const void* ln_b, const void* w1, const void* s1, const void* z1,
        const void* b1, const void* w2, const void* s2, const void* z2,
        const void* b2, void* x_out, void* ypart, void* tickets,
        void* stream) {
    if (!kq_shape_ok(fmt, D, Hd) || !kq_shape_ok(fmt, Hd, D))
        return ERR_SHAPE;
    if (!zeros_ok(fmt, z1) || !zeros_ok(fmt, z2)) return ERR_DTYPE;
    const int sub = fmt == KQ_Q6K ? 16 : 32, vpb = fmt == KQ_Q4K ? 2 : 1;
    const int planes = fmt == KQ_Q6K ? 1 : 2;
    const int U = ffn_units_kq(Hd, sub);
    const uintptr_t bases = reinterpret_cast<uintptr_t>(w1)
        | reinterpret_cast<uintptr_t>(s1) | reinterpret_cast<uintptr_t>(z1)
        | reinterpret_cast<uintptr_t>(w2) | reinterpret_cast<uintptr_t>(s2)
        | reinterpret_cast<uintptr_t>(z2);
    if (!ffn_plan_ok(D, Hd, U, ffn_layout(D, U, vpb, sub, planes).total,
                     bases))
        return ERR_SHAPE;
    auto st = static_cast<cudaStream_t>(stream);
    return (int)with_kq_fmt(fmt, [&](auto f) {
        constexpr int FMT = decltype(f)::value;
#define WA_FFN_KQ(XT)                                                        \
        (cudaError_t)ffn_block_t<XT, WKq<FMT>>(                              \
            U, x, D, Hd, (const float*)ln_w, (const float*)ln_b,             \
            (const int8_t*)w1, (const float*)s1, (const float*)z1,           \
            (const float*)b1, (const int8_t*)w2, (const float*)s2,           \
            (const float*)z2, (const float*)b2, x_out, (float*)ypart,        \
            (int*)tickets, st)
        if (x_dtype == F32) return WA_FFN_KQ(float);
        if (x_dtype == BF16) return WA_FFN_KQ(__nv_bfloat16);
#undef WA_FFN_KQ
        return (cudaError_t)ERR_DTYPE;
    });
}
