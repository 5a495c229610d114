// Per-block decode kernels for one token of B slots: K5
// self_block_batched and K6 cross_block_batched. (K7 ffn_block_batched
// runs K9's tensor-core kernel in ffn_batched.cu.)
//
// Replace the Pallas kernels of whisper_apr_tpu/ops/decode_blocks.py
// (self_block_batched/_self_kernel_b, cross_block_batched/_cross_kernel_b)
// and compute what K1 and K2 compute, for x [B, D]:
//
//   K5 self_block_batched : LN1 -> QKV int8 matvec x sqkv + bqkv -> each
//       slot's new k/v row in the cache's form -> attention of slot b over
//       ITS rows t < pos[b] plus its current row -> o-proj + bias + resid
//   K6 cross_block_batched: LN2 -> q matvec -> attention of slot b over its
//       cross rows < enc_len (one length for all slots) -> o-proj + resid
//
// What bounds them on the card: the int8 weights of the sub-block (the
// same bytes as at batch 1: large-v3 6.55 MB for K5, 3.3 MB for K6) plus
// every live cache row of every slot (K6 at B=8, large-v3, int8 rows:
// 8 x 1500 x 1280 x 2 bytes = 30.7 MB a layer, the largest part of a
// serving tick). Arithmetic stays at 2B flops a weight byte, far under
// the card's flop/byte ratio: the lever is keeping enough bytes in flight
// on enough SMs, and few serial steps.
//
// K5 and K6 are one kernel, K2's head cluster (decode_blocks.cu) with a
// slot dimension, below. The rows are computed in f32; the JAX kernels'
// bf16 rounding of the k*q and p*v products is not reproduced (bf16
// results agree within the bf16 tolerance; f32 results match).
#include <initializer_list>
#include <type_traits>

#include "attention.cuh"
#include "cluster.cuh"

namespace wa {
namespace {

// --------------------------------------------------------------------------
// K5 and K6: one thread block cluster per (head, slot tile)
// --------------------------------------------------------------------------
//
// Grid (C, H, G) with clusters of (C, 1, 1); ops/decode_blocks.
// batched_plan chooses C, the slots S of a tile (G = ceil(B / S)) and the
// rows staged at a time. Cluster (h, g) does head h's work for the slots
// [g S, g S + S) of the launch; block r of it
//   - projection: sums Wq rows [r D / C, (r + 1) D / C) of the head's 64
//     columns (K6: q_h) or 192 (K5: q_h, k_h, v_h) for every slot of the
//     tile, each weight byte widened once (exactly, as K3) and multiplied
//     into all of them on the CUDA cores (f32 products: exact for f32 and
//     bf16 activations alike); its shares go to every block of the
//     cluster (st.async into distributed shared memory, counted by the
//     receiver's transaction barrier), and each adds the C shares in rank
//     order: every block holds every slot's projection, and forms K5's
//     current rows in the cache's form and their scores (block s % C, the
//     slot's owner, writes the head's 64 elements of slot s out);
//   - attention: the tile's cache rows, slot after slot (slot s: its rows
//     < pos[s] for K5, < n_loop for K6), are cut into C equal runs; block
//     r takes run r, a slot's part of it at a time, staged with 16-byte
//     cp.async in a ring of three chunks, two in flight while one is
//     read (the first copies start as the block starts, under the
//     LayerNorm and the projection). A chunk: its scores by groups of 4
//     threads a row, its max through the warps, weights a row a thread,
//     the weighted V rows 4 dims a thread over every 16th row (a running
//     max and sum across a slot's chunks). The block's (m, l, acc[64]) of
//     each slot (empty for a slot it holds no row of) goes to every
//     block, and each merges the C partials in rank order (K5: then the
//     current row) and rounds the result to x's dtype: two exchanges a
//     call, each block doing the few sums they feed itself;
//   - o-proj: y = sum_h attn_h . Wo[64 h : 64 h + 64, :]; block r takes
//     the columns [16 (r U / C), 16 ((r + 1) U / C)), U = D / 16, for
//     every slot of the tile (each Wo byte read once a tile), writes its
//     head's partial to scratch, and the last of the H blocks of that
//     column range and tile to finish (an atomic ticket) adds the H
//     partials in head order, then the scale, the bias and the residual.
// Every sum runs in a fixed order: two runs give the same bits.
//
// An int8 self cache quantizes each slot's new k and v rows with one
// scale over all D columns, which spans every head's cluster; K5 on int8
// rows is two launches, as K1: BB_PROJECT writes the projection [B, 3D]
// and the largest |k| and |v| of each head's columns [B, H, 2] to
// scratch (no atomics: each value has one writer; the shares of slot s
// go to its owner only); BB_ATTEND reads them back, the scales from the
// maxima over the H heads, and goes on from the current rows.
enum BatchedKind { BB_CROSS = 0, BB_SELF = 1, BB_PROJECT = 2, BB_ATTEND = 3 };

constexpr int BB_THREADS = 256;
constexpr int BB_WARPS = BB_THREADS / 32;
constexpr int BB_GROUPS = BB_THREADS / 4;     // scores: 4 threads a row
constexpr int BB_MAX_CHUNK = BB_THREADS;      // weights: a row a thread
constexpr int BB_MAX_CLUSTER = 16;
constexpr int BB_MAX_SLOTS = 32;       // slots one launch takes
constexpr int BB_PART = HD + 2;               // a partial: m, l, acc[64]
constexpr int BB_RING = 3;                    // chunks of rows staged
constexpr int BB_MAX_HEADS = 32;              // D <= 2048
constexpr int BB_HEAD_LOADS = 8;              // the heads' sum: loads in
                                              // flight a thread
constexpr int BB_VGROUPS = BB_THREADS / (HD / 4);  // rows apart in p.v
constexpr int BB_CUR = 5 * HD + 4;            // K5, a slot: its q, k, v
                                              // [192], kcur, vcur, score,
                                              // int8 row scales
constexpr int BB_MIN_BLOCKS = 3;              // blocks an SM holds: 80
                                              // registers a thread
constexpr unsigned BB_FULL = 0xffffffffu;

// shared-memory layout of a K5 / K6 block, in bytes (every offset a
// multiple of 16); W projected columns (64 or 192), S slots a tile. The
// projection's buffers (hn ... lnst) and the merge's (mine ... accred)
// share their bytes: a block's partials arrive only after every block of
// the cluster has sent its shares, when no block reads its projection
// buffers any more.
struct BatchedLayout {
    int kr, wo_cols, stage;   // most Wq rows / Wo columns a block takes;
                              // bytes of one chunk of the ring
    int cs;                   // floats of a slot's row of cur
    int wo, ring, s, p, qrecv, cur, sqb, wred, slots, hn, wq, red, lnst,
        mine, precv, att, fac, accred, bars, total;
};

__host__ __device__ inline int bb_align(int bytes) {
    return (bytes + 15) & ~15;
}

__host__ __device__ inline BatchedLayout batched_layout(
        int D, int C, int S, int chunk, int cache_size, int W, int kind) {
    const bool proj = kind != BB_ATTEND, att = kind != BB_PROJECT;
    const int own = (S + C - 1) / C;          // slots a block owns, at most
    BatchedLayout L;
    L.kr = (D + C - 1) / C;
    L.wo_cols = 16 * ((D / 16 + C - 1) / C);
    L.stage = att ? 2 * chunk * (HD * cache_size + 4) : 0;
    L.cs = kind == BB_CROSS ? HD : BB_CUR;
    const int vred = BB_VGROUPS * HD, hred = S * 2 * BB_MAX_HEADS;
    int o = 0;
    L.wo = o;     o += bb_align(att ? HD * L.wo_cols : 0);
    L.ring = o;   o += BB_RING * L.stage;     // K, V rows, their scales
    L.s = o;      o += att ? chunk * 4 : 0;   // a chunk's scores
    L.p = o;      o += att ? chunk * 4 : 0;   // and weights
    L.qrecv = o;  o += !proj ? 0              // every block's shares
                      : (att ? C * S : own * C) * W * 4;
    L.cur = o;    o += (att ? S : own) * L.cs * 4;
    L.sqb = o;    o += proj ? 2 * W * 4 : 0;  // the projection's scale, bias
    L.wred = o;   o += 32 * 4;
    L.slots = o;  o += (2 * BB_MAX_SLOTS + 4) * 4;   // rows, first run row
    const int u = o;
    L.hn = o;     o += bb_align(proj ? S * L.kr * 4 : 0);   // LN(x) rows
    L.wq = o;     o += bb_align(proj ? L.kr * W : 0);
    L.red = o;    o += proj ? S * W * 4 : 0;  // the block's shares
    L.lnst = o;   o += proj ? 2 * BB_MAX_SLOTS * 4 : 0;
    const int early = o;
    o = u;
    L.mine = o;   o += att ? bb_align(S * BB_PART * 4) : 0;  // partials
    L.precv = o;  o += att ? bb_align(C * S * BB_PART * 4) : 0;
    L.att = o;    o += att ? S * HD * 4 : 0;  // the tile's attention
    L.fac = o;    o += att ? bb_align(S * (BB_MAX_CLUSTER + 1) * 4) : 0;
    L.accred = o; o += att ? (vred > hred ? vred : hred) * 4 : 0;
    if (o < early) o = early;
    L.bars = o;   o += 2 * 8;
    L.total = o;
    return L;
}

// 16 bytes of x (16-byte aligned) as f32: 4 f32 or 8 bf16 elements
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&v)[8]) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        v[2 * j] = __uint_as_float(w[j] << 16);
        v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
}

// The tile's rows as one run, slot after slot: slot s holds
// [pre[s], pre[s] + nrow[s]). A block walks its part [f0, f1) of it a
// chunk at a time, never across a slot's end.
struct RowCursor {
    int s, t, end;            // slot (S: done), its next row, its end here
};
struct RowItem {
    int s, t, n;              // slot, first row, rows (0: none left)
};

__device__ __forceinline__ RowCursor cursor_at(const int* nrow,
                                               const int* pre, int S,
                                               int f0, int f1) {
    RowCursor c{0, 0, 0};
    while (c.s < S && pre[c.s] + nrow[c.s] <= f0) ++c.s;
    if (c.s < S && pre[c.s] < f1) {
        c.t = f0 - pre[c.s];
        c.end = min(nrow[c.s], f1 - pre[c.s]);
    } else {
        c.s = S;
    }
    return c;
}

__device__ __forceinline__ RowItem cursor_take(RowCursor& c, const int* nrow,
                                               const int* pre, int S, int f1,
                                               int chunk) {
    if (c.s >= S) return RowItem{0, 0, 0};
    const RowItem it{c.s, c.t, min(chunk, c.end - c.t)};
    c.t += it.n;
    if (c.t >= c.end) {                       // on to the next slot's rows
        ++c.s;
        while (c.s < S && nrow[c.s] == 0) ++c.s;
        if (c.s < S && pre[c.s] < f1) {
            c.t = 0;
            c.end = min(nrow[c.s], f1 - pre[c.s]);
        } else {
            c.s = S;
        }
    }
    return it;
}

// grid (C, H, G), clusters (C, 1, 1); see above. K6: BB_CROSS; K5:
// BB_SELF (f32, bf16 and fp8 rows), or BB_PROJECT then BB_ATTEND (int8)
template <typename XT, typename CT, int KIND>
__global__ void __launch_bounds__(BB_THREADS, BB_MIN_BLOCKS)
batched_block_kernel(
        const XT* __restrict__ x, int B, int D,
        const float* __restrict__ ln_w, const float* __restrict__ ln_b,
        const int8_t* __restrict__ wq, const float* __restrict__ sq,
        const float* __restrict__ bq, const CT* __restrict__ kc,
        const CT* __restrict__ vc, const float* __restrict__ ks,
        const float* __restrict__ vs, int T, const int* __restrict__ pos,
        int n_valid, int n_loop, int S, int chunk,
        const int8_t* __restrict__ wo, const float* __restrict__ wos,
        const float* __restrict__ wob, XT* __restrict__ x_out,
        float* __restrict__ ypart, int* __restrict__ tickets,
        CT* __restrict__ k_row, CT* __restrict__ v_row,
        float* __restrict__ k_scale, float* __restrict__ v_scale,
        float* __restrict__ qkv, float* __restrict__ hmax) {
    constexpr bool I8 = std::is_same<CT, int8_t>::value;
    constexpr bool SELF = KIND != BB_CROSS;
    constexpr bool PROJ = KIND != BB_ATTEND;  // computes the projection
    constexpr bool ATT = KIND != BB_PROJECT;  // attends and projects out
    constexpr bool CUR = KIND == BB_SELF || KIND == BB_ATTEND;
    constexpr int NP = SELF ? 3 : 1;          // 64-column pieces: q (k, v)
    constexpr int W = NP * HD;
    extern __shared__ __align__(16) unsigned char bb_smem[];
    const int C = gridDim.x, r = blockIdx.x, h = blockIdx.y, H = gridDim.y;
    const int g = blockIdx.z, b0 = g * S, Sg = min(S, B - b0);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const BatchedLayout lay = batched_layout(D, C, S, chunk, sizeof(CT), W,
                                             KIND);
    const int cs = lay.cs;
    const int n_own = r < Sg ? (Sg - 1 - r) / C + 1 : 0;  // r, r + C, ...
    // the exchanges' barriers: every block's shares of the projection
    // (BB_PROJECT: of the owned slots only) and every block's partials; a
    // block stores into the others only once all have set theirs up
    uint64_t* bar_proj = reinterpret_cast<uint64_t*>(bb_smem + lay.bars);
    uint64_t* bar_part = bar_proj + 1;
    if (tid == 0) {
        if (PROJ)
            mbar_init_expect(bar_proj, (ATT ? Sg : n_own) * C * W * 4);
        if (ATT) mbar_init_expect(bar_part, Sg * C * BB_PART * 4);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    // BB_PROJECT: BB_ATTEND's blocks may start now, on the SMs this grid
    // leaves free, and wait for its results where they read them
    if constexpr (KIND == BB_PROJECT)
        asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    float* hn = reinterpret_cast<float*>(bb_smem + lay.hn);      // [S][kr]
    int8_t* wq_s = reinterpret_cast<int8_t*>(bb_smem + lay.wq);  // [kr][W]
    int8_t* wo_s = reinterpret_cast<int8_t*>(bb_smem + lay.wo);
    float* s_sh = reinterpret_cast<float*>(bb_smem + lay.s);
    float* p_sh = reinterpret_cast<float*>(bb_smem + lay.p);
    float* red = reinterpret_cast<float*>(bb_smem + lay.red);    // [S][W]
    float* lnst = reinterpret_cast<float*>(bb_smem + lay.lnst);  // [S][2]
    float* qrecv = reinterpret_cast<float*>(bb_smem + lay.qrecv);
    float* cur = reinterpret_cast<float*>(bb_smem + lay.cur);    // [S][cs]
    float* mine = reinterpret_cast<float*>(bb_smem + lay.mine);
    float* precv = reinterpret_cast<float*>(bb_smem + lay.precv);
    float* attall = reinterpret_cast<float*>(bb_smem + lay.att);  // [S][HD]
    float* fac = reinterpret_cast<float*>(bb_smem + lay.fac);
    float* wred = reinterpret_cast<float*>(bb_smem + lay.wred);
    float* accred = reinterpret_cast<float*>(bb_smem + lay.accred);
    float* sqb_s = reinterpret_cast<float*>(bb_smem + lay.sqb);  // [2][W]
    int* nrow = reinterpret_cast<int*>(bb_smem + lay.slots);
    int* pre = nrow + BB_MAX_SLOTS;
    int* total_p = pre + BB_MAX_SLOTS;
    int* flag = total_p + 1;

    // this block's shares of Wq's rows and Wo's columns
    const int k0 = r * D / C, k1 = (r + 1) * D / C, kn = k1 - k0;
    const int U = D / 16;
    const int c0 = 16 * (r * U / C), c1 = 16 * ((r + 1) * U / C);

    // 1. the slots' rows and where each starts in the tile's run (warp
    //    0: a slot a lane, a scan); copies: Wq's rows, Wo's columns; the
    //    first chunks of rows only once x is read (step 2), which would
    //    queue behind them
    if (ATT && warp == 0) {
        int n = 0;
        if (lane < Sg) n = SELF ? min(max(pos[b0 + lane], 0), T) : n_loop;
        int inc = n;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(BB_FULL, inc, o);
            if (lane >= o) inc += v;
        }
        nrow[lane] = n;
        pre[lane] = inc - n;
        if (lane == 31) *total_p = inc;
    }
    if constexpr (PROJ) {
        for (int e = tid; e < kn * 4 * NP; e += BB_THREADS) {
            const int row = e / (4 * NP), pc = e % (4 * NP);
            const int c = (pc >> 2) * HD + (pc & 3) * 16;  // piece, 16 bytes
            cp_async16(wq_s + row * W + c, wq + (size_t)(k0 + row) * NP * D
                       + (pc >> 2) * D + h * HD + (pc & 3) * 16, 16);
        }
        for (int e = tid; e < 2 * NP * 16; e += BB_THREADS) {  // 16 bytes
            const int pc = e % (NP * 16), c = 4 * (pc % 16);
            const size_t col = (size_t)(pc / 16) * D + h * HD + c;
            cp_async16(sqb_s + (e / (NP * 16)) * W + (pc / 16) * HD + c,
                       (e < NP * 16 ? sq : bq) + col, 16);
        }
    }
    cp_async_commit();
    if constexpr (ATT) {
        const int wo_pieces = (c1 - c0) / 16;
        for (int e = tid; e < HD * wo_pieces; e += BB_THREADS) {
            const int d = e / wo_pieces, c = (e % wo_pieces) * 16;
            cp_async16(wo_s + d * lay.wo_cols + c,
                       wo + (size_t)(h * HD + d) * D + c0 + c, 16);
        }
    }
    cp_async_commit();
    __syncthreads();

    if constexpr (PROJ) {
        // 2. LayerNorm statistics, a slot a warp (two passes over x, as
        //    ln_stats); the block's rows of LN(x) rounded to x's dtype
        constexpr int XV = 16 / (int)sizeof(XT);   // x elements a load
        for (int s = warp; s < Sg; s += BB_WARPS) {
            const XT* xr = x + (size_t)(b0 + s) * D;
            float sum = 0.f;
            for (int i = XV * lane; i < D; i += 32 * XV) {
                float v[XV];
                load16(xr + i, v);
#pragma unroll
                for (int j = 0; j < XV; ++j) sum += v[j];
            }
            const float mean = warp_sum(sum) / (float)D;
            float var = 0.f;
            for (int i = XV * lane; i < D; i += 32 * XV) {
                float v[XV];
                load16(xr + i, v);
#pragma unroll
                for (int j = 0; j < XV; ++j) {
                    const float dv = v[j] - mean;
                    var += dv * dv;
                }
            }
            const float rstd = rsqrtf(warp_sum(var) / (float)D + LN_EPS);
            if (lane == 0) {
                lnst[2 * s] = mean;
                lnst[2 * s + 1] = rstd;
            }
        }
        __syncthreads();
        for (int e = tid; e < Sg * kn; e += BB_THREADS) {
            const int s = e / kn, k = k0 + e % kn;
            const float hv = (to_f32(x[(size_t)(b0 + s) * D + k])
                              - lnst[2 * s]) * lnst[2 * s + 1] * ln_w[k]
                + ln_b[k];
            hn[s * lay.kr + k - k0] = sizeof(XT) == 2 ? round_bf16(hv) : hv;
        }
    }

    // the ring: chunk i of this block's rows in buffer i % BB_RING
    constexpr int PER_ROW = HD * (int)sizeof(CT) / 16;   // 16-byte pieces
    constexpr int EL = 16 / (int)sizeof(CT);
    auto ring_k = [&](int buf) {
        return reinterpret_cast<CT*>(bb_smem + lay.ring + buf * lay.stage);
    };
    auto ring_v = [&](int buf) { return ring_k(buf) + chunk * HD; };
    auto ring_ks = [&](int buf) {
        return reinterpret_cast<float*>(ring_k(buf) + 2 * chunk * HD);
    };
    auto stage = [&](const RowItem& it, int buf) {
        if (it.n > 0) {
            CT* k_s = ring_k(buf);
            CT* v_s = ring_v(buf);
            const size_t row0 = (size_t)(b0 + it.s) * T + it.t;
            for (int e = tid; e < it.n * PER_ROW; e += BB_THREADS) {
                const int row = e / PER_ROW, c = (e % PER_ROW) * EL;
                const size_t src = (row0 + row) * D + h * HD + c;
                cp_async16(k_s + row * HD + c, kc + src, 16);
                cp_async16(v_s + row * HD + c, vc + src, 16);
            }
            if (ks != nullptr) {
                float* ks_s = ring_ks(buf);
                for (int e = tid; e < it.n; e += BB_THREADS) {
                    cp_async4(ks_s + e, ks + row0 + e);
                    cp_async4(ks_s + chunk + e, vs + row0 + e);
                }
            }
        }
        cp_async_commit();
    };
    RowCursor at_stage{0, 0, 0}, at_comp{0, 0, 0};
    int f1 = 0;
    if constexpr (ATT) {
        const int total = *total_p, run = (total + C - 1) / C;
        const int f0 = min(total, r * run);
        f1 = min(total, f0 + run);
        at_stage = cursor_at(nrow, pre, Sg, f0, f1);
        at_comp = at_stage;
        for (int i = 0; i < BB_RING - 1; ++i)
            stage(cursor_take(at_stage, nrow, pre, Sg, f1, chunk), i);
    } else {
        for (int i = 0; i < BB_RING - 1; ++i) cp_async_commit();
    }
    if constexpr (KIND == BB_ATTEND) {
        // BB_PROJECT's results, once it has finished: every slot's q, k, v
        // of the head into cur, every head's max |k|, |v| of the tile into
        // accred
        asm volatile("griddepcontrol.wait;\n" ::: "memory");
        for (int e = tid; e < Sg * 3 * 16; e += BB_THREADS) {
            const int s = e / 48, pc = e % 48;
            cp_async16(cur + s * cs + 4 * pc, qkv + (size_t)(b0 + s) * 3 * D
                       + (pc / 16) * D + h * HD + 4 * (pc % 16), 16);
        }
        for (int e = tid; e < Sg * 2 * H; e += BB_THREADS)
            cp_async4(accred + e, hmax + (size_t)b0 * H * 2 + e);
        cp_async_commit();
    }

    if constexpr (PROJ) {
        cp_async_wait<BB_RING>();             // Wq's rows have landed
        __syncthreads();

        // 3. the block's share for every slot: items of 4 columns x 4
        //    slots (each weight word widened once for 4 slots), the rows
        //    cut over KL neighbouring lanes of a warp (KL a power of two),
        //    summed by a fixed tree of shuffles
        constexpr int NCG = W / 4;
        const int NI = NCG * ((Sg + 3) / 4);
        int KL = 1;
        while (KL < 16 && 2 * KL * NI <= BB_THREADS) KL *= 2;
        for (int e = tid; e < KL * NI; e += BB_THREADS) {
            const int item = e / KL, kl = e % KL;
            const int cg = item % NCG, s0 = 4 * (item / NCG);
            float a[4][4] = {};
            const float* h0 = hn + min(s0, Sg - 1) * lay.kr;
            const float* h1 = hn + min(s0 + 1, Sg - 1) * lay.kr;
            const float* h2 = hn + min(s0 + 2, Sg - 1) * lay.kr;
            const float* h3 = hn + min(s0 + 3, Sg - 1) * lay.kr;
            for (int k = kl; k < kn; k += KL) {
                float w4[4];
                widen4(*reinterpret_cast<const uint32_t*>(
                           wq_s + k * W + 4 * cg), w4);
                const float hv[4] = {h0[k], h1[k], h2[k], h3[k]};
#pragma unroll
                for (int j = 0; j < 4; ++j)
#pragma unroll
                    for (int i = 0; i < 4; ++i) a[j][i] += hv[j] * w4[i];
            }
            for (int o = 1; o < KL; o <<= 1)
#pragma unroll
                for (int j = 0; j < 4; ++j)
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        a[j][i] += __shfl_xor_sync(BB_FULL, a[j][i], o);
            if (kl == 0)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    if (s0 + j < Sg) {
                        float* o = red + (s0 + j) * W + 4 * cg;
#pragma unroll
                        for (int i = 0; i < 4; ++i) o[i] = a[j][i];
                    }
        }
        __syncthreads();

        // 4. the shares to every block of the cluster (BB_PROJECT: to the
        //    slot's owner); each adds the C shares in rank order, then the
        //    scale and the bias
        asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
        for (int e = tid; e < Sg * NCG * (ATT ? C : 1); e += BB_THREADS) {
            const int s = e % Sg, c = 4 * (e / Sg % NCG);
            const int to = ATT ? e / (Sg * NCG) : s % C;
            const float4 f = *reinterpret_cast<const float4*>(
                red + s * W + c);
            const float v[4] = {f.x, f.y, f.z, f.w};
            const int at = ATT ? r * S + s : (s / C) * C + r;
            st_async4(cluster_addr(qrecv + at * W + c, to), v,
                      cluster_addr(bar_proj, to));
        }
        if (ATT || n_own > 0) mbar_wait_bounded(bar_proj);
        const int n_sum = ATT ? Sg : n_own;   // slots summed here
        for (int e = tid; e < n_sum * W; e += BB_THREADS) {
            const int j = e / W, c = e % W;
            float q = 0.f;
            for (int rr = 0; rr < C; ++rr)
                q += qrecv[(ATT ? rr * S + j : j * C + rr) * W + c];
            cur[j * cs + c] = q * sqb_s[c] + sqb_s[W + c];
        }
        __syncthreads();
        if constexpr (KIND == BB_PROJECT) {
            for (int j = 0; j < n_own; ++j) {
                const int b = b0 + r + j * C;
                const float* cj = cur + j * cs;
                if (tid < W)
                    qkv[(size_t)b * 3 * D + (tid / HD) * D + h * HD
                        + tid % HD] = cj[tid];
                if (warp < 2) {          // warp 0: max |k|, warp 1: max |v|
                    const float* p = cj + (1 + warp) * HD + 2 * lane;
                    const float mx = warp_max(fmaxf(fabsf(p[0]),
                                                    fabsf(p[1])));
                    if (lane == 0) hmax[((size_t)b * H + h) * 2 + warp] = mx;
                }
            }
            return;
        }
    } else {
        // BB_ATTEND: the int8 rows' scales from the heads' maxima
        cp_async_wait<0>();                   // BB_PROJECT's results too
        __syncthreads();
        if (tid < 2 * Sg) {
            const int s = tid / 2, kv = tid % 2;
            float mx = 0.f;
            for (int hh = 0; hh < H; ++hh)
                mx = fmaxf(mx, accred[(s * H + hh) * 2 + kv]);
            cur[s * cs + 5 * HD + 1 + kv] = fmaxf(mx, 1e-12f) / 127.f;
        }
        __syncthreads();
    }

    // 5. K5: every slot's current row in the cache's form (its owner
    //    writes the head's 64 elements out), as attention reads it, and
    //    its score, as K1's current_row
    if constexpr (CUR) {
        for (int e = tid; e < Sg * HD; e += BB_THREADS) {
            const int s = e / HD, d = e % HD;
            float* cj = cur + s * cs;
            const float k = cj[HD + d], v = cj[2 * HD + d];
            CT kr, vr;
            float kcur, vcur;
            if constexpr (I8) {
                const float ksc = cj[5 * HD + 1], vsc = cj[5 * HD + 2];
                const float k8 = fminf(fmaxf(rintf(k / ksc), -127.f),
                                       127.f);
                const float v8 = fminf(fmaxf(rintf(v / vsc), -127.f),
                                       127.f);
                kr = (int8_t)k8;
                vr = (int8_t)v8;
                kcur = k8 * ksc;
                vcur = v8 * vsc;
            } else {
                kr = from_f32<CT>(k);
                vr = from_f32<CT>(v);
                kcur = to_f32(kr);
                vcur = to_f32(vr);
            }
            cj[3 * HD + d] = kcur;
            cj[4 * HD + d] = vcur;
            if (s % C == r) {
                const size_t at = (size_t)(b0 + s) * D + h * HD + d;
                k_row[at] = kr;
                v_row[at] = vr;
                if (h == 0 && d == 0) {
                    k_scale[b0 + s] = I8 ? cj[5 * HD + 1] : 1.f;
                    v_scale[b0 + s] = I8 ? cj[5 * HD + 2] : 1.f;
                }
            }
        }
        __syncthreads();
        for (int s = warp; s < Sg; s += BB_WARPS) {
            const float* cj = cur + s * cs;
            float sc = (cj[2 * lane] * QSCALE) * cj[3 * HD + 2 * lane]
                + (cj[2 * lane + 1] * QSCALE) * cj[3 * HD + 2 * lane + 1];
            sc = warp_sum(sc);
            if (lane == 0) cur[s * cs + 5 * HD] = sc;
        }
        __syncthreads();
    }

    // every slot's partial empty until this block's rows of it are done
    // (mine shares its bytes with the projection's buffers)
    for (int e = tid; e < Sg * BB_PART; e += BB_THREADS)
        mine[e] = e % BB_PART == 0 ? -INFINITY : 0.f;

    // 6. attention over this block's rows, a chunk at a time: a running
    //    max m and sum l per slot (the same in every thread) and acc of 4
    //    of the 64 dims over every 16th row; a slot's (m, l, acc) into
    //    mine once its rows here are done
    const int quarter = tid & 3, rg = tid >> 2;
    const int d4 = 4 * (tid & (HD / 4 - 1)), vg = tid / (HD / 4);
    float qv[16];
    float m = -INFINITY, l = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
    int slot = -1, buf = 0;
    auto flush = [&]() {
        *reinterpret_cast<float4*>(accred + vg * HD + d4) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
        __syncthreads();
        if (tid < HD) {
            float A = 0.f;
#pragma unroll
            for (int vgi = 0; vgi < BB_VGROUPS; ++vgi)
                A += accred[vgi * HD + tid];
            mine[slot * BB_PART + 2 + tid] = A;
            if (tid == 0) {
                mine[slot * BB_PART] = m;
                mine[slot * BB_PART + 1] = l;
            }
        }
    };
    for (;;) {
        const RowItem it = cursor_take(at_comp, nrow, pre, Sg, f1, chunk);
        if (it.n == 0) break;
        cp_async_wait<BB_RING - 2>();
        __syncthreads();          // the chunk has landed, the last is read
        stage(cursor_take(at_stage, nrow, pre, Sg, f1, chunk),
              buf == 0 ? BB_RING - 1 : buf - 1);
        if (it.s != slot) {
            if (slot >= 0) flush();
            slot = it.s;
            m = -INFINITY;
            l = 0.f;
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i] = 0.f;
#pragma unroll
            for (int j = 0; j < 16; ++j)
                qv[j] = cur[slot * cs + quarter * 16 + j] * QSCALE;
        }
        const CT* k_s = ring_k(buf);
        const CT* v_s = ring_v(buf);
        const float* ks_s = ring_ks(buf);
        const float* vs_s = ks_s + chunk;
        const int n = it.n, ta = it.t;
        const int valid = SELF ? nrow[slot] : n_valid;
        float cm = -INFINITY;
        for (int i = 0; i * BB_GROUPS < n; ++i) {   // the same for the block
            const int lr = rg + i * BB_GROUPS;
            float kv[16];
            row16(k_s + lr * HD + quarter * 16, kv);
            float p4[4] = {0.f, 0.f, 0.f, 0.f};   // four chains in flight
#pragma unroll
            for (int j = 0; j < 16; ++j) p4[j & 3] += qv[j] * kv[j];
            float dot = (p4[0] + p4[1]) + (p4[2] + p4[3]);
            dot += __shfl_xor_sync(BB_FULL, dot, 1);
            dot += __shfl_xor_sync(BB_FULL, dot, 2);
            if (lr < n) {
                const float sc = ta + lr >= valid ? NEG
                    : (ks != nullptr ? dot * ks_s[lr] : dot);
                if (quarter == 0) s_sh[lr] = sc;
                cm = fmaxf(cm, sc);
            }
        }
        cm = warp_max(cm);
        if (lane == 0) wred[warp] = cm;
        __syncthreads();
        float M = m;
#pragma unroll
        for (int w = 0; w < BB_WARPS; ++w) M = fmaxf(M, wred[w]);
        float p = 0.f;
        if (tid < n) {
            p = expf(s_sh[tid] - M);
            p_sh[tid] = vs != nullptr ? p * vs_s[tid] : p;
        }
        p = warp_sum(p);
        if (lane == 0) wred[BB_WARPS + warp] = p;
        const float a = expf(m - M);          // 0 on a slot's first chunk
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] *= a;
        __syncthreads();
        float lc = 0.f;
#pragma unroll
        for (int w = 0; w < BB_WARPS; ++w) lc += wred[BB_WARPS + w];
        l = l * a + lc;
        m = M;
        const CT* vcol = v_s + d4;
#pragma unroll 4
        for (int t = vg; t < n; t += BB_VGROUPS) {
            float v4[4];
            row4(vcol + t * HD, v4);
            const float pt = p_sh[t];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i] += pt * v4[i];
        }
        buf = buf == BB_RING - 1 ? 0 : buf + 1;
    }
    if (slot >= 0) flush();
    cp_async_wait<0>();                       // Wo's columns too
    __syncthreads();

    // 7. every slot's partial to every block of the cluster; each merges
    //    them in rank order (K5: then the current row) and rounds the
    //    result to x's dtype: every block holds the tile's attention
    if constexpr (!PROJ)
        asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    for (int e = tid; e < Sg * BB_PART * C; e += BB_THREADS) {
        const int i = e % (Sg * BB_PART), to = e / (Sg * BB_PART);
        st_async(cluster_addr(precv + r * S * BB_PART + i, to), mine[i],
                 cluster_addr(bar_part, to));
    }
    mbar_wait_bounded(bar_part);
    constexpr int FS = BB_MAX_CLUSTER + 1;    // fac: [S][C ranks, current]
    if (tid < Sg) {
        const float* cj = cur + tid * cs;
        float M = CUR ? cj[5 * HD] : -INFINITY;
        for (int rr = 0; rr < C; ++rr)
            M = fmaxf(M, precv[(rr * S + tid) * BB_PART]);
        for (int rr = 0; rr < C; ++rr)        // an empty partial: 0
            fac[tid * FS + rr] = expf(precv[(rr * S + tid) * BB_PART] - M);
        if (CUR) fac[tid * FS + BB_MAX_CLUSTER] = expf(cj[5 * HD] - M);
    }
    __syncthreads();
    for (int e = tid; e < Sg * HD; e += BB_THREADS) {
        const int s = e / HD, d = e % HD;
        float L = 0.f, A = 0.f;
        for (int rr = 0; rr < C; ++rr) {
            const float* pj = precv + (rr * S + s) * BB_PART;
            L += pj[1] * fac[s * FS + rr];
            A += pj[2 + d] * fac[s * FS + rr];
        }
        if constexpr (CUR) {
            const float fc = fac[s * FS + BB_MAX_CLUSTER];
            L += fc;
            A += fc * cur[s * cs + 4 * HD + d];
        }
        attall[e] = to_f32(from_f32<XT>(A / fmaxf(L, 1e-30f)));
    }
    __syncthreads();

    // 8. this head's share of the o-proj on this block's columns for
    //    every slot of the tile: items of 4 columns, the 64 rows of Wo cut
    //    into DS runs over neighbouring lanes (DS a power of two, as many
    //    as keep the threads busy), summed by a fixed tree of shuffles
    const int ncols = c1 - c0, G4 = ncols / 4;
    if (G4 == 0) return;
    int DS = 1;
    while (DS < 8 && 2 * DS * Sg * G4 <= BB_THREADS) DS *= 2;
    const int dlen = HD / DS, n_e = Sg * G4 * DS;
    // whole warps take part in the shuffles: a lane past n_e sums item 0
    // again and stores nothing
    for (int e = tid; e < (n_e + 31) / 32 * 32; e += BB_THREADS) {
        const int item = e < n_e ? e / DS : 0, ds = e % DS;
        const int s = item / G4, q4 = item % G4;
        const float* av = attall + s * HD;
        float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
        for (int dd = ds * dlen; dd < (ds + 1) * dlen; ++dd) {
            float w4[4];
            widen4(*reinterpret_cast<const uint32_t*>(
                       wo_s + dd * lay.wo_cols + 4 * q4), w4);
            const float v = av[dd];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] += v * w4[i];
        }
        for (int o = 1; o < DS; o <<= 1)
#pragma unroll
            for (int i = 0; i < 4; ++i)
                a[i] += __shfl_xor_sync(BB_FULL, a[i], o);
        if (ds == 0 && e < n_e)
            *reinterpret_cast<float4*>(ypart + ((size_t)h * B + b0 + s) * D
                                       + c0 + 4 * q4) =
                make_float4(a[0], a[1], a[2], a[3]);
    }
    // 9. the last of the H blocks on these columns and slots adds the
    //    heads' partials in head order, 4 columns a thread with
    //    BB_HEAD_LOADS heads' loads in flight at a time, then scale, bias
    //    and residual
    int* ticket = tickets + g * C + r;
    if (!last_ticket(ticket, H, flag)) return;
    for (int e = tid; e < Sg * G4; e += BB_THREADS) {
        const int s = e / G4, n = c0 + 4 * (e % G4);
        const size_t row = (size_t)(b0 + s) * D + n;
        const float* yp = ypart + row;
        float y[4] = {0.f, 0.f, 0.f, 0.f};
        for (int h0 = 0; h0 < H; h0 += BB_HEAD_LOADS) {
            float4 v[BB_HEAD_LOADS];
#pragma unroll
            for (int j = 0; j < BB_HEAD_LOADS; ++j)
                if (h0 + j < H)
                    v[j] = __ldcg(reinterpret_cast<const float4*>(
                        yp + (size_t)(h0 + j) * B * D));
#pragma unroll
            for (int j = 0; j < BB_HEAD_LOADS; ++j)
                if (h0 + j < H) {
                    y[0] += v[j].x;
                    y[1] += v[j].y;
                    y[2] += v[j].z;
                    y[3] += v[j].w;
                }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
            x_out[row + i] = from_f32<XT>(y[i] * wos[n + i] + wob[n + i]
                                          + to_f32(x[row + i]));
    }
    if (tid == 0) *ticket = 0;                // ready for the next launch
}

template <typename XT, typename CT, int KIND>
int launch_batched(const void* x, int B, int D, int H, const float* ln_w,
                   const float* ln_b, const int8_t* wq, const float* sq,
                   const float* bq, const void* kc, const float* ks,
                   const void* vc, const float* vs, int T, const int* pos,
                   int n_valid, int n_loop, int C, int S, int chunk,
                   const int8_t* wo, const float* wos, const float* wob,
                   void* x_out, float* ypart, int* tickets, void* k_row,
                   void* v_row, float* k_scale, float* v_scale, float* qkv,
                   float* hmax, cudaStream_t st) {
    const auto kernel = batched_block_kernel<XT, CT, KIND>;
    const int smem = batched_layout(D, C, S, chunk, sizeof(CT),
                                    KIND == BB_CROSS ? HD : 3 * HD, KIND)
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
    cfg.gridDim = dim3(C, H, (B + S - 1) / S);
    cfg.blockDim = dim3(BB_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attrs[2];
    attrs[0].id = cudaLaunchAttributeClusterDimension;
    attrs[0].val.clusterDim.x = C;
    attrs[0].val.clusterDim.y = 1;
    attrs[0].val.clusterDim.z = 1;
    // BB_ATTEND follows BB_PROJECT on the stream: a programmatic
    // dependency (griddepcontrol above), in a CUDA graph too
    attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attrs[1].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attrs;
    cfg.numAttrs = KIND == BB_ATTEND ? 2 : 1;
    cudaError_t e = cudaLaunchKernelEx(
        &cfg, kernel, static_cast<const XT*>(x), B, D, ln_w, ln_b, wq, sq, bq,
        static_cast<const CT*>(kc), static_cast<const CT*>(vc), ks, vs, T,
        pos, n_valid, n_loop, S, chunk, wo, wos, wob, static_cast<XT*>(x_out),
        ypart, tickets, static_cast<CT*>(k_row), static_cast<CT*>(v_row),
        k_scale, v_scale, qkv, hmax);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename XT>
int cross_block_b_t(int cache_dtype, const void* x, int B, int D, int H,
                    const float* ln_w, const float* ln_b, const int8_t* wq,
                    const float* sq, const float* bq, const void* kc,
                    const float* ks, const void* vc, const float* vs, int T,
                    int enc_len, int n_loop, int C, int S, int chunk,
                    const int8_t* wo, const float* wos, const float* wob,
                    void* x_out, float* ypart, int* tickets,
                    cudaStream_t st) {
    return with_cache_type(cache_dtype, [&](auto ct) {
        using CT = decltype(ct);
        return launch_batched<XT, CT, BB_CROSS>(
            x, B, D, H, ln_w, ln_b, wq, sq, bq, kc, ks, vc, vs, T, nullptr,
            enc_len, n_loop, C, S, chunk, wo, wos, wob, x_out, ypart, tickets,
            nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, st);
    });
}

// K5: slot b's rows < pos[b] are its history; int8 rows take two
// launches (above)
template <typename XT>
int self_block_b_t(int cache_dtype, const void* x, int B, int D, int H,
                   const float* ln_w, const float* ln_b, const int8_t* wqkv,
                   const float* sqkv, const float* bqkv, const void* kc,
                   const float* ks, const void* vc, const float* vs, int T,
                   const int* pos, int C, int S, int chunk,
                   const int8_t* wo, const float* wos, const float* wob,
                   void* x_out, void* k_row, float* k_scale, void* v_row,
                   float* v_scale, float* ypart, int* tickets, float* qkv,
                   float* hmax, cudaStream_t st) {
    return with_cache_type(cache_dtype, [&](auto ct) {
        using CT = decltype(ct);
        if constexpr (std::is_same<CT, int8_t>::value) {
            const int e = launch_batched<XT, CT, BB_PROJECT>(
                x, B, D, H, ln_w, ln_b, wqkv, sqkv, bqkv, nullptr, nullptr,
                nullptr, nullptr, T, pos, 0, 0, C, S, chunk, nullptr,
                nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                nullptr, nullptr, nullptr, qkv, hmax, st);
            if (e != 0) return e;
            return launch_batched<XT, CT, BB_ATTEND>(
                x, B, D, H, nullptr, nullptr, nullptr, nullptr, nullptr, kc,
                ks, vc, vs, T, pos, 0, 0, C, S, chunk, wo, wos, wob, x_out,
                ypart, tickets, k_row, v_row, k_scale, v_scale, qkv, hmax,
                st);
        } else {
            return launch_batched<XT, CT, BB_SELF>(
                x, B, D, H, ln_w, ln_b, wqkv, sqkv, bqkv, kc, ks, vc, vs, T,
                pos, 0, 0, C, S, chunk, wo, wos, wob, x_out, ypart, tickets,
                k_row, v_row, k_scale, v_scale, nullptr, nullptr, st);
        }
    });
}

bool batch_ok(int B) { return B >= 1 && B <= BB_MAX_SLOTS; }

// K5's and K6's launch plan (ops/decode_blocks.batched_plan) for the
// cache's row type, and the 16-byte alignment of the operands copied in
// 16-byte pieces
bool batched_plan_ok(int D, int H, int B, int C, int S, int chunk,
                     int cache_dtype, int W, int kind,
                     std::initializer_list<const void*> copied) {
    const int cache_size = cache_dtype == F32 ? 4
        : cache_dtype == BF16 ? 2 : 1;
    uintptr_t bases = 0;
    for (const void* p : copied) bases |= reinterpret_cast<uintptr_t>(p);
    return H <= BB_MAX_HEADS && batch_ok(B) && C >= 1
        && C <= BB_MAX_CLUSTER && S >= 1
        && S <= BB_MAX_SLOTS && chunk >= BB_GROUPS
        && chunk <= BB_MAX_CHUNK && chunk % BB_GROUPS == 0
        && batched_layout(D, C, S, chunk, cache_size, W, kind).total
            <= 227 * 1024
        && bases % 16 == 0;
}

}  // namespace
}  // namespace wa

using namespace wa;

// x [B, D]; weights at the layer; caches [B, T, D] at the layer (scales
// [B, T]); pos int32 [B] on the device; outputs x_out [B, D], k/v rows
// [B, D] in the cache dtype, scales [B]. The cluster size, the slots of a
// tile and the rows staged at a time come from
// ops/decode_blocks.batched_plan; ypart is f32 [H, B, D] scratch, tickets
// int32 [BB_MAX_SLOTS * BB_MAX_CLUSTER], zero before the first launch
// (each launch leaves them zero); qkv f32 [B, 3D] and hmax f32 [B, H, 2]
// scratch for int8 rows, else null.
extern "C" int wa_self_block_batched(
        const void* x, int x_dtype, int B, int D, int H, const void* ln_w,
        const void* ln_b, const void* wqkv, const void* sqkv,
        const void* bqkv, const void* kq, const void* ks, const void* vq,
        const void* vs, int cache_dtype, int T, const void* pos,
        const void* wo, const void* wos, const void* wob, void* x_out,
        void* k_row, void* k_scale, void* v_row, void* v_scale, int cluster,
        int slots, int chunk, void* ypart, void* tickets, void* qkv,
        void* hmax, void* stream) {
    const int kind = cache_dtype == I8 ? BB_ATTEND : BB_SELF;
    if (!shape_ok(D, H) || T < 1
            || !batched_plan_ok(D, H, B, cluster, slots, chunk, cache_dtype,
                                3 * HD, kind,
                                {x, wqkv, sqkv, bqkv, wo, kq, vq, qkv})
            || !batched_plan_ok(D, H, B, cluster, slots, chunk, cache_dtype,
                                3 * HD, BB_PROJECT, {}))
        return ERR_SHAPE;
    if ((cache_dtype == I8) != (ks != nullptr && vs != nullptr)
            || (cache_dtype == I8 && (qkv == nullptr || hmax == nullptr)))
        return ERR_DTYPE;
    auto st = static_cast<cudaStream_t>(stream);
#define WA_SELF_B(XT)                                                        \
    self_block_b_t<XT>(cache_dtype, x, B, D, H, (const float*)ln_w,          \
                       (const float*)ln_b, (const int8_t*)wqkv,              \
                       (const float*)sqkv, (const float*)bqkv, kq,           \
                       (const float*)ks, vq, (const float*)vs, T,            \
                       (const int*)pos, cluster, slots, chunk,               \
                       (const int8_t*)wo, (const float*)wos,                 \
                       (const float*)wob, x_out, k_row, (float*)k_scale,     \
                       v_row, (float*)v_scale, (float*)ypart, (int*)tickets, \
                       (float*)qkv, (float*)hmax, st)
    if (x_dtype == F32) return WA_SELF_B(float);
    if (x_dtype == BF16) return WA_SELF_B(__nv_bfloat16);
#undef WA_SELF_B
    return ERR_DTYPE;
}

// x [B, D]; cross caches [B, T, D] at the layer, rows < enc_len valid for
// every slot (enc_len 0: every row takes part at score NEG); the plan and
// the scratch as K5's.
extern "C" int wa_cross_block_batched(
        const void* x, int x_dtype, int B, int D, int H, const void* ln_w,
        const void* ln_b, const void* wq, const void* sq, const void* bq,
        const void* kq, const void* ks, const void* vq, const void* vs,
        int cache_dtype, int T, int enc_len, const void* wo, const void* wos,
        const void* wob, void* x_out, int cluster, int slots, int chunk,
        void* ypart, void* tickets, void* stream) {
    if (!shape_ok(D, H) || enc_len < 0 || enc_len > T || T < 1
            || !batched_plan_ok(D, H, B, cluster, slots, chunk, cache_dtype,
                                HD, BB_CROSS, {x, wq, sq, bq, wo, kq, vq}))
        return ERR_SHAPE;
    if ((cache_dtype == I8) != (ks != nullptr && vs != nullptr))
        return ERR_DTYPE;
    const int n_loop = enc_len > 0 ? enc_len : T;
    auto st = static_cast<cudaStream_t>(stream);
#define WA_CROSS_B(XT)                                                       \
    cross_block_b_t<XT>(cache_dtype, x, B, D, H, (const float*)ln_w,         \
                        (const float*)ln_b, (const int8_t*)wq,               \
                        (const float*)sq, (const float*)bq, kq,              \
                        (const float*)ks, vq, (const float*)vs, T, enc_len,  \
                        n_loop, cluster, slots, chunk, (const int8_t*)wo,    \
                        (const float*)wos, (const float*)wob, x_out,         \
                        (float*)ypart, (int*)tickets, st)
    if (x_dtype == F32) return WA_CROSS_B(float);
    if (x_dtype == BF16) return WA_CROSS_B(__nv_bfloat16);
#undef WA_CROSS_B
    return ERR_DTYPE;
}
