// K8, K17 and K4: products over int8 weights, on the tensor cores.
//
// K17 replaces the Pallas kernel of whisper_apr_tpu/ops/int8_matmul.py
// (_int8_matmul_kernel / int8_matmul, pallas_call at :72), K8 the one of
// whisper_apr_tpu/ops/qmatvec.py (_qmatvec_kernel / qmatvec_stacked,
// pallas_call at :86), K4 the fused greedy head of the same file
// (_greedy_head_kernel / qmatvec_greedy_head, pallas_call at :193). K8
// and K17 compute
//
//   y[m, n] = (sum_k x[m, k] * w[k, n]) * scale[n]     (f32 sum)
//
// with w the int8 weight taken in x's dtype. K17 casts to x's dtype and
// takes one scale for every column (n_scale == 1) or one per column; K8
// is one layer of a stacked [L, K, N] weight (the caller offsets the
// weight and scale pointers), per-column scale, out in x's dtype or f32
// (the vocab logits). K4 takes the same sums over the lane-padded int8
// vocab (no column scale: the K-side scale is folded into x), adds the f32
// bias, masks the columns >= n_vocab to -inf and, per row, returns the
// first index of the maximum (jnp.argmax's rule), the maximum and the
// logsumexp m + log(max(z, 1e-30)) (-inf columns add 0; a row of -inf
// logits gives token 0), writing no logits.
//
// Bound: at a few decode rows the weight bytes (K * N: 66.5 MB for
// large-v3's vocab, 20 MB for whisper-tiny's), at the encoder's 1500 rows
// the operations (2 M N K).
// Both are carried by the tensor cores at every M and for either dtype of
// x, as K18's kernels do for int4 (dequant_matmul.cu): f32 x is fed as
// three bf16 terms whose sum is x, each multiplied by the exactly widened
// weight into the same f32 sums.
//
// Widening int8 to bf16 without an int -> float convert (I2F runs at a
// quarter of the FMA rate): bf16 holds every int8 exactly, but no bf16
// binade holds 256 consecutive integers, so K18's one-lop3 magic does not
// carry over. Instead b ^ 0x80 = b + 128 goes into the low byte of the f32
// 2^23 (0x4B0000uu, one byte permute), 2^23 + 128 is subtracted (one f32
// add, exact), and as b has at most 8 significant bits the f32's high
// half IS b as a bf16: one more byte permute packs two. Every step exact;
// the products of int8 values and bf16 values are exact in f32, so the
// sums are the JAX kernel's arithmetic.
//
// - M <= 32 (a decode step, a serving tick, a short prompt; K8 always):
//   int8_mv_mma_kernel, bytes-bound, one launch. y^T = W^T x^T by
//   mma.sync m16n8k16: the weights are A (16 output columns by 16 K rows),
//   x is B in NT tiles of 8 rows. A block owns a strip of 128 columns (8
//   vectors of 16 bytes) and a range of K rows; lane (g, t) of each warp
//   reads whole 16-byte vectors (ld.global.nc.v4) of 4 K rows at vector
//   g, the next step's in flight while it multiplies this one's (two steps
//   in registers, or a ring of cp.async copies into shared memory, measured
//   slower). f32 x is fed as three bf16 terms whose sum is x (each product
//   exact, the sums f32). The warps' sums meet in
//   shared memory; where K is split (ops/int8_matmul.int8_plan), a strip's
//   splits are one thread block cluster: each stores its sums into the
//   blocks of the cluster that own them (distributed shared memory) and,
//   after the cluster's barrier, each block sums its share in split
//   order. No scratch, one launch, and a result that does not depend on
//   the order blocks run in.
// - K4: the decode-row kernel with a head epilogue (Q8_HEAD) over the
//   vocab, K whole (int8_plan gives the vocab's 406 strips one split).
//   Once a strip's sums are final, a warp a row sums them, adds the bias,
//   masks the padding and takes the strip's max, its first index and
//   sum exp(l - max) into [M, strips] partials: 64-bit words, each value
//   beside a nonzero mark, so a word read is known whole and written.
//   Each block takes an atomic ticket as it starts; the blocks of the
//   last min(S, M) tickets (every other block has started, so waiting
//   on them cannot deadlock) each merge whole rows once every partial of
//   the row has landed: a block a row, the first index of the maximum
//   and the sums rescaled to it in a fixed order. The merge zeroes each
//   word it has read and the last ticket resets the ticket, so every
//   launch leaves its scratch as it found it, zero: no state carries from
//   one launch to the next (a buffer grown, or zeroed again by a memset
//   that a CUDA graph captured with the launch, is as good as one used
//   before). Measured on the H100 (PERF.md, K4's design notes) against
//   the two-launch form and a ticket taken as the blocks end, this is the
//   faster at every M: the merge starts one load round trip after the
//   last strip, with no fence, atomic or launch in between.
// - K17, M > 32 (the encoder, the cross K/V, a long prefill):
//   int8_mma_kernel, operations-bound: a 128 x 128 output tile, 8 warps,
//   64-deep slices, a 3-stage ring of 16-byte cp.async copies of x's tile
//   and of the int8 tile. The block widens the next slice's int8 tile into
//   a bf16 [k][n] tile while it multiplies this one: B from
//   ldmatrix.x4.trans on the widened tile, padded row strides (272 bytes,
//   and 144 / 288 for x's bf16 / f32 rows) keeping the loads free of bank
//   conflicts. bf16 x: warps of 64 x 32, A from ldmatrix.x4, two blocks an
//   SM. f32 x: warps of 32 x 64 (each x value split by two warps, not
//   four), A split into its three terms from float2 loads as it is built
//   (quant_mma.cuh tile_a), three products a fragment pair summed apart
//   and added to the running sum once a step (quant_mma.cuh tile_step:
//   the tensor cores truncate what an mma adds below its largest addend's
//   24 bits), one block an SM (170 KB of shared memory). The three bf16
//   products of each f32 one put its tensor-core floor at three times the
//   bf16 kernel's, its bound (59.6 us at large-v3's fc1 over 1500 rows;
//   on the CUDA cores' 67 f32 TFLOP/s it would be 293 us).
//
// Ragged M, N and K edges are masked; rows whose addresses are not 16-byte
// aligned take the kernels' byte-wise loads.
#include <limits.h>

#include "quant_mma.cuh"
#include "cp_async.cuh"

#include <cooperative_groups.h>

namespace wa {
namespace {

namespace cg = cooperative_groups;

// --------------------------------------------------------------------------
// int8 -> bf16, exactly
// --------------------------------------------------------------------------

constexpr uint32_t FLIP = 0x80808080u;      // b ^ 0x80 == b + 128, per byte

// byte `sel & 3` of wx (a word of weights ^ FLIP) as an f32: u = b + 128
// as the low byte of 2^23 (selector 0x744B: bytes 1, 2 from 0x00, byte 3
// from 0x4B), minus 2^23 + 128
__device__ __forceinline__ float byte_f32(uint32_t wx, int sel) {
    return __uint_as_float(__byte_perm(wx, 0x4B000000u, sel)) - 8388736.f;
}

// two such integers as a bf16 pair: their f32 high halves (lo in bits
// 0-15)
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
    return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

template <int B>
__device__ __forceinline__ float byte_at(uint32_t wx) {
    return byte_f32(wx, 0x7440 | B);
}

__device__ __forceinline__ void store_out(void* y, int out_f32, size_t i,
                                          float v) {
    if (out_f32)
        static_cast<float*>(y)[i] = v;
    else
        static_cast<__nv_bfloat16*>(y)[i] = __float2bfloat16_rn(v);
}

// --------------------------------------------------------------------------
// decode rows: M <= 32, one launch
// --------------------------------------------------------------------------

constexpr int Q8_VECS = 8;                  // 16-byte vectors a block row
constexpr int Q8_STRIP = 16 * Q8_VECS;      // output columns a block owns
constexpr int Q8_W = 8;                     // warps a block: split K
constexpr int Q8_W1 = 4;                    //   and K whole (the vocab)
constexpr int Q8_THREADS = 32 * Q8_W;
static_assert(32 * Q8_W1 >= Q8_STRIP, "a scale a thread");
constexpr int Q8_RS = Q8_VECS * 17;         // a slot's row: padded vectors
constexpr int Q8_MAX_SPLIT = 16;            // blocks of a cluster

// the decode kernel's epilogue: the plain store (K8, K17), or K4's head
enum Q8Epi { Q8_STORE = 0, Q8_HEAD = 1 };

// K4's operands: bias [N] f32; the partials, three 64-bit words a row
// and strip ([3][M][S]: max, sum of exp(l - max), first index, each in
// the high half beside HEAD_MARK in the low half, so that a word read is
// known whole and written by this launch: zero before the launch, and
// zeroed again once read); the ticket (zero before the launch, and
// reset by its last block) and the [M] outputs
struct HeadArgs {
    const float* bias;
    int n_vocab;
    unsigned long long* part;
    unsigned long long* ticket;
    int* tok;
    float* mx;
    float* lse;
};

constexpr uint32_t HEAD_MARK = 1u;  // low half of a written partial

__device__ __forceinline__ void st_word(unsigned long long* p, uint32_t hi) {
    const unsigned long long w = (unsigned long long)hi << 32 | HEAD_MARK;
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" :: "l"(p), "l"(w)
                 : "memory");
}

__device__ __forceinline__ unsigned long long ld_word(
        const unsigned long long* p) {
    unsigned long long w;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(w) : "l"(p)
                 : "memory");
    return w;
}

constexpr int HEAD_PER = 4;         // strips a thread requests
constexpr int HEAD_MAX_S = HEAD_PER * 32 * Q8_W1;   // strips a merge takes

// row m's outputs from its S <= HEAD_MAX_S strip partials, by a whole
// block (32 Q8_W1 threads): each requests the three words of every 128th
// strip (the vocab's 406 strips at once), again until every word of the
// block's is marked written, then zeroes them; the block takes their
// max, the first index at it and the sums rescaled to it (each thread's
// in strip order, the warps' by shuffles, the block's in warp order).
// red: 96 words of shared memory
__device__ __forceinline__ void head_row(const HeadArgs& hd, int m, int M,
                                         int S, float* red) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nw = blockDim.x >> 5;
    int* ired = reinterpret_cast<int*>(red + 64);
    float pm[HEAD_PER], pz[HEAD_PER];
    int pi[HEAD_PER];
    bool ok;
    int polls = 0;
    do {
        if (++polls > (1 << 22)) __trap();  // never written: a fault
        ok = true;
#pragma unroll
        for (int j = 0; j < HEAD_PER; ++j) {
            const int s = tid + j * blockDim.x;
            unsigned long long w[3] = {HEAD_MARK, HEAD_MARK, HEAD_MARK};
            if (s < S)
#pragma unroll
                for (int k = 0; k < 3; ++k)
                    w[k] = ld_word(hd.part + ((size_t)k * M + m) * S + s);
            ok = ok && (uint32_t)w[0] == HEAD_MARK
                 && (uint32_t)w[1] == HEAD_MARK && (uint32_t)w[2] == HEAD_MARK;
            pm[j] = s < S ? __uint_as_float(w[0] >> 32) : -INFINITY;
            pz[j] = __uint_as_float(w[1] >> 32);
            pi[j] = (int)(w[2] >> 32);
        }
    } while (!__syncthreads_and(ok));
#pragma unroll
    for (int j = 0; j < HEAD_PER; ++j) {    // read: zero for the next launch
        const int s = tid + j * blockDim.x;
        if (s < S)
#pragma unroll
            for (int k = 0; k < 3; ++k)
                hd.part[((size_t)k * M + m) * S + s] = 0ull;
    }
    float bm = -INFINITY;
#pragma unroll
    for (int j = 0; j < HEAD_PER; ++j) bm = fmaxf(bm, pm[j]);
    bm = warp_max(bm);
    if (lane == 0) red[warp] = bm;
    __syncthreads();
    for (int i = 0; i < nw; ++i) bm = fmaxf(bm, red[i]);
    float bz = 0.f;
    int bi = INT_MAX;
#pragma unroll
    for (int j = 0; j < HEAD_PER; ++j) {   // an empty partial adds 0
        if (pm[j] == bm) bi = min(bi, pi[j]);
        if (pm[j] != -INFINITY) bz += pz[j] * expf(pm[j] - bm);
    }
    bz = warp_sum(bz);
    bi = warp_min_int(bi);
    if (lane == 0) {
        red[32 + warp] = bz;
        ired[warp] = bi;
    }
    __syncthreads();
    if (tid == 0) {
        bz = 0.f;
        for (int i = 0; i < nw; ++i) {
            bz += red[32 + i];
            bi = min(bi, ired[i]);
        }
        hd.tok[m] = bm == -INFINITY ? 0 : bi;   // the JAX kernel's start
        hd.mx[m] = bm;
        hd.lse[m] = bm + logf(fmaxf(bz, 1e-30f));
    }
    __syncthreads();                        // red is read
}

// Lane (g, t) reads rows 2t, 2t + 1, 2t + 8, 2t + 9 of each 16-row step
// at vector g of the strip, 16 bytes each (ld.global.nc.v4, or byte-wise
// where rows are not 16-byte aligned), the next step's in flight while it
// multiplies this one's: the K rows its A and B fragments hold. mma j
// takes bytes 2j and 2j + 1 of the vectors: A's row g is column 2j of
// vector g, row g + 8 column 2j + 1. Warp w takes steps w, w + W, .. (W
// warps: mv8_warps); each stores its sums to its slot of shared memory and the
// block sums the slots in order. Split K: the grid's splits of a strip
// are one cluster; split b stores its sums of outputs [r C, (r + 1) C)
// into block r's shared memory, and after the cluster's barrier block r
// sums them in split order and writes them.
template <typename XT, int NT, bool ALIGNED, int EPI>
__global__ void __launch_bounds__(Q8_THREADS) int8_mv_mma_kernel(
        const XT* __restrict__ x, const uint8_t* __restrict__ w,
        const float* __restrict__ scale, int n_scale, void* __restrict__ y,
        int out_f32, int M, int K, int N, int split_rows, HeadArgs hd) {
    constexpr int TERMS = std::is_same<XT, float>::value ? 3 : 1;
    constexpr bool HEAD = EPI != Q8_STORE;
    extern __shared__ __align__(16) unsigned char q8_smem[];
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int n_threads = blockDim.x, n_warps = n_threads >> 5;
    const int vec = blockIdx.x * Q8_VECS + g;
    const bool active = vec < (N + 15) / 16;
    const int n_split = gridDim.y;
    // K4: a ticket as the block starts, its answer kept in a register
    // until the end (nothing waits on it before)
    __shared__ unsigned long long ticket;
    unsigned long long my_ticket = 0;
    if (HEAD && tid == 0) my_ticket = atomicAdd(hd.ticket, 1ull);
    // the cluster's first barrier phase: every block has started before
    // any stores into another's shared memory (waited on below)
    if (n_split > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;");
    const int k0 = blockIdx.y * split_rows;
    const int kend = min(K, k0 + split_rows);
    const int steps = (kend - k0 + 15) / 16;
    const int rows[4] = {2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9};
    float acc[NT][8][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 8; ++j)
            acc[nt][j][0] = acc[nt][j][1] = acc[nt][j][2] = acc[nt][j][3] =
                0.f;
    // the strip's scales (K4: its bias, -inf on the padding), requested
    // with the first vectors and kept in shared memory for the epilogues
    const int my_col = blockIdx.x * Q8_STRIP + tid;
    float my_scale;
    if constexpr (HEAD)
        my_scale = tid < Q8_STRIP && my_col < hd.n_vocab ? hd.bias[my_col]
                                                         : -INFINITY;
    else
        my_scale = tid < Q8_STRIP && my_col < N
                       ? col_scale(scale, n_scale, my_col) : 0.f;
    // the next step's weight vectors and x pairs, requested while this
    // step's products run
    uint4 q[4];
    XPair<XT> xq[NT][2];
    const auto fetch = [&](int s) {
        const int kb = k0 + 16 * s;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int k = kb + rows[i];
            q[i] = active && k < kend ? load_vec<ALIGNED>(w, N, k, vec)
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
    for (int s = warp; s < steps; s += n_warps) {
        uint32_t r[4][4], b[NT][2][TERMS];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            r[i][0] = q[i].x ^ FLIP; r[i][1] = q[i].y ^ FLIP;
            r[i][2] = q[i].z ^ FLIP; r[i][3] = q[i].w ^ FLIP;
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) x_terms(xq[nt][h], b[nt][h]);
        fetch(s + n_warps);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            // bytes 2j (A rows g) and 2j + 1 (rows g + 8) of rows 2t, 2t + 1
            // (a0, a1) and 2t + 8, 2t + 9 (a2, a3)
            const int wd = j / 2, s0 = 0x7440 | (2 * (j % 2)), s1 = s0 + 1;
            const uint32_t a[4] = {
                bf16_pair(byte_f32(r[0][wd], s0), byte_f32(r[1][wd], s0)),
                bf16_pair(byte_f32(r[0][wd], s1), byte_f32(r[1][wd], s1)),
                bf16_pair(byte_f32(r[2][wd], s0), byte_f32(r[3][wd], s0)),
                bf16_pair(byte_f32(r[2][wd], s1), byte_f32(r[3][wd], s1))};
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int i = 0; i < TERMS; ++i)
                    mma_bf16(acc[nt][j], a, b[nt][0][i], b[nt][1][i]);
        }
    }

    // lane (g, t) holds rows 8 nt + 2t (+1) of columns 16 g + 2j (+1); a
    // slot is [M rows][8 vectors of 17]. Warps past the block's steps
    // hold nothing.
    float* const f_smem = reinterpret_cast<float*>(q8_smem);
    const int busy = min(n_warps, steps);
    const int total = M * Q8_STRIP;
    const int chunk = (total + n_split - 1) / n_split;
    float* sums = f_smem + n_warps * M * Q8_RS;     // [split][chunk]
    float* col_scales = sums + (n_split > 1 ? n_split * chunk : 0);
    if (tid < Q8_STRIP) col_scales[tid] = my_scale;
    if (HEAD && tid == 0) ticket = my_ticket;
    float* slot = f_smem + warp * M * Q8_RS + 17 * g;
#pragma unroll
    for (int nt = 0; nt < NT && warp < busy; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int m = 8 * nt + 2 * t + (e & 1);
            if (m < M) {
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    slot[m * Q8_RS + 2 * j + (e >> 1)] = acc[nt][j][e];
            }
        }
    __syncthreads();
    if (n_split > 1) asm volatile("barrier.cluster.wait.aligned;");

    if constexpr (HEAD) {
        // K (and so the strip) is whole: a warp a row sums the slots of
        // its 4 columns a lane in order, adds the bias (-inf on the
        // padding) and takes the strip's max, its first index and
        // sum exp(l - max)
        const int S = gridDim.x;
        for (int m = warp; m < M; m += n_warps) {
            float l[4], lm = -INFINITY;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int n = lane + 32 * i;
                const float* s = f_smem + m * Q8_RS + 17 * (n / 16) + n % 16;
                float v = s[0];
#pragma unroll
                for (int k = 1; k < Q8_W; ++k)
                    if (k < busy) v += s[k * M * Q8_RS];
                l[i] = v + col_scales[n];
                lm = fmaxf(lm, l[i]);
            }
            const float mw = warp_max(lm);
            int idx = INT_MAX;
            float z = 0.f;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                if (idx == INT_MAX && l[i] == mw)
                    idx = blockIdx.x * Q8_STRIP + lane + 32 * i;
                if (l[i] != -INFINITY) z += expf(l[i] - mw);
            }
            idx = warp_min_int(idx);
            z = warp_sum(z);
            if (lane == 0) {
                unsigned long long* o = hd.part + (size_t)m * S + blockIdx.x;
                st_word(o, __float_as_uint(mw));
                st_word(o + (size_t)M * S, __float_as_uint(z));
                st_word(o + (size_t)2 * M * S, (uint32_t)idx);
            }
        }
        // the blocks of the last R = min(S, M) tickets merge, the block of
        // ticket S - 1 - q the rows q, q + R, ..: none waits on a block
        // that cannot run, every other block has started or will once one
        // of the others ends. The last resets the ticket to zero (every
        // ticket is taken)
        const int R = min(S, M);
        const int q = S - 1 - (int)ticket;
        if (q >= R) return;
        if (q == 0 && tid == 0) atomicExch(hd.ticket, 0ull);
        __shared__ float red[96];
        for (int m = q; m < M; m += R) head_row(hd, m, M, S, red);
        return;
    }

    // the slots summed in order; with split K, split b stores its sums of
    // outputs [r C, (r + 1) C) into block r's shared memory, and after
    // the cluster's barrier block r sums them in split order
    for (int e = tid; e < total; e += n_threads) {
        const int m = e / Q8_STRIP, n = e % Q8_STRIP;
        const float* s = f_smem + m * Q8_RS + 17 * (n / 16) + n % 16;
        float v = s[0];
#pragma unroll
        for (int i = 1; i < Q8_W; ++i)
            if (i < busy) v += s[i * M * Q8_RS];
        const int gn = blockIdx.x * Q8_STRIP + n;
        if (n_split > 1) {
            const int r = e / chunk;
            cg::this_cluster().map_shared_rank(sums, r)[
                blockIdx.y * chunk + e - r * chunk] = v;
        } else if (gn < N) {
            store_out(y, out_f32, (size_t)m * N + gn, v * col_scales[n]);
        }
    }
    if (n_split == 1) return;
    cg::this_cluster().sync();      // every split's sums have arrived
    for (int i = tid; i < chunk; i += n_threads) {
        const int e = blockIdx.y * chunk + i;
        if (e >= total) break;
        float a[Q8_MAX_SPLIT];
#pragma unroll
        for (int sp = 0; sp < Q8_MAX_SPLIT; ++sp)
            a[sp] = sp < n_split ? sums[sp * chunk + i] : 0.f;
        float v = a[0];
#pragma unroll
        for (int sp = 1; sp < Q8_MAX_SPLIT; ++sp)
            if (sp < n_split) v += a[sp];
        const int n = e % Q8_STRIP, gn = blockIdx.x * Q8_STRIP + n;
        if (gn < N)
            store_out(y, out_f32, (size_t)(e / Q8_STRIP) * N + gn,
                      v * col_scales[n]);
    }
}

// the warps of a decode block: 8 where K is split (a split's rows come in
// rounds of one 16-row step a warp, ops/int8_matmul.int8_plan), 4 where it
// is whole (the vocab: more blocks resident, so a strip's 406 blocks are
// one wave; measured faster at every M there, slower on split shapes)
__host__ __forceinline__ int mv8_warps(int n_split) {
    return n_split > 1 ? Q8_W : Q8_W1;
}

// shared memory of a decode launch: the warps' slots, with split K every
// split's share of the block's outputs, and the strip's scales
__host__ __forceinline__ size_t mv8_smem(int M, int n_split) {
    const size_t total = (size_t)M * Q8_STRIP;
    return sizeof(float)
           * ((size_t)mv8_warps(n_split) * M * Q8_RS
              + (n_split > 1 ? n_split * ((total + n_split - 1) / n_split)
                             : 0)
              + Q8_STRIP);
}

template <typename XT, int NT, bool ALIGNED, int EPI>
int launch_mv8(const void* x, const uint8_t* w, const float* scale,
               int n_scale, void* y, int out_f32, int M, int K, int N,
               int n_split, int split_rows, const HeadArgs& hd,
               cudaStream_t st) {
    const auto kernel = int8_mv_mma_kernel<XT, NT, ALIGNED, EPI>;
    const int smem = (int)mv8_smem(M, n_split);
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
    cfg.gridDim = dim3((N + Q8_STRIP - 1) / Q8_STRIP, n_split);
    cfg.blockDim = dim3(32 * mv8_warps(n_split));
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
                                   w, scale, n_scale, y, out_f32, M, K, N,
                                   split_rows, hd);
}

// the decode kernel for M <= 32 rows: NT = ceil(M / 8) tiles of 8 rows,
// n_split blocks of split_rows K rows (a multiple of 16) a strip; the
// head (EPI != Q8_STORE) takes n_split 1 and 16-byte aligned rows
template <typename XT, int EPI = Q8_STORE>
int decode_rows(const void* x, const uint8_t* w, const float* scale,
                int n_scale, void* y, int out_f32, int M, int K, int N,
                int n_split, int split_rows, cudaStream_t st,
                const HeadArgs& hd = HeadArgs{}) {
    if (n_split < 1 || n_split > Q8_MAX_SPLIT || split_rows < 1
            || split_rows % 16 || (long long)n_split * split_rows < K
            || (long long)(n_split - 1) * split_rows >= K || M > 32
            || (EPI != Q8_STORE && n_split != 1))
        return ERR_SHAPE;
    const bool al = reinterpret_cast<uintptr_t>(w) % 16 == 0 && N % 16 == 0;
    if (EPI != Q8_STORE && !al) return ERR_SHAPE;   // the head: the padded
                                                    // vocab, 16-byte rows
    constexpr bool ANY = EPI == Q8_STORE;           // byte-wise rows too
#define WA_MV8(NT)                                                           \
    (al ? launch_mv8<XT, NT, true, EPI>(x, w, scale, n_scale, y, out_f32, M, \
                                        K, N, n_split, split_rows, hd, st)   \
        : launch_mv8<XT, NT, !ANY, EPI>(x, w, scale, n_scale, y, out_f32,    \
                                        M, K, N, n_split, split_rows, hd,    \
                                        st))
    if (M <= 8) return WA_MV8(1);
    if (M <= 16) return WA_MV8(2);
    if (M <= 24) return WA_MV8(3);
    return WA_MV8(4);
#undef WA_MV8
}

// --------------------------------------------------------------------------
// K17, M > 32: 128 x 128 tiles (x's side in quant_mma.cuh)
// --------------------------------------------------------------------------


// dynamic shared memory: bf16 x 114688 bytes (two blocks an SM), f32 x
// 169984 (one)
template <typename XT>
struct T8Smem {
    XT xs[TM_STAGES][TM_BM][TM_XLD];
    uint8_t wq[TM_STAGES][TM_BK][TM_BN];
    __nv_bfloat16 wt[2][TM_BK][TM_WLD];     // [k][n], two slices
};

// stage the slice at k0 of x's tile and of the int8 tile: 16-byte
// cp.async copies (zero-filled past M, K and N), or, when rows are not
// 16-byte aligned, element loads
template <typename XT, bool ALIGNED>
__device__ __forceinline__ void t8_stage(
        T8Smem<XT>& s, int st, const XT* __restrict__ x,
        const uint8_t* __restrict__ w, int M, int K, int N, int m0, int n0,
        int k0, int tid) {
    tile_stage_x<XT, ALIGNED>(s.xs[st], x, M, K, m0, k0, tid);
    if (ALIGNED) {
#pragma unroll
        for (int e = tid; e < TM_BK * (TM_BN / 16); e += TM_THREADS) {
            const int r = e / (TM_BN / 16), c = 16 * (e % (TM_BN / 16));
            const bool ok = k0 + r < K && n0 + c < N;
            cp_async16(&s.wq[st][r][c],
                       ok ? w + (size_t)(k0 + r) * N + n0 + c : w,
                       ok ? 16 : 0);
        }
        return;
    }
    for (int e = tid; e < TM_BK * TM_BN; e += TM_THREADS) {
        const int r = e / TM_BN, c = e % TM_BN;
        s.wq[st][r][c] = k0 + r < K && n0 + c < N
            ? w[(size_t)(k0 + r) * N + n0 + c] : (uint8_t)0;
    }
}

// widen stage st's int8 slice into wt[buf]: each thread two 16-byte
// vectors (a warp reads 512 contiguous bytes), 16 bf16 values each, two
// 16-byte stores
template <typename XT>
__device__ __forceinline__ void t8_widen(T8Smem<XT>& s, int st, int buf,
                                         int tid) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int v = tid + TM_THREADS * h;
        const int r = v / (TM_BN / 16), c = 16 * (v % (TM_BN / 16));
        const uint4 q = *reinterpret_cast<const uint4*>(&s.wq[st][r][c]);
        const uint32_t words[4] = {q.x ^ FLIP, q.y ^ FLIP, q.z ^ FLIP,
                                   q.w ^ FLIP};
        uint32_t o[8];
#pragma unroll
        for (int wd = 0; wd < 4; ++wd) {
            o[2 * wd] = bf16_pair(byte_at<0>(words[wd]),
                                  byte_at<1>(words[wd]));
            o[2 * wd + 1] = bf16_pair(byte_at<2>(words[wd]),
                                      byte_at<3>(words[wd]));
        }
        uint4* dst = reinterpret_cast<uint4*>(&s.wt[buf][r][c]);
        dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
        dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
    }
}

// one barrier a slice: at slice it, stage it + 1 has landed and slice it
// is widened; the block requests stage it + 2 (into the ring slot that
// slice it - 1 freed), widens slice it + 1 into the other wt buffer and
// runs slice it's products
template <typename XT, bool ALIGNED>
__global__ void __launch_bounds__(TM_THREADS, TileX<XT>::BLOCKS)
int8_mma_kernel(
        const XT* __restrict__ x, const uint8_t* __restrict__ w,
        const float* __restrict__ scale, int n_scale, XT* __restrict__ y,
        int M, int K, int N) {
    static_assert(2 * TM_THREADS == TM_BK * (TM_BN / 16), "two vectors each");
    using TX = TileX<XT>;
    constexpr int I = TX::WM / 16, J = TX::WN / 8, WC = TM_BN / TX::WN;
    extern __shared__ __align__(16) unsigned char t8_smem[];
    T8Smem<XT>& s = *reinterpret_cast<T8Smem<XT>*>(t8_smem);
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
    t8_stage<XT, ALIGNED>(s, 0, x, w, M, K, N, m0, n0, 0, tid);
    cp_async_commit();
    if (nk > 1)
        t8_stage<XT, ALIGNED>(s, 1, x, w, M, K, N, m0, n0, TM_BK, tid);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    t8_widen(s, 0, 0, tid);
    for (int it = 0; it < nk; ++it) {
        const int st = it % TM_STAGES, buf = it & 1;
        cp_async_wait<0>();
        __syncthreads();
        if (it + 2 < nk)
            t8_stage<XT, ALIGNED>(s, (it + 2) % TM_STAGES, x, w, M, K, N, m0,
                                  n0, (it + 2) * TM_BK, tid);
        cp_async_commit();
        if (it + 1 < nk) t8_widen(s, (it + 1) % TM_STAGES, buf ^ 1, tid);
#pragma unroll
        for (int kc = 0; kc < TM_BK / 16; ++kc)
            tile_step<XT>(acc, s.xs[st], s.wt[buf], wm, wn, kc, lane);
    }
    tile_store<XT>(acc, scale, n_scale, y, M, N, m0 + wm, n0 + wn, lane);
}

template <typename XT>
int launch_tile8(const void* x, const uint8_t* w, const float* scale,
                 int n_scale, void* y, int M, int K, int N, cudaStream_t st) {
    const bool al = tile_x_aligned<XT>(x, K)
                    && reinterpret_cast<uintptr_t>(w) % 16 == 0
                    && N % 16 == 0;
    const dim3 grid((N + TM_BN - 1) / TM_BN, (M + TM_BM - 1) / TM_BM);
    const auto kernel = al ? int8_mma_kernel<XT, true>
                           : int8_mma_kernel<XT, false>;
    const int smem = (int)sizeof(T8Smem<XT>);
    static bool opted_in[2] = {false, false};   // once per kernel
    if (!opted_in[al]) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
        opted_in[al] = true;
    }
    kernel<<<grid, TM_THREADS, smem, st>>>(
        static_cast<const XT*>(x), w, scale, n_scale, static_cast<XT*>(y), M,
        K, N);
    return (int)cudaGetLastError();
}

template <typename XT>
int int8_matmul_t(const void* x, int M, int K, const uint8_t* w, int N,
                  const float* scale, int n_scale, void* y, int n_split,
                  int split_rows, int* tile, cudaStream_t st) {
    const int out_f32 = std::is_same<XT, float>::value;
    if (tile != nullptr) *tile = M > 32;
    if (M <= 32)
        return decode_rows<XT>(x, w, scale, n_scale, y, out_f32, M, K, N,
                               n_split, split_rows, st);
    if (n_split != 1) return ERR_SHAPE;
    return launch_tile8<XT>(x, w, scale, n_scale, y, M, K, N, st);
}

}  // namespace
}  // namespace wa

using namespace wa;

// K17: x [M, K] (f32 or bf16), wq [K, N] int8, scale [n_scale] f32 (1 or
// per column), y [M, N] in x's dtype. For M <= 32 the caller's plan
// (ops/int8_matmul.int8_plan): n_split blocks over K (at most 16: one
// cluster), each split_rows rows (a multiple of 16); for M > 32, n_split
// 1. No scratch. *tile (unless null) is set to 1 where the launch is the
// tile kernel's (M > 32), else 0.
extern "C" int wa_int8_matmul(const void* x, int dtype, int M, int K,
                              const int8_t* wq, int N, const float* scale,
                              int n_scale, void* y, int n_split,
                              int split_rows, int* tile, void* stream) {
    if (M < 1 || K < 1 || N < 1 || n_scale < 1
            || (M + TM_BM - 1) / TM_BM > 65535)
        return ERR_SHAPE;
    auto st = static_cast<cudaStream_t>(stream);
    const auto w = reinterpret_cast<const uint8_t*>(wq);
    if (dtype == F32)
        return int8_matmul_t<float>(x, M, K, w, N, scale, n_scale, y,
                                    n_split, split_rows, tile, st);
    if (dtype == BF16)
        return int8_matmul_t<__nv_bfloat16>(x, M, K, w, N, scale, n_scale, y,
                                            n_split, split_rows, tile, st);
    return ERR_DTYPE;
}

// K8: x [M, K] f32 or bf16 (M <= 32); w [K, N] int8 and scale [N] f32 at
// the layer (N a multiple of 32); out [M, N] f32 or bf16; the plan of
// ops/int8_matmul.int8_plan. No scratch.
extern "C" int wa_qmatvec_stacked(const void* x, int x_dtype, int M, int K,
                                  const void* w, int N, const void* scale,
                                  void* out, int out_dtype, int n_split,
                                  int split_rows, void* stream) {
    if (N % 32 != 0 || M < 1 || M > 32 || K < 1) return ERR_SHAPE;
    if (out_dtype != F32 && out_dtype != BF16) return ERR_DTYPE;
    auto st = static_cast<cudaStream_t>(stream);
    const auto wp = static_cast<const uint8_t*>(w);
    const auto sp = static_cast<const float*>(scale);
    const int out_f32 = out_dtype == F32;
    if (x_dtype == F32)
        return decode_rows<float>(x, wp, sp, N, out, out_f32, M, K, N,
                                  n_split, split_rows, st);
    if (x_dtype == BF16)
        return decode_rows<__nv_bfloat16>(x, wp, sp, N, out, out_f32, M, K,
                                          N, n_split, split_rows, st);
    return ERR_DTYPE;
}

// K4: x [M, K] f32 or bf16 (M <= 32, the K-side scale folded in); w
// [K, N] int8, 16-byte aligned (the vocab, N lane-padded >= n_vocab, a
// multiple of 16, at most 65536); bias [N] f32;
// partials int64 [3, M, ceil(N / 128)] and ticket int64 [1], zero before
// the launch, which leaves them zero; outputs tok int32, mx and lse f32
// [M].
extern "C" int wa_greedy_head(const void* x, int x_dtype, int M, int K,
                              const void* w, int N, const void* bias,
                              int n_vocab, void* part, void* ticket,
                              void* tok, void* mx, void* lse, void* stream) {
    if (n_vocab > N || n_vocab < 1 || M < 1 || M > 32 || K < 1
            || (N + Q8_STRIP - 1) / Q8_STRIP > HEAD_MAX_S)
        return ERR_SHAPE;
    auto st = static_cast<cudaStream_t>(stream);
    const auto wp = static_cast<const uint8_t*>(w);
    const HeadArgs hd{static_cast<const float*>(bias), n_vocab,
                      static_cast<unsigned long long*>(part),
                      static_cast<unsigned long long*>(ticket),
                      static_cast<int*>(tok), static_cast<float*>(mx),
                      static_cast<float*>(lse)};
    const int rows = 16 * ((K + 15) / 16);          // K whole: one split
#define WA_HEAD(XT)                                                          \
    decode_rows<XT, Q8_HEAD>(x, wp, nullptr, 0, nullptr, 0, M, K, N, 1, rows, \
                             st, hd)
    if (x_dtype == F32) return WA_HEAD(float);
    if (x_dtype == BF16) return WA_HEAD(__nv_bfloat16);
#undef WA_HEAD
    return ERR_DTYPE;
}
