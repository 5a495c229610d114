// K7 ffn_block_batched and K9 ffn_fused: the FFN of up to 32 decode rows
// in one launch, on the tensor cores.
//
// Replace the Pallas kernels of whisper_apr_tpu/ops/decode_blocks.py
// (ffn_block_batched/_ffn_kernel_b, pallas_call at :1099) and of
// whisper_apr_tpu/ops/qmatvec.py (ffn_fused/_ffn_kernel, pallas_call at
// :279), and compute what they compute for x [B, D] (f32 or bf16), int8
// w1 [D, H] and w2 [H, D] (H = 4D) at one layer, with f32 sums:
//
//   K7: h = LN3(x) in f32, rounded to x's dtype; g = gelu(h . w1 * s1 +
//       b1) (exact erf), rounded to x's dtype; y = (g . w2) * fc2_s +
//       fc2_b + x, stored in x's dtype
//   K9: the same without LN3 (h = x), storing the UNSCALED sum g . w2
//       rounded to x's dtype (the caller applies fc2's scale and bias in
//       f32: folding it in here would move the bf16 rounding)
//
// What bounds them on the card: the 2 D H weight bytes (large-v3: 13.1 MB
// a layer, 3.9 us at 3.35 TB/s), read once for all the launch's rows; at
// most 32 rows do 64 flops a byte, far under the card's flop/byte ratio.
//
// Design: grid (C, G, T) with clusters of (C, 1, 1), G C U = H, T =
// ceil(B / S) tiles of S slots (ops/decode_blocks.ffn_plan chooses U, C
// and S: one wave at two blocks an SM). Block r of cluster c owns the U
// hidden units [U (c C + r), +U) and the output columns [r D / C,
// (r + 1) D / C):
//   1. six consumer warps ask for what is small: the first 16 bytes'
//      worth of rows of x (8 in bf16, 4 in f32) and LN3's vectors, the
//      same for every block of the cluster, by TMA bulk copies multicast
//      to all of them (all 160 blocks asking for them from L2 took ~2 us
//      at large-v3, B = 8), and fc1's scale and bias. Two producer warps
//      copy its slab of w1 (U bytes of each of D rows, in four parts, each
//      counted by an mbarrier through cp.async.mbarrier.arrive) and its
//      slab of w2 (its columns' bytes of the cluster's C U rows), 2 D U
//      bytes by 16-byte cp.async. The copies' issue stalls until the
//      stream drains; the consumers do the rest of phases 1 and 2: K7's
//      LN3 in place over the staged rows (a warp a row, two passes for
//      the statistics in f32, rounded to x's dtype);
//   2. fc1 by mma.sync m16n8k16: t^T = w1^T h^T, the weights as A (16
//      units x 16 rows of D, widened to bf16 exactly: a byte permute, two
//      lop3 and one bf16x2 subtraction a pair), h^T as B from the staged
//      rows (8 slots an N tile; f32 values as three bf16 terms whose sum
//      is the value: exact products, f32 sums), each part of w1 as it
//      lands, the next rows staged after each pass. The consumer warps
//      take D's 16-row steps in turn; their sums meet in shared memory
//      over the spent w1 slab and are added in warp order, then the
//      scale, the bias, the GELU and the rounding;
//   3. every block of the cluster receives the cluster's hidden layer
//      [S, C U] (st.async into its shared memory, over the spent sums,
//      counted by its transaction barrier, after a cluster barrier that
//      says every block has read its sums): the hidden layer never
//      leaves the chip;
//   4. fc2 by mma.sync: its columns of y^T = w2^T g^T over the cluster's
//      C U units (A: 16 columns x 16 units of its w2 slab), a 16-column
//      vector and a split of the units a warp (ff_splits: the busiest
//      warp's steps fewest), the splits added in order: the cluster's
//      partial sum of its columns, to scratch;
//   5. the last of the G blocks on a column range and tile to finish (an
//      atomic ticket) adds the clusters' partials in cluster order, then
//      the epilogue.
// Every sum runs in a fixed order: two runs give the same bits.
#include <initializer_list>
#include <type_traits>

#include "cluster.cuh"
#include "quant_mma.cuh"

namespace wa {
namespace {

constexpr int FF_THREADS = 256;
constexpr int FF_WARPS = FF_THREADS / 32;
constexpr int FF_MAX_CLUSTER = 16;
constexpr int FF_MAX_ROWS = 32;          // rows a launch takes (and S)
constexpr int FF_MAX_SPLITS = 4;         // unit splits of an fc2 vector
constexpr int FF_SPLIT_BYTES = 32768;    // fc2's split sums, at most
constexpr int FF_XPAD = 8;               // x's staged rows: padding
constexpr int FF_PRODUCERS = 2;          // warps that issue the slabs' copies
constexpr int FF_CONSUMERS = FF_WARPS - FF_PRODUCERS;   // LN3 and fc1
constexpr int FF_W1_CHUNKS = 4;          // w1's slab lands in this many parts

struct FfLayout {
    int a, w2, f, gown, stats, bar, total;
    int ks;     // unit splits of fc2's column vectors
};

// the 16-byte chunk of w2's slab (rows of D / C bytes) that holds chunk p
// of row i: the rows 16 us + c + 2t (c in {0, 1, 8, 9}) that one load of
// a warp reads fall in four different groups of 4 banks (row pitches of
// 0 mod 64 bytes: chunk ^ t; of 32 mod 64: chunk ^ (t / 2); else as is)
__device__ __forceinline__ int w2_chunk(int p, int i, int cols) {
    if (cols % 64 == 0) return p ^ ((i >> 1) & 3);
    if (cols % 32 == 0) return p ^ ((i >> 2) & 1);
    return p;
}

// fc2's unit splits: the fewest steps for the busiest warp (ties: fewer
// splits), with their sums within FF_SPLIT_BYTES
__host__ __device__ inline int ff_splits(int nv, int n_us, int S, int cols) {
    int best = 1, cost = 1 << 30;
    for (int k = 1; k <= FF_MAX_SPLITS; ++k) {
        if (k > 1 && k * S * cols * 4 > FF_SPLIT_BYTES) break;
        const int c = ((nv * k + FF_WARPS - 1) / FF_WARPS)
            * ((n_us + k - 1) / k);
        if (c < cost) {
            cost = c;
            best = k;
        }
    }
    return best;
}

// shared memory of a block, in bytes: region a holds the w1 slab [D][U],
// then the consumer warps' fc1 sums [W'][S][U + 4] f32, then the
// cluster's hidden layer [C][S][U + 8] in x's dtype; the w2 slab
// [C U][D / C] (w2_chunk); region f holds x's staged rows
// [16 / sizeof(x)][D + 8] (h after LN3) and LN3's vectors [2][D] f32,
// then fc2's split sums [ks][S][D / C] f32 and the block's own part of the
// hidden layer [S][U] in x's dtype; fc1's scale and bias; the barriers
// (the hidden layer's, w1's chunks', w2's, x's and LN3's) and the ticket
// flag.
// ops/decode_blocks.ffn_smem mirrors it.
__host__ __device__ inline FfLayout ff_layout(int D, int U, int C, int S,
                                              int x_size) {
    FfLayout L;
    const int cols = D / C, nv = cols / 16;
    L.ks = ff_splits(nv, C * U / 16, S, cols);
    const int w1 = D * U;
    const int red = FF_CONSUMERS * S * (U + 4) * 4;
    const int gall = C * S * (U + 8) * x_size;
    const int xs = 16 * (D + FF_XPAD) + 8 * D;
    const int fc2 = L.ks * S * cols * 4 + S * U * x_size;
    int o = 0;
    L.a = o;     o += w1 > red ? (w1 > gall ? w1 : gall)
                               : (red > gall ? red : gall);
    L.w2 = o;    o += C * U * cols;
    L.f = o;     o += xs > fc2 ? xs : fc2;
    L.gown = L.f + L.ks * S * cols * 4;
    L.stats = o; o += 2 * FF_MAX_ROWS * 4;
    L.bar = o;   o += 8 * (FF_W1_CHUNKS + 4);
    L.total = o;
    return L;
}

// the row of w1's slab that holds row k: with U = 32 (32-byte rows) the
// four rows k0 + c + 2t (t = 0..3) that one load of a warp reads fall in
// four different groups of 8 banks
template <int U>
__device__ __forceinline__ int w1_row(int k) {
    if constexpr (U == 32) return (k & ~7) | ((k & 1) << 2) | ((k >> 1) & 3);
    return k;
}

// lane (g, t)'s bytes of a 16-byte vector row of a slab V vectors wide
// (V = U / 16): 2 V of them at 2 V (g / V) of vector g % V, in the low
// bytes of a word
template <int V>
__device__ __forceinline__ uint32_t a_word(const uint8_t* p) {
    if constexpr (V == 1)
        return *reinterpret_cast<const uint16_t*>(p);
    else
        return *reinterpret_cast<const uint32_t*>(p);
}

// the int8 values of bytes 0 and 2 of w as a bf16 pair, exactly: b =
// (128 + (b & 127)) - (b < 0 ? 256 : 128), both terms bf16 (exponent
// 0x43 over the low 7 bits, and that exponent or the next one), one
// bf16x2 subtraction: three instructions for two values
__device__ __forceinline__ uint32_t s8x2_bf16(uint32_t w) {
    uint32_t a, b;
    asm("lop3.b32 %0, %1, 0x007f007f, 0x43004300, 0xea;" : "=r"(a) : "r"(w));
    asm("lop3.b32 %0, %1, 0x00800080, 0x43004300, 0xea;" : "=r"(b) : "r"(w));
    const __nv_bfloat162 d = __hsub2(
        *reinterpret_cast<const __nv_bfloat162*>(&a),
        *reinterpret_cast<const __nv_bfloat162*>(&b));
    return *reinterpret_cast<const uint32_t*>(&d);
}

// the A fragment of mma j from the words of rows 2t, 2t + 1, 2t + 8,
// 2t + 9: A's row g is byte 2j of the word, row g + 8 byte 2j + 1; a
// byte permute puts rows 2t's and 2t + 1's two bytes side by side
__device__ __forceinline__ void a_frag(const uint32_t (&r)[4], int j,
                                       uint32_t (&a)[4]) {
    const uint32_t sel = (2 * j) | (2 * j + 1) << 4 | (2 * j + 4) << 8
        | (2 * j + 5) << 12;
    const uint32_t lo = __byte_perm(r[0], r[1], sel);
    const uint32_t hi = __byte_perm(r[2], r[3], sel);
    a[0] = s8x2_bf16(lo);
    a[1] = s8x2_bf16(lo >> 8);
    a[2] = s8x2_bf16(hi);
    a[3] = s8x2_bf16(hi >> 8);
}

// a pair of x's dtype in shared memory as bf16 terms (x_terms); zero
// where !on
__device__ __forceinline__ void pair_terms(const __nv_bfloat16* p, bool on,
                                           uint32_t (&t)[1]) {
    t[0] = on ? *reinterpret_cast<const uint32_t*>(p) : 0u;
}

__device__ __forceinline__ void pair_terms(const float* p, bool on,
                                           uint32_t (&t)[3]) {
    x_terms(on ? *reinterpret_cast<const float2*>(p) : make_float2(0.f, 0.f),
            t);
}

// eight consecutive values of x's dtype in shared memory (16-byte
// aligned), as f32 and back
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        v[2 * j] = __uint_as_float(w[j] << 16);
        v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
        w[j] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// four outputs at out[i .. i + 3] (16- or 8-byte aligned)
__device__ __forceinline__ void store4(float* out, size_t i,
                                       const float (&v)[4]) {
    *reinterpret_cast<float4*>(out + i) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* out, size_t i,
                                       const float (&v)[4]) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(out + i) = make_uint2(
        *reinterpret_cast<const uint32_t*>(&a),
        *reinterpret_cast<const uint32_t*>(&b));
}

// f(std::integral_constant<int, i>{}) for the runtime i < N
template <int N, typename F>
__device__ __forceinline__ void with_index(int i, F&& f) {
    if (i == 0) f(std::integral_constant<int, 0>{});
    if constexpr (N > 1) if (i == 1) f(std::integral_constant<int, 1>{});
    if constexpr (N > 2) if (i == 2) f(std::integral_constant<int, 2>{});
    if constexpr (N > 3) if (i == 3) f(std::integral_constant<int, 3>{});
}

// grid (C, G, T), clusters (C, 1, 1); see above. ln_w == nullptr: K9
// (no LN3, the raw fc2 sum out); else K7.
template <typename XT, int U, int NT>
__global__ void __launch_bounds__(FF_THREADS, 2) ffn_mma_kernel(
        const XT* __restrict__ x, int M, int D, int Hd,
        const float* __restrict__ ln_w, const float* __restrict__ ln_b,
        const uint8_t* __restrict__ w1, const float* __restrict__ s1,
        const float* __restrict__ b1, const uint8_t* __restrict__ w2,
        const float* __restrict__ s2, const float* __restrict__ b2,
        XT* __restrict__ out, int S, float* __restrict__ ypart,
        int* __restrict__ tickets) {
    constexpr int TERMS = std::is_same<XT, float>::value ? 3 : 1;
    constexpr int V1 = U / 16;                  // w1 slab vectors a row
    constexpr int E = 16 / sizeof(XT);          // values in 16 bytes
    constexpr int SUB = E;                      // x's rows staged at a time
    constexpr int PR = U + 4, PG = U + 8;       // fc1 sums', g's row pitch
    extern __shared__ __align__(16) unsigned char ff_smem[];
    const int C = gridDim.x, G = gridDim.y;
    const int r = blockIdx.x, cl = blockIdx.y, tile = blockIdx.z;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int s0 = tile * S, ns = min(S, M - s0);
    const int cols = D / C, c0 = r * cols, nv = cols / 16;
    const int j0 = (cl * C + r) * U;            // the block's first unit
    const int xpitch = D + FF_XPAD;
    const bool ln = ln_w != nullptr;
    const FfLayout lay = ff_layout(D, U, C, S, (int)sizeof(XT));
    uint8_t* w1_s = ff_smem + lay.a;                            // [D][U]
    float* red = reinterpret_cast<float*>(ff_smem + lay.a);     // [W][S][PR]
    XT* gall = reinterpret_cast<XT*>(ff_smem + lay.a);          // [C][S][PG]
    uint8_t* w2_s = ff_smem + lay.w2;                           // [C U][cols]
    XT* x_s = reinterpret_cast<XT*>(ff_smem + lay.f);  // [SUB][xpitch]
    float* lnw_s = reinterpret_cast<float*>(ff_smem + lay.f
                                            + 16 * (D + FF_XPAD));  // [D]
    float* lnb_s = lnw_s + D;                                       // [D]
    float* fred = reinterpret_cast<float*>(ff_smem + lay.f);    // [ks][S][D/C]
    XT* gown = reinterpret_cast<XT*>(ff_smem + lay.gown);       // [S][U]
    float* s1_s = reinterpret_cast<float*>(ff_smem + lay.stats);
    float* b1_s = s1_s + FF_MAX_ROWS;
    uint64_t* bar = reinterpret_cast<uint64_t*>(ff_smem + lay.bar);
    uint64_t* w_bar = bar + 1;      // w1's chunks, then w2
    uint64_t* s_bar = bar + FF_W1_CHUNKS + 2;   // x's rows, LN3's vectors
    int* flag = reinterpret_cast<int*>(bar + FF_W1_CHUNKS + 3);
    x += (size_t)s0 * D;
    out += (size_t)s0 * D;
    const int x_rows = min(SUB, ns);
    if (tid == 0) {
        // the cluster's hidden layer: every block's part, by st.async
        mbar_init_expect(bar, (uint32_t)(C * ns * U * sizeof(XT)));
        // the slabs: an arrival of each producer thread once its copies
        // up to there have landed
        for (int i = 0; i <= FF_W1_CHUNKS; ++i)
            asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                         :: "r"(smem_addr(w_bar + i)),
                            "r"(32 * FF_PRODUCERS) : "memory");
        // x's first rows and LN3's vectors, copied once for the cluster
        mbar_init_expect(s_bar, (uint32_t)(x_rows * D * sizeof(XT)
                                           + (ln ? 8 * D : 0)));
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    // every block's barriers are set before any copy multicast to it lands
    asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");

    // 1. the consumers ask for what is small: the first SUB rows of x and
    //    LN3's vectors, the same for the whole cluster, by TMA bulk copies
    //    multicast to every block of it (a piece a block, pieces r, r + C,
    //    ..: the cluster reads them from L2 once, not C times), and fc1's
    //    scale and bias of the block's units; the producers start on the
    //    slabs at once
    const int vpr = D / E;                      // 16-byte vectors a row
    if (warp < FF_CONSUMERS) {
        asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
        const int pieces = x_rows + (ln ? 2 : 0);
        const int p = r + C * tid;
        if (p < pieces) {
            const void* src = p < x_rows ? (const void*)(x + (size_t)p * D)
                : p == x_rows ? (const void*)ln_w : (const void*)ln_b;
            void* dst = p < x_rows ? (void*)(x_s + p * xpitch)
                : p == x_rows ? (void*)lnw_s : (void*)lnb_s;
            const uint32_t bytes = p < x_rows ? D * (int)sizeof(XT) : 4 * D;
            asm volatile(
                "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
                "::bytes.multicast::cluster [%0], [%1], %2, [%3], %4;\n"
                :: "r"(smem_addr(dst)), "l"(src), "r"(bytes),
                   "r"(smem_addr(s_bar)), "h"((uint16_t)((1u << C) - 1))
                : "memory");
        }
        if (tid < U / 4)
            cp_async16(s1_s + 4 * tid, s1 + j0 + 4 * tid, 16);
        else if (tid < U / 2)
            cp_async16(b1_s + 4 * tid - U, b1 + j0 + 4 * tid - U, 16);
        cp_async_commit();
    }
    // LN3 over the staged rows, in place (rounded to x's dtype): a
    // consumer warp a row, two passes over it for the statistics (f32),
    // one to apply them
    const auto ln_rows = [&](int rows) {
        for (int rr = warp; rr < rows; rr += FF_CONSUMERS) {
            XT* xr = x_s + rr * xpitch;
            float v[8], sum = 0.f, var = 0.f;
            for (int i = 8 * lane; i < D; i += 256) {
                load8(xr + i, v);
#pragma unroll
                for (int e = 0; e < 8; ++e) sum += v[e];
            }
            const float mean = warp_sum(sum) / (float)D;
            for (int i = 8 * lane; i < D; i += 256) {
                load8(xr + i, v);
#pragma unroll
                for (int e = 0; e < 8; ++e)
                    var += (v[e] - mean) * (v[e] - mean);
            }
            const float rstd = rsqrtf(warp_sum(var) / (float)D + LN_EPS);
            for (int i = 8 * lane; i < D; i += 256) {
                float w[8], b[8];
                load8(xr + i, v);
                load8(lnw_s + i, w);
                load8(lnb_s + i, b);
#pragma unroll
                for (int e = 0; e < 8; ++e)
                    v[e] = (v[e] - mean) * rstd * w[e] + b[e];
                store8(xr + i, v);
            }
        }
    };
    if (warp >= FF_CONSUMERS) {
        // the producers: w1's slab in FF_W1_CHUNKS parts of D / 4 rows,
        // then w2's, each part's barrier told when the thread's copies so
        // far have landed. The copies' issue stalls while the stream is
        // full (and with it the SM's other shared-memory traffic)
        const int pt = tid - 32 * FF_CONSUMERS;
        const int part = D / FF_W1_CHUNKS;
        for (int i = 0; i < FF_W1_CHUNKS; ++i) {
            for (int e = pt; e < part * V1; e += 32 * FF_PRODUCERS) {
                const int k = i * part + e / V1, p = e % V1;
                cp_async16(w1_s + w1_row<U>(k) * U + 16 * p,
                           w1 + (size_t)k * Hd + j0 + 16 * p, 16);
            }
            asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 "
                         "[%0];\n" :: "r"(smem_addr(w_bar + i)) : "memory");
        }
        const uint8_t* w2_rows = w2 + (size_t)cl * C * U * D + c0;
        for (int e = pt; e < C * U * nv; e += 32 * FF_PRODUCERS) {
            const int i = e / nv, p = e % nv;
            cp_async16(w2_s + i * cols + 16 * w2_chunk(p, i, cols),
                       w2_rows + (size_t)i * D + 16 * p, 16);
        }
        asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                     :: "r"(smem_addr(w_bar + FF_W1_CHUNKS)) : "memory");
        asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    }

    // 2. fc1 by the consumers, SUB staged rows at a time (the N tile's
    //    slots 8 nt + g; f32: half a tile), LN3 first; consumer warp w
    //    takes the 16-row steps w, w + W', .. as their chunk of w1 lands;
    //    lane (g, t) reads rows 2t, 2t + 1, 2t + 8, 2t + 9 of a step
    const int steps = D / 16;
    const int rows[4] = {2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9};
    float acc[NT][V1][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < V1; ++j)
            acc[nt][j][0] = acc[nt][j][1] = acc[nt][j][2] = acc[nt][j][3] =
                0.f;
    if (warp < FF_CONSUMERS) {
        const auto consumers_sync = [] {
            asm volatile("bar.sync 1, %0;\n" :: "n"(32 * FF_CONSUMERS)
                         : "memory");
        };
        // lane (g, t)'s bytes of rows 2t, 2t + 1, 2t + 8, 2t + 9 of a step
        // (w1_row(16 s + r) = 16 s + w1_row(r))
        int a_off[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
            a_off[i] = w1_row<U>(rows[i]) * U + 16 * (g % V1)
                + 2 * V1 * (g / V1);
        const int spc = steps / FF_W1_CHUNKS;   // steps a chunk of w1
        const int nq = (ns + SUB - 1) / SUB;
        int landed = -1;            // w1's chunks waited for
        for (int q = 0; q < nq; ++q) {
            const int rows_q = min(SUB, ns - q * SUB);
            if (q == 0) mbar_wait_bounded(s_bar);   // the first rows
            if (q > 0) {            // the next rows, through registers
                consumers_sync();   // every consumer is done with the last
                for (int e = tid; e < rows_q * vpr; e += 32 * FF_CONSUMERS) {
                    const int rr = e / vpr, v = e % vpr;
                    *reinterpret_cast<uint4*>(x_s + rr * xpitch + v * E) =
                        __ldg(reinterpret_cast<const uint4*>(
                            x + (size_t)(q * SUB + rr) * D + v * E));
                }
                consumers_sync();
            }
            if (ln) {
                ln_rows(rows_q);
                consumers_sync();
            }
            const bool on = g / SUB == q % (8 / SUB)
                && q * SUB + g % SUB < ns;
            const XT* xl = x_s + (g % SUB) * xpitch + 2 * t;
            // the pass over D for the N tile of these rows, a compile-time
            // index into the accumulators
            with_index<NT>(q * SUB / 8, [&](auto ntc) {
                constexpr int nt = decltype(ntc)::value;
                int chunk = -1, next = 0;   // next: the next chunk's start
#pragma unroll 2
                for (int s = warp; s < steps; s += FF_CONSUMERS) {
                    while (s >= next) {
                        ++chunk;
                        next += spc;
                    }
                    if (chunk > landed) {   // and every chunk before it
                        landed = chunk;
                        mbar_wait_bounded(w_bar + landed);
                    }
                    uint32_t b0[TERMS], b1t[TERMS];
                    pair_terms(xl + 16 * s, on, b0);
                    pair_terms(xl + 16 * s + 8, on, b1t);
                    const uint8_t* ws = w1_s + 16 * U * s;
                    uint32_t wr[4];
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        wr[i] = a_word<V1>(ws + a_off[i]);
#pragma unroll
                    for (int j = 0; j < V1; ++j) {
                        uint32_t a[4];
                        a_frag(wr, j, a);
#pragma unroll
                        for (int i = 0; i < TERMS; ++i)
                            mma_bf16(acc[nt][j], a, b0[i], b1t[i]);
                    }
                }
            });
        }
        cp_async_wait<0>();         // fc1's scale and bias, for step 3
    }
    __syncthreads();                // every warp is done with w1's slab
    // the warps' sums over it: mma j's row g is unit 16 (g % V1) + 2 V1
    // (g / V1) + 2j, row g + 8 the next; columns 2t, 2t + 1 are slots
    const int busy = min(FF_CONSUMERS, steps);
    if (warp < busy) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int j = 0; j < V1; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int slot = 8 * nt + 2 * t + (e & 1);
                    const int u = 16 * (g % V1) + 2 * V1 * (g / V1) + 2 * j
                        + (e >> 1);
                    if (slot < ns)
                        red[(warp * S + slot) * PR + u] = acc[nt][j][e];
                }
    }
    __syncthreads();

    // 3. a (slot, unit) a thread: the warps' sums in order, scale, bias,
    //    GELU, rounding, into the block's part of the hidden layer; then
    //    E units of one slot a thread to every block of the cluster
    for (int i = tid; i < ns * U; i += FF_THREADS) {
        const int slot = i / U, u = i % U;
        float tt = 0.f;
#pragma unroll
        for (int w = 0; w < FF_CONSUMERS; ++w)
            if (w < busy) tt += red[(w * S + slot) * PR + u];
        tt = tt * s1_s[u] + b1_s[u];
        gown[i] = from_f32<XT>(0.5f * tt
                               * (1.0f + erff(tt * 0.7071067811865475f)));
    }
    __syncthreads();
    const int items = ns * (U / E);
    const int slot_i = tid / (U / E), u_i = (tid % (U / E)) * E;
    float gv[4];
    if (tid < items)
        row4(reinterpret_cast<const float*>(gown + slot_i * U + u_i), gv);
    // every block of the cluster has read its fc1 sums (release / acquire):
    // the hidden layer may land over them
    asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    if (tid < items) {
        const XT* dst = gall + ((size_t)r * S + slot_i) * PG + u_i;
        for (int d = 0; d < C; ++d)
            st_async4(cluster_addr(dst, d), gv, cluster_addr(bar, d));
    }
    mbar_wait_bounded(w_bar + FF_W1_CHUNKS);    // w2's slab has landed
    mbar_wait_bounded(bar);         // and the cluster's hidden layer

    // 4. fc2: task = a 16-column vector v of the block's columns and a
    //    split of the cluster's 16-unit steps; A's row g is column 2g of
    //    the vector, row g + 8 column 2g + 1
    const int n_us = C * U / 16;
    const int ks = lay.ks;
    for (int task = warp; task < nv * ks; task += FF_WARPS) {
        const int v = task % nv, sp = task / nv;
        const int us0 = sp * n_us / ks, us1 = (sp + 1) * n_us / ks;
        float acc2[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
            acc2[nt][0] = acc2[nt][1] = acc2[nt][2] = acc2[nt][3] = 0.f;
        // rows 16 us + rows[i] of chunk v, as w2_chunk placed them; the
        // hidden units 16 us + 2t (+1, +8, +9) of slot 8 nt + g
        const uint8_t* w2_lane = w2_s + 16 * w2_chunk(v, 2 * t, cols) + 2 * g
            + 16 * cols * us0;
        int w_off[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) w_off[i] = rows[i] * cols;
        const XT* g_lane = gall + g * PG + 2 * t;
#pragma unroll 4
        for (int us = us0; us < us1; ++us) {
            uint32_t wr[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) wr[i] = a_word<1>(w2_lane + w_off[i]);
            w2_lane += 16 * cols;
            uint32_t a[4];
            a_frag(wr, 0, a);
            const XT* gp0 = g_lane + (16 * us / U) * S * PG + 16 * us % U;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                const XT* gp = gp0 + 8 * nt * PG;
                uint32_t b0[TERMS], b1v[TERMS];
                pair_terms(gp, true, b0);
                pair_terms(gp + 8, true, b1v);
#pragma unroll
                for (int i = 0; i < TERMS; ++i)
                    mma_bf16(acc2[nt], a, b0[i], b1v[i]);
            }
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int slot = 8 * nt + 2 * t + (e & 1);
                if (slot < ns)
                    fred[(sp * S + slot) * cols + 16 * v + 2 * g + (e >> 1)]
                        = acc2[nt][e];
            }
    }
    __syncthreads();
    // the cluster's sums of the block's columns, the splits in order
    const int c4s = cols / 4;
    for (int i = tid; i < ns * c4s; i += FF_THREADS) {
        const int slot = i / c4s, c4 = 4 * (i % c4s);
        float4 y = *reinterpret_cast<const float4*>(fred + slot * cols + c4);
        for (int sp = 1; sp < ks; ++sp) {
            const float4 z = *reinterpret_cast<const float4*>(
                fred + (sp * S + slot) * cols + c4);
            y.x += z.x; y.y += z.y; y.z += z.z; y.w += z.w;
        }
        __stcg(reinterpret_cast<float4*>(
                   ypart + ((size_t)cl * M + s0 + slot) * D + c0 + c4), y);
    }

    // 5. the last of the G blocks on these columns adds the clusters'
    //    sums in cluster order, then the epilogue
    int* ticket = tickets + tile * C + r;
    if (!last_ticket(ticket, G, flag)) return;
    for (int i = tid; i < ns * c4s; i += FF_THREADS) {
        const int slot = i / c4s, n = c0 + 4 * (i % c4s);
        float sc[4], bb[4], xr[4];  // requested before the sums
        if (ln) {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                sc[k] = s2[n + k];
                bb[k] = b2[n + k];
                xr[k] = to_f32(x[(size_t)slot * D + n + k]);
            }
        }
        float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int c = 0; c < G; ++c) {
            const float4 z = __ldcg(reinterpret_cast<const float4*>(
                ypart + ((size_t)c * M + s0 + slot) * D + n));
            y.x += z.x; y.y += z.y; y.z += z.z; y.w += z.w;
        }
        float o[4] = {y.x, y.y, y.z, y.w};
        if (ln) {
#pragma unroll
            for (int k = 0; k < 4; ++k) o[k] = o[k] * sc[k] + bb[k] + xr[k];
        }
        store4(out, (size_t)slot * D + n, o);
    }
    if (tid == 0) *ticket = 0;      // ready for the next launch
}

template <typename XT, int U, int NT>
int launch_ffn_b(const void* x, int M, int D, int Hd, const float* ln_w,
                 const float* ln_b, const uint8_t* w1, const float* s1,
                 const float* b1, const uint8_t* w2, const float* s2,
                 const float* b2, void* out, int C, int S, float* ypart,
                 int* tickets, cudaStream_t st) {
    const auto kernel = ffn_mma_kernel<XT, U, NT>;
    const int smem = ff_layout(D, U, C, S, (int)sizeof(XT)).total;
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
    cfg.gridDim = dim3(C, Hd / (U * C), (M + S - 1) / S);
    cfg.blockDim = dim3(FF_THREADS);
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
        &cfg, kernel, static_cast<const XT*>(x), M, D, Hd, ln_w, ln_b, w1,
        s1, b1, w2, s2, b2, static_cast<XT*>(out), S, ypart, tickets);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// the kernel for U units a block and tiles of S slots (ceil(S / 8) tiles
// of 8 for the mma)
template <typename XT>
int ffn_b_t(const void* x, int M, int D, int Hd, const float* ln_w,
            const float* ln_b, const uint8_t* w1, const float* s1,
            const float* b1, const uint8_t* w2, const float* s2,
            const float* b2, void* out, int U, int C, int S, float* ypart,
            int* tickets, cudaStream_t st) {
#define WA_FF(UU, NN)                                                        \
    launch_ffn_b<XT, UU, NN>(x, M, D, Hd, ln_w, ln_b, w1, s1, b1, w2, s2,    \
                             b2, out, C, S, ypart, tickets, st)
#define WA_FF_NT(UU)                                                         \
    switch ((S + 7) / 8) {                                                   \
        case 1: return WA_FF(UU, 1);                                         \
        case 2: return WA_FF(UU, 2);                                         \
        case 3: return WA_FF(UU, 3);                                         \
        default: return WA_FF(UU, 4);                                        \
    }
    if (U == 16) { WA_FF_NT(16) }
    WA_FF_NT(32)
#undef WA_FF_NT
#undef WA_FF
}

// the launch plan (ops/decode_blocks.ffn_plan) for M rows, and the
// 16-byte alignment of the copied operands
bool ffn_b_plan_ok(int M, int D, int Hd, int U, int C, int S, int x_size,
                   std::initializer_list<const void*> copied) {
    uintptr_t bases = 0;
    for (const void* p : copied) bases |= reinterpret_cast<uintptr_t>(p);
    return M >= 1 && M <= FF_MAX_ROWS && (U == 16 || U == 32) && C >= 1
        && C <= FF_MAX_CLUSTER && D > 0 && D % (16 * C) == 0 && D % 64 == 0
        && Hd > 0 && Hd % (U * C) == 0 && S >= 1 && S <= FF_MAX_ROWS
        && ff_layout(D, U, C, S, x_size).total <= 227 * 1024
        && bases % 16 == 0;
}

}  // namespace
}  // namespace wa

using namespace wa;

// Shared memory in bytes of one block of K7's and K9's kernel for a plan
// (units a block, cluster size, slots a tile) and x's dtype.
extern "C" int wa_ffn_b_smem(int D, int units, int cluster, int slots,
                             int x_dtype) {
    if (cluster < 1 || D % (16 * cluster) != 0) return ERR_SHAPE;
    return ff_layout(D, units, cluster, slots, x_dtype == F32 ? 4 : 2).total;
}

// K7: x [B, D] (B <= 32); w1 [D, Hd], w2 [Hd, D] and the vectors at the
// layer; out [B, D]. The units a block, the cluster size and the slots a
// tile come from ops/decode_blocks.ffn_plan; ypart is f32 scratch of
// Hd / (units * cluster) * B * D elements, tickets int32 [32 * 16], zero
// before the first launch (each launch leaves them zero).
extern "C" int wa_ffn_block_batched(
        const void* x, int x_dtype, int B, int D, int Hd, const void* ln_w,
        const void* ln_b, const void* w1, const void* s1, const void* b1,
        const void* w2, const void* s2, const void* b2, void* x_out,
        int units, int cluster, int slots, void* ypart, void* tickets,
        void* stream) {
    if (!ffn_b_plan_ok(B, D, Hd, units, cluster, slots,
                       x_dtype == F32 ? 4 : 2,
                       {x, ln_w, ln_b, w1, s1, b1, w2}))
        return ERR_SHAPE;
    if (ln_w == nullptr || ln_b == nullptr || s2 == nullptr || b2 == nullptr)
        return ERR_DTYPE;
    auto st = static_cast<cudaStream_t>(stream);
#define WA_FFN_B(XT)                                                         \
    ffn_b_t<XT>(x, B, D, Hd, (const float*)ln_w, (const float*)ln_b,         \
                (const uint8_t*)w1, (const float*)s1, (const float*)b1,      \
                (const uint8_t*)w2, (const float*)s2, (const float*)b2,      \
                x_out, units, cluster, slots, (float*)ypart, (int*)tickets,  \
                st)
    if (x_dtype == F32) return WA_FFN_B(float);
    if (x_dtype == BF16) return WA_FFN_B(__nv_bfloat16);
#undef WA_FFN_B
    return ERR_DTYPE;
}

// K9: x [M, D] (M <= 32) f32 or bf16; w1 [D, H], s1/b1 [H] f32 and w2
// [H, D] at the layer; out [M, D] in x's dtype; the plan and the scratch
// as K7's.
extern "C" int wa_ffn_fused(const void* x, int x_dtype, int M, int D, int H,
                            const void* w1, const void* s1, const void* b1,
                            const void* w2, void* out, int units,
                            int cluster, int slots, void* ypart,
                            void* tickets, void* stream) {
    if (!ffn_b_plan_ok(M, D, H, units, cluster, slots,
                       x_dtype == F32 ? 4 : 2, {x, w1, s1, b1, w2}))
        return ERR_SHAPE;
    auto st = static_cast<cudaStream_t>(stream);
#define WA_FFN(XT)                                                           \
    ffn_b_t<XT>(x, M, D, H, nullptr, nullptr, (const uint8_t*)w1,            \
                (const float*)s1, (const float*)b1, (const uint8_t*)w2,      \
                nullptr, nullptr, out, units, cluster, slots, (float*)ypart, \
                (int*)tickets, st)
    if (x_dtype == F32) return WA_FFN(float);
    if (x_dtype == BF16) return WA_FFN(__nv_bfloat16);
#undef WA_FFN
    return ERR_DTYPE;
}
