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
// flash_tc_kernel<T>, one kernel for both dtypes: the products run on
// the tensor cores with mma.sync m16n8k16 (bf16 in, f32 sums). A block
// holds 128 query rows, a warp two tiles of 16. In bf16 their q fragments
// stay in registers; per 64-key
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
//     common max in split order and writes the output's dtype: no
//     atomics, the same result each run.
// Requires 16-byte aligned rows (strides multiples of 8, as every
// caller's).
//
// f32 (flash_tc_kernel<float>): the same grid, tiles, split, combine and
// online softmax; only the staging (FlashStage) and the fragments and
// products differ, chosen at compile time. TF32 would round f32 inputs to
// 10 mantissa bits; instead every operand is split into three bf16 terms
// hi, mid, lo whose sum is it exactly (quant_mma.cuh x_terms), and each
// product is the f32 sum of the six bf16 products hi.hi, hi.mid, mid.hi,
// hi.lo, lo.hi, mid.mid (mma_terms): what it leaves out is under 2^-24 of
// the product. Each 16-deep step's six go into a sum of their own that
// the running sum takes with one f32 add, as the tensor cores truncate
// what an mma adds below 24 bits of its largest addend: into the running
// sum, that lost up to six ulps of it a step, all toward zero (4.1e-6 and
// 9.6e-6 of the largest output from f64 over 1500 keys at whisper-tiny's
// and large-v3's heads, against the plain f32 version's 1.7e-6 and
// 1.6e-6; 3.7e-7 and 3.9e-7 so, on an H100: chip_ab.py --f32). p is
// split from the score registers, unrounded (v is f32). Six products
// where bf16 takes one: at whisper's shapes its tensor-core floor (69.9 us
// at large-v3, B=1) is under half its f32 bound on the CUDA cores (172
// us), and the split costs ALU work, not bytes. q, K and V are staged as
// f32 by 16-byte cp.async copies (a 2-stage ring: 106 KB, two blocks an
// SM) into rows of 72 floats (q, K: their A / B fragments are float2
// loads at (row g, dim 2t), free of bank conflicts) and 68 (V: its B
// fragments pair keys 2t and 2t + 1 at dim g, free of conflicts too); each
// fragment is split as it is loaded. Rows not 16-byte aligned are staged
// element by element.
//
// bf16 operands whose rows are not 16-byte aligned take flash_kernel:
// CUDA cores, two threads a query row, each with the row's q in
// registers, 32 of the 64 scores of a key tile (keys 2j + half, so the
// pair reads neighbouring banks) and 32 of the 64 output dims; K and V
// tiles of 64 rows in shared memory as f32; the pair swaps its
// probabilities with one shuffle per key pair.
//
// All skip key tiles wholly above the diagonal (causal), as the JAX
// kernel does, and address operands by their strides, so the
// combined-head [B, T, H * 64] layout needs no transpose.
#include "quant_mma.cuh"

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

__global__ void __launch_bounds__(FA_THREADS) flash_kernel(
        const __nv_bfloat16* __restrict__ q, Strides sq,
        const __nv_bfloat16* __restrict__ k, Strides sk,
        const __nv_bfloat16* __restrict__ v, Strides sv,
        __nv_bfloat16* __restrict__ o, Strides so, int H, int Tq, int Tk,
        int kv_valid, float sm_scale, int causal) {
    using T = __nv_bfloat16;
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
// the tensor-core kernels: bf16, and f32 as three bf16 terms
// --------------------------------------------------------------------------

constexpr int FM_STAGES = 3;              // K/V tiles in the bf16 ring
constexpr int FM_TILE = FA_BK * HD;       // elements of one 64 x 64 tile
constexpr int FM_RT = 2;                  // 16-row query tiles a warp
constexpr int FM_BQ = 4 * 16 * FM_RT;     // query rows a block (4 warps)
// q's tiles, then per stage a K and a V tile (bf16): 64 KB
constexpr int FM_SMEM = (FM_BQ / FA_BK + 2 * FM_STAGES) * FM_TILE * 2;
// f32: rows of 72 floats (q, K: float2 fragment loads free of conflicts)
// and 68 (V: its B fragments' column loads), two stages in the ring; q's
// rows, then per stage a K and a V tile: 106 KB
constexpr int FF_LD = HD + 8;
constexpr int FF_VLD = HD + 4;
constexpr int FF_STAGES = 2;
constexpr int FF_KV = FA_BK * (FF_LD + FF_VLD);   // floats of a stage
constexpr int FF_SMEM = (FM_BQ * FF_LD + FF_STAGES * FF_KV) * 4;
// blocks an SM holds, either dtype (shared memory of two fits; up to
// 255 registers a thread)
constexpr int FM_BLOCKS_PER_SM = 2;
static_assert(FM_BLOCKS_PER_SM * (FF_SMEM + 1024) <= 228 * 1024,
              "two f32 blocks an SM");
constexpr float LOG2E = 1.4426950408889634f;
constexpr int FC_ROWS = 16;               // rows a combine block writes

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
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

// the same for f32 into rows of LD floats: 16-byte cp.async copies, or,
// where rows are not 16-byte aligned, element loads
template <int ROWS, int LD, bool ALIGNED>
__device__ __forceinline__ void load_tile_f32(float* tile, const float* src,
                                              long long st, int r0, int T,
                                              int tid) {
    if (ALIGNED) {
#pragma unroll
        for (int i = 0; i < ROWS * (HD / 4) / FA_THREADS; ++i) {
            const int e = tid + i * FA_THREADS, r = e >> 4, ch = e & 15;
            const bool in = r0 + r < T;
            cp_async16(tile + r * LD + ch * 4,
                       in ? src + (r0 + r) * st + ch * 4 : src, in ? 16 : 0);
        }
        return;
    }
    for (int e = tid; e < ROWS * HD; e += FA_THREADS) {
        const int r = e >> 6, c = e & (HD - 1);
        tile[r * LD + c] = r0 + r < T ? src[(r0 + r) * st + c] : 0.f;
    }
}

// c += a . b over f32 operands given as three bf16 terms each (hi, mid,
// lo): the six products above 2^-24 of the product, smallest first, into
// a sum of their own that c takes with one f32 add. The tensor cores
// align an mma's addends to the largest and truncate (toward zero) what
// falls below its 24 bits; summed into c, each of the six would lose up
// to an ulp of c, always the same way, where this step loses one of its
// own sum and rounds once into c.
__device__ __forceinline__ void mma_terms(float (&c)[4],
                                          const uint32_t (&a)[3][4],
                                          const uint32_t (&b)[3][2]) {
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    mma_bf16(d, a[2], b[0][0], b[0][1]);
    mma_bf16(d, a[0], b[2][0], b[2][1]);
    mma_bf16(d, a[1], b[1][0], b[1][1]);
    mma_bf16(d, a[1], b[0][0], b[0][1]);
    mma_bf16(d, a[0], b[1][0], b[1][1]);
    mma_bf16(d, a[0], b[0][0], b[0][1]);
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] += d[e];
}

// One key tile's online softmax over a warp's scores s (RT tiles of 16
// query rows, rows g and g + 8 of each; the raw sums q . k of keys k0 ..
// k0 + 63): masks, takes each row's max, turns s into p = 2^(s' - m) in
// place (s' the score in the log2 domain), updates m, l (this thread's
// share of the row sums; the quad sums them at the end) and rescales acc:
// the f32 kernel's (the bf16 kernel keeps an inline copy that packs each
// row tile's p as it is done). Scores are kept in the log2 domain:
// sm_scale * log2(e) scales the f32 sum and ex2.approx replaces expf; a
// masked score is the same -0.7 * f32max there, whose exponential is 0 as
// before. Only tiles that reach kv_valid or the diagonal evaluate the
// mask; the others fold the scale into the exponent's fma.
template <int RT>
__device__ __forceinline__ void softmax_tile(
        float (&s)[RT][FA_BK / 8][4], float (&m)[RT][2], float (&l)[RT][2],
        float (&acc)[RT][HD / 8][4], int k0, int row0, int qrow0,
        int kv_valid, int causal, float scale_log2, int t) {
    // only a tile reaching kv_valid or (causal) the block's first row
    // holds a masked key
    const bool masked = k0 + FA_BK > kv_valid
        || (causal && k0 + FA_BK - 1 > qrow0);
    // the scaled score is f * s: a tile without masked keys keeps s raw
    // and folds the scale into the exponent's fma (its max scales with it,
    // the scale being positive); a masked one scales first
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
                    const bool ok = j < kv_valid && (!causal || j <= row);
                    s[rt][nt][e] = ok ? s[rt][nt][e] * scale_log2 : FA_MASK;
                }
        f = 1.f;
    }
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
        l[rt][0] = l[rt][0] * a0 + ps0;
        l[rt][1] = l[rt][1] * a1 + ps1;
#pragma unroll
        for (int i = 0; i < HD / 8; ++i) {
            acc[rt][i][0] *= a0;
            acc[rt][i][1] *= a0;
            acc[rt][i][2] *= a1;
            acc[rt][i][3] *= a1;
        }
    }
}

// How each dtype stages q, K and V in shared memory (load<STAGE_Q, _K or
// _V>): bf16 as swizzled 64 x 64 tiles (q's two first, then per stage a K
// and a V tile) in a ring of FM_STAGES; f32 in rows of FF_LD floats (q,
// K) and FF_VLD (V) in a ring of FF_STAGES, element by element where rows
// are not 16-byte aligned. Offsets in elements.
enum { STAGE_Q, STAGE_K, STAGE_V };
template <typename T, bool ALIGNED>
struct FlashStage;
template <>
struct FlashStage<__nv_bfloat16, true> {
    static constexpr int STAGES = FM_STAGES;
    static constexpr int Q = FM_BQ * HD;             // q's rows
    static constexpr int KV = 2 * FM_TILE;           // a stage: K, then V
    static constexpr int V = FM_TILE;                // V in a stage
    static constexpr int SMEM = FM_SMEM;             // bytes
    template <int WHAT>
    __device__ __forceinline__ static void load(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                long long st, int r0, int n,
                                                int tid) {
        load_tile<WHAT == STAGE_Q ? FM_BQ : FA_BK>(dst, src, st, r0, n, tid);
    }
};
template <bool ALIGNED>
struct FlashStage<float, ALIGNED> {
    static constexpr int STAGES = FF_STAGES;
    static constexpr int Q = FM_BQ * FF_LD;
    static constexpr int KV = FF_KV;
    static constexpr int V = FA_BK * FF_LD;
    static constexpr int SMEM = FF_SMEM;
    template <int WHAT>
    __device__ __forceinline__ static void load(float* dst, const float* src,
                                                long long st, int r0, int n,
                                                int tid) {
        load_tile_f32<WHAT == STAGE_Q ? FM_BQ : FA_BK,
                      WHAT == STAGE_V ? FF_VLD : FF_LD, ALIGNED>(
            dst, src, st, r0, n, tid);
    }
};

// two adjacent outputs of a row: bf16 packed, f32 as a float2 where the
// rows are 16-byte aligned
template <typename T, bool ALIGNED>
__device__ __forceinline__ void store_pair(T* out, float v0, float v1) {
    if constexpr (!std::is_same<T, float>::value) {
        *reinterpret_cast<uint32_t*>(out) = pack_bf16(v0, v1);
    } else if constexpr (ALIGNED) {
        *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
    } else {
        out[0] = v0;
        out[1] = v1;
    }
}

// blockIdx.x = query tile * n_split + split, blockIdx.y = batch * H +
// head; a warp holds FM_RT tiles of 16 query rows, a block FM_BQ rows.
// Split s takes key tiles [s * split_tiles, (s + 1) * split_tiles); with
// n_split > 1 it writes part_acc [n_split, B * H, Tq, 64] and part_ml
// [n_split, B * H, Tq, 2] (m, l; log2 domain) instead of o.
// bf16: q's A fragments are loaded once by ldmatrix and K's and V's B
// fragments by ldmatrix (.trans for V); p is packed to bf16 straight from
// the score registers into p . v's A fragments. f32: every fragment is
// split into three bf16 terms as it is loaded (q's A and K's B from
// float2 loads, V's B from two rows' values, p's A from the score
// registers, unrounded: v is f32) and every product is mma_terms' six.
template <typename T, bool ALIGNED>
__global__ void __launch_bounds__(FA_THREADS, FM_BLOCKS_PER_SM)
flash_tc_kernel(
        const T* __restrict__ q, Strides sq, const T* __restrict__ k,
        Strides sk, const T* __restrict__ v, Strides sv, T* __restrict__ o,
        Strides so, int H, int Tq, int Tk, int kv_valid, float scale_log2,
        int causal, int n_split, int split_tiles, float* __restrict__ part_acc,
        float* __restrict__ part_ml) {
    constexpr bool F32 = std::is_same<T, float>::value;
    using Stage = FlashStage<T, ALIGNED>;
    constexpr int RT = FM_RT, BQ = FM_BQ, STAGES = Stage::STAGES;
    extern __shared__ __align__(16) unsigned char fm_smem[];
    T* const qs = reinterpret_cast<T*>(fm_smem);
    T* const ring = qs + Stage::Q;                   // stage i: K, then V
    const int qt = blockIdx.x / n_split, split = blockIdx.x % n_split;
    const int bh = blockIdx.y, h = bh % H, b = bh / H;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;      // fragment row / column pair
    const int row0 = qt * BQ + warp * 16 * RT + g;   // tile rt: + 16 rt
    const T* qp = q + b * sq.b + h * sq.h;
    const T* kp = k + b * sk.b + h * sk.h;
    const T* vp = v + b * sv.b + h * sv.h;

    int n_tiles = (Tk + FA_BK - 1) / FA_BK;
    if (causal) {   // tiles past the block's last row hold no valid key
        const int last = min(qt * BQ + BQ - 1, Tk - 1);
        n_tiles = min(n_tiles, last / FA_BK + 1);
    }
    const int t0 = split * split_tiles;
    const int count = max(0, min(n_tiles, t0 + split_tiles) - t0);

    auto load_kv = [&](int i) {   // tile t0 + i into stage i % STAGES
        T* st_ = ring + (i % STAGES) * Stage::KV;
        Stage::template load<STAGE_K>(st_, kp, sk.t, (t0 + i) * FA_BK, Tk,
                                      tid);
        Stage::template load<STAGE_V>(st_ + Stage::V, vp, sv.t,
                                      (t0 + i) * FA_BK, Tk, tid);
    };
    // q, in tile 0's group
    Stage::template load<STAGE_Q>(qs, qp, sq.t, qt * BQ, Tq, tid);
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
        if (i < count) load_kv(i);
        cp_async_commit();
    }
    uint32_t qa[RT][HD / 16][4];                // bf16: A fragments of q
    if constexpr (!F32) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();
#pragma unroll
        for (int rt = 0; rt < RT; ++rt)
#pragma unroll
            for (int kc = 0; kc < HD / 16; ++kc)
                ldmatrix_x4(qa[rt][kc], qs + swz((warp * RT + rt) * 16
                                                 + (lane & 15),
                                                 2 * kc + (lane >> 4)));
    }

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

    // bf16: the lane's ldmatrix rows and chunks, K (x4: keys +0 / +8,
    // dims +0 / +8) and V (x4.trans: keys +0 / +8, dims +0 / +8); f32: the
    // lane's q, row g of the warp's first tile, dims 2t, 2t + 1
    const int k_row = (lane & 7) + ((lane >> 4) << 3);
    const int k_ch = (lane >> 3) & 1;
    const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3);
    const int v_ch = lane >> 4;
    const T* qw = qs + (warp * 16 * RT + g) * FF_LD + 2 * t;
    for (int it = 0; it < count; ++it) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();   // tile it has landed; tile it - 1 is done with
        if (it + STAGES - 1 < count) load_kv(it + STAGES - 1);
        cp_async_commit();
        const T* ks = ring + (it % STAGES) * Stage::KV;
        const T* vs = ks + Stage::V;
        const int k0 = (t0 + it) * FA_BK;

        float s[RT][FA_BK / 8][4];
#pragma unroll
        for (int rt = 0; rt < RT; ++rt)
#pragma unroll
            for (int nt = 0; nt < FA_BK / 8; ++nt)
                s[rt][nt][0] = s[rt][nt][1] = s[rt][nt][2] = s[rt][nt][3] =
                    0.f;
        if constexpr (F32) {
#pragma unroll
            for (int kc = 0; kc < HD / 16; ++kc) {
                // q's A fragments: a0 row g, dims 2t; a1 row g + 8; a2,
                // a3 dims + 8
                uint32_t qf[RT][3][4];
#pragma unroll
                for (int rt = 0; rt < RT; ++rt)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        terms_at(*reinterpret_cast<const float2*>(
                                     qw + (16 * rt + 8 * (e & 1)) * FF_LD
                                     + 16 * kc + 8 * (e >> 1)), qf[rt], e);
#pragma unroll
                for (int nt = 0; nt < FA_BK / 8; ++nt) {
                    uint32_t kb[3][2];  // b0 key g, dims 2t; b1 dims + 8
#pragma unroll
                    for (int hh = 0; hh < 2; ++hh)
                        terms_at(*reinterpret_cast<const float2*>(
                                     ks + (nt * 8 + g) * FF_LD + 16 * kc
                                     + 2 * t + 8 * hh), kb, hh);
#pragma unroll
                    for (int rt = 0; rt < RT; ++rt)
                        mma_terms(s[rt][nt], qf[rt], kb);
                }
            }
        } else {
#pragma unroll
            for (int np = 0; np < FA_BK / 16; ++np) {
#pragma unroll
                for (int kc = 0; kc < HD / 16; ++kc) {
                    uint32_t kb[4];
                    ldmatrix_x4(kb, ks + swz(np * 16 + k_row, 2 * kc + k_ch));
#pragma unroll
                    for (int rt = 0; rt < RT; ++rt) {
                        mma_bf16(s[rt][2 * np], qa[rt][kc], kb[0], kb[1]);
                        mma_bf16(s[rt][2 * np + 1], qa[rt][kc], kb[2],
                                 kb[3]);
                    }
                }
            }
        }
        uint32_t pa[RT][FA_BK / 16][4];         // bf16: p's A fragments
        if constexpr (F32) {
            softmax_tile(s, m, l, acc, k0, row0, qt * BQ, kv_valid, causal,
                         scale_log2, t);
        } else {
            // softmax_tile's steps, inline, each row tile's p packed to
            // bf16 (as the JAX kernel) as soon as it is done: the score
            // fragments of key tiles 2kc and 2kc+1 are the A fragment of
            // keys 16kc..16kc+15. (softmax_tile with the packing as a
            // callback took 1 us more at large-v3 B=1 on an H100, for the
            // same bits.)
            const bool masked = k0 + FA_BK > kv_valid
                || (causal && k0 + FA_BK - 1 > qt * BQ);
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
                for (int o_ = 1; o_ <= 2; o_ <<= 1) {
                    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
                    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
                }
                const float mn0 = fmaxf(m[rt][0], mx0 * f);
                const float mn1 = fmaxf(m[rt][1], mx1 * f);
                const float a0 = ex2(m[rt][0] - mn0);
                const float a1 = ex2(m[rt][1] - mn1);
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
                l[rt][0] = l[rt][0] * a0 + ps0;
                l[rt][1] = l[rt][1] * a1 + ps1;
#pragma unroll
                for (int i = 0; i < HD / 8; ++i) {
                    acc[rt][i][0] *= a0;
                    acc[rt][i][1] *= a0;
                    acc[rt][i][2] *= a1;
                    acc[rt][i][3] *= a1;
                }
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
        }
        if constexpr (F32) {
#pragma unroll
            for (int kc = 0; kc < FA_BK / 16; ++kc) {
                // p's A fragment of keys 16kc .. 16kc + 15: score tiles
                // 2kc and 2kc + 1, unrounded, as three terms
                uint32_t pf[RT][3][4];
#pragma unroll
                for (int rt = 0; rt < RT; ++rt)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        terms_at(make_float2(
                                     s[rt][2 * kc + (e >> 1)][2 * (e & 1)],
                                     s[rt][2 * kc + (e >> 1)]
                                      [2 * (e & 1) + 1]), pf[rt], e);
#pragma unroll
                for (int dn = 0; dn < HD / 8; ++dn) {
                    // V's B fragment: b0 keys 2t, 2t + 1, dim g; b1 keys
                    // + 8
                    uint32_t vb[3][2];
#pragma unroll
                    for (int hh = 0; hh < 2; ++hh) {
                        const float* vr = vs + (16 * kc + 2 * t + 8 * hh)
                            * FF_VLD + 8 * dn + g;
                        terms_at(make_float2(vr[0], vr[FF_VLD]), vb, hh);
                    }
#pragma unroll
                    for (int rt = 0; rt < RT; ++rt)
                        mma_terms(acc[rt][dn], pf[rt], vb);
                }
            }
        } else {
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
                        mma_bf16(acc[rt][2 * dp + 1], pa[rt][kc], vb[2],
                                 vb[3]);
                    }
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
    T* op = o + b * so.b + h * so.h;
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            const int row = row0 + 16 * rt + 8 * hf;
            if (row >= Tq) continue;
            const float inv = 1.f / (l[rt][hf] == 0.f ? 1.f : l[rt][hf]);
#pragma unroll
            for (int dn = 0; dn < HD / 8; ++dn)
                store_pair<T, ALIGNED>(op + row * so.t + dn * 8 + 2 * t,
                                       acc[rt][dn][2 * hf] * inv,
                                       acc[rt][dn][2 * hf + 1] * inv);
        }
    }
}

// The split partials of flash_tc_kernel, combined in split order: m =
// max of the splits' m, l = sum l_s 2^(m_s - m), out = sum acc_s 2^(m_s -
// m) / (l == 0 ? 1 : l) in the output's dtype. A
// thread writes 4 dims of one row; blockIdx.x = row block, blockIdx.y =
// batch * H + head.
template <typename T>
__global__ void __launch_bounds__(FC_ROWS * HD / 4) flash_combine_kernel(
        const float* __restrict__ part_acc, const float* __restrict__ part_ml,
        T* __restrict__ o, Strides so, int H, int Tq, int n_split) {
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
    T* op = o + b * so.b + h * so.h + row * so.t + d;
    if constexpr (std::is_same<T, float>::value) {
        op[0] = a0 * inv;
        op[1] = a1 * inv;
        op[2] = a2 * inv;
        op[3] = a3 * inv;
    } else {
        *reinterpret_cast<uint2*>(op) = make_uint2(
            pack_bf16(a0 * inv, a1 * inv), pack_bf16(a2 * inv, a3 * inv));
    }
}

// 16-byte aligned rows: the pointer, and strides of whole 16 bytes
template <typename T>
__host__ __forceinline__ bool rows_aligned(const void* p, Strides s) {
    constexpr int V = 16 / sizeof(T);
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % V == 0
        && s.h % V == 0 && s.t % V == 0;
}

// flash_tc_kernel<T, ALIGNED> over n_split splits, then the combine for
// n_split > 1
template <typename T, bool ALIGNED>
int launch_tc(const void* q, Strides sq, const void* k, Strides sk,
              const void* v, Strides sv, void* o, Strides so, int B, int H,
              int Tq, int Tk, int kv_valid, float sm_scale, int causal,
              int n_split, int split_tiles, float* part_acc, float* part_ml,
              cudaStream_t st) {
    constexpr auto KERNEL = &flash_tc_kernel<T, ALIGNED>;
    constexpr int SMEM = FlashStage<T, ALIGNED>::SMEM;
    static const cudaError_t attr = cudaFuncSetAttribute(
        KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (attr != cudaSuccess) return (int)attr;
    const dim3 grid((Tq + FM_BQ - 1) / FM_BQ * n_split, B * H);
    KERNEL<<<grid, FA_THREADS, SMEM, st>>>(
        static_cast<const T*>(q), sq, static_cast<const T*>(k), sk,
        static_cast<const T*>(v), sv, static_cast<T*>(o), so, H, Tq, Tk,
        kv_valid, (float)(sm_scale * (double)LOG2E), causal, n_split,
        split_tiles, part_acc, part_ml);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || n_split == 1) return (int)err;
    flash_combine_kernel<T><<<dim3((Tq + FC_ROWS - 1) / FC_ROWS, B * H),
                              FC_ROWS * HD / 4, 0, st>>>(
        part_acc, part_ml, static_cast<T*>(o), so, H, Tq, n_split);
    return (int)cudaGetLastError();
}

}  // namespace
}  // namespace wa

// q [B, H, Tq, 64], k/v [B, H, Tk, 64], out [B, H, Tq, 64], each given by
// its pointer and its (batch, head, row) strides in elements, the last
// dim contiguous; one dtype for all (f32 or bf16); 1 <= kv_valid <= Tk.
// f32, and bf16 with 16-byte aligned rows, run flash_tc_kernel over
// n_split splits of split_tiles key tiles each
// (n_split > 1 needs part_acc, f32 [n_split * B * H * Tq * 64], and
// part_ml, f32 [n_split * B * H * Tq * 2]); bf16 rows that are not so
// aligned run flash_kernel and take n_split = 1 only.
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
#define WA_TC(T, AL)                                                         \
    launch_tc<T, AL>(q, a, k, b, v, c, out, d, B, H, Tq, Tk, kv_valid,        \
                     sm_scale, causal, n_split, split_tiles, part_acc,        \
                     part_ml, st)
    if (dtype == F32) {
        const bool al = rows_aligned<float>(q, a) && rows_aligned<float>(k, b)
            && rows_aligned<float>(v, c) && rows_aligned<float>(out, d);
        return al ? WA_TC(float, true) : WA_TC(float, false);
    }
    if (dtype != BF16) return ERR_DTYPE;
    if (rows_aligned<__nv_bfloat16>(q, a) && rows_aligned<__nv_bfloat16>(k, b)
            && rows_aligned<__nv_bfloat16>(v, c)
            && rows_aligned<__nv_bfloat16>(out, d))
        return WA_TC(__nv_bfloat16, true);
#undef WA_TC
    if (n_split != 1) return ERR_SHAPE;
    const dim3 grid((Tq + FA_BQ - 1) / FA_BQ, B * H);
    flash_kernel<<<grid, FA_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), a,
        static_cast<const __nv_bfloat16*>(k), b,
        static_cast<const __nv_bfloat16*>(v), c,
        static_cast<__nv_bfloat16*>(out), d, H, Tq, Tk, kv_valid, sm_scale,
        causal);
    return (int)cudaGetLastError();
}
