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
// Design. Output tiles per block, K in chunks; tiles past the edges are
// zero-filled when staged and masked when stored, so any shape runs.
// Operands are read from device memory and staged in their own dtype and
// converted in registers as they are read from shared memory: there is no
// separate cast pass over memory, which is the question the probes ask for
// the int8 K/V rows of the batched attention kernels.
//   int8_mma_kernel (P1): mma.sync m16n8k32 s8.s8 -> s32. At 256^3 the
//     bound is 0.12 us and a launch's latency is the limit, so the design
//     cuts each block's serial path and fills the card:
//     - output tiles of 32 x 32 (256^3: 64 blocks); the two warps that
//       share each 16-row half of a tile take alternate 32-deep steps of
//       each staged chunk and add their int32 sums at the end (exact in
//       any order);
//     - both panels staged with 16-byte cp.async copies along each
//       operand's contiguous dim (A [M, K] along k, B [K, N] along n),
//       zero-filled past the edges; rows not 16-byte aligned are staged
//       a byte a thread. K up to 256 is staged whole behind one barrier,
//       deeper K through a 2-stage ring of 128-deep chunks;
//     - sm_90's ldmatrix transposes 16-bit elements only, so B stays
//       [K][N] in shared memory and is turned k-contiguous in registers:
//       a warp's columns are permuted so that each lane's B fragments of
//       all four n-tiles come from one 32-bit word of each of four rows,
//       transposed by eight byte permutes (int8_mma_kernel below).
//   mixed_mma_kernel (P2, P3 (b), (i)): Hopper has no mixed int8 x bf16
//     MMA, so both operands become bf16 in registers, exactly for int8
//     (a byte permute and an f32 subtraction, not the quarter-rate
//     int-to-float conversion) and rounded to nearest even for f32 (case
//     (i)'s in-kernel cast), then mma.sync m16n8k16 bf16 with f32 sums:
//     products of bf16 and int8 values are exact in f32. P1's design:
//     - tiles of 32 x 32, or 64 x 64 where that still gives 64 blocks
//       (ops/probe_mma.mixed_plan: 256^3 takes 64 blocks of 32 x 32, P3
//       (b)'s 32 x 128 x 1280 40); the two warps that share a 16-row
//       group take alternate k16 steps and add their f32 sums in a fixed
//       order at the end;
//     - both panels staged in their own dtype with 16-byte cp.async
//       copies, zero-filled past the edges, rows not 16-byte aligned an
//       element a thread; K up to 256 whole behind one barrier, deeper K
//       through a 2-stage ring, the chunk the plan's;
//     - bf16 fragments by ldmatrix.x4 (.trans for B [K][N] and a
//       transposed A); int8 widened as read into fragments, an int8 B
//       read as P1 reads it (a word of four columns from each of rows k
//       and k + 1, paired by byte permutes).
//   f32_dot_kernel (P3 (a), (c), (e)-(h), (j)): any f32 operand stays on
//     the CUDA cores in f32 (int8 widened exactly in registers): the
//     tensor cores would round f32 inputs to TF32 (about 3 digits), and
//     the contract is an f32 dot. At the probes' shapes the bound is
//     under 1.3 us and latency is the limit, so the design shortens each
//     block's serial path:
//     - the output tile fits the narrow side: 32 x 64, 64 x 32, or 32 x
//       32 where the grid is small (ops/probe_mma.dot_plan chooses), 128
//       threads of 4 x 4 (2 x 4 at 32 x 32) outputs; no thread computes
//       a row past the edge of a 32-wide operand. A 32 x 32 block that
//       contracts its whole K runs a second group of 128 threads on the
//       other half of each chunk, the two sums added in shared memory;
//     - both panels are staged with 16-byte cp.async copies in their own
//       dtype (int8 as bytes, widened exactly when read into registers by
//       a byte permute and an f32 subtraction, not the quarter-rate
//       int-to-float conversion), along each operand's contiguous dim,
//       zero-filled past the edges by the copy's src-size; operands
//       whose rows are not 16-byte aligned are
//       staged an element a thread. A split's whole K panel is staged
//       once behind one barrier where it fits in 48 KB (all the probes'
//       shapes), else it streams through a 2-stage ring of 32-deep
//       chunks, one barrier a chunk;
//     - long contractions on few tiles split K over blocks (the plan's
//       n_split ranges of k_split, multiples of 64): each writes an f32
//       partial to scratch and dot_split_sum_kernel adds them in split
//       order, without atomics, so every run gives the same sums.
//   transpose_kernel (P3 (d)): a 32 x 33 shared-memory tile (the pad
//     column keeps the transposed reads off one bank); exact.
#include <type_traits>

#include "common.cuh"
#include "cp_async.cuh"

namespace wa {
namespace {

constexpr int DOT_THREADS = 128;     // f32_dot_kernel
constexpr int DOT_TN = 4;            // its columns per thread
constexpr int DOT_SMEM = 48 * 1024;  // its staged panels, all stages
constexpr int SUM_THREADS = 256;     // dot_split_sum_kernel

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

// P3 (a), (c), (e)-(h), (j): the same contraction on the CUDA cores in f32

// NV (4 or 2) consecutive shared-memory elements widened to f32, in one
// load (the caller keeps them aligned)
template <int NV>
__device__ __forceinline__ void lds(const float* p, float (&o)[NV]) {
    static_assert(NV == 4 || NV == 2, "4 or 2 elements");
    if constexpr (NV == 4) {
        const float4 v = *reinterpret_cast<const float4*>(p);
        o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
    } else {
        const float2 v = *reinterpret_cast<const float2*>(p);
        o[0] = v.x; o[1] = v.y;
    }
}
// int8 bytes widened exactly without int-to-float conversions (a quarter
// of the FMA rate): the xor biases each byte b to b + 128, a byte permute
// sets it as the low byte of the f32 2^23 + (b + 128), and one f32
// subtraction takes the bias off
template <int NV>
__device__ __forceinline__ void lds(const int8_t* p, float (&o)[NV]) {
    static_assert(NV == 4 || NV == 2, "4 or 2 elements");
    uint32_t u;
    if constexpr (NV == 4) u = *reinterpret_cast<const uint32_t*>(p);
    else u = *reinterpret_cast<const uint16_t*>(p);
    u ^= 0x80808080u;
#pragma unroll
    for (int i = 0; i < NV; ++i)
        o[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | i))
            - 8388736.f;
}

// dst[r * dst_ld + c] = src[r * src_ld + c] for r < rows, c < cols, 0
// where r >= r_valid or c >= c_valid. vec: 16-byte cp.async copies (src,
// src_ld and the column edges 16-byte aligned); else an element a thread.
template <int THREADS, typename T>
__device__ __forceinline__ void stage_panel(T* dst, int dst_ld,
                                            const T* src, long long src_ld,
                                            int rows, int cols, int r_valid,
                                            int c_valid, bool vec) {
    if (vec) {
        constexpr int V = 16 / sizeof(T);
        const int per_row = cols / V;
        for (int e = threadIdx.x; e < rows * per_row; e += THREADS) {
            const int r = e / per_row, c = (e % per_row) * V;
            const bool in = r < r_valid && c < c_valid;
            cp_async16(dst + r * dst_ld + c, in ? src + r * src_ld + c : src,
                       in ? 16 : 0);
        }
    } else {
        for (int e = threadIdx.x; e < rows * cols; e += THREADS) {
            const int r = e / cols, c = e % cols;
            dst[r * dst_ld + c] = r < r_valid && c < c_valid
                ? src[r * src_ld + c] : T(0);
        }
    }
}

// P1: C [M, N] int32 = A [M, K] int8 . B [K, N] int8 over a 32 x 32 tile,
// K staged k_chunk (ops/probe_mma.int8_plan) at a time. Four warps: warp
// w takes rows 16 (w & 1) .. + 16 of the tile by its 32 columns and every
// other 32-deep step of each staged chunk, from 32 (w >> 1); the two
// warps of a half add their sums at the end (int32: exact in any order).
// In a warp's tile, mma column j of n-tile nt stands for column 4 j + nt:
// lane (g, t)'s B fragment of every n-tile is then the same 4 bytes of
// rows 4t .. 4t + 3 (and 16 + 4t ...), one 32-bit word each, turned
// k-contiguous by byte permutes, and its sums land on 8 neighbouring
// columns of a row.
constexpr int I8_THREADS = 128;
constexpr int I8_TILE = 32;          // output rows and columns of a block
constexpr int I8_PAD = 16;           // bytes after each staged row

// w[i] holds bytes (i, 0 .. 3) of a 4 x 4 block; o[j] gets (0 .. 3, j)
__device__ __forceinline__ void transpose4x4(const uint32_t (&w)[4],
                                             uint32_t (&o)[4]) {
    const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);   // 00 10 01 11
    const uint32_t t1 = __byte_perm(w[2], w[3], 0x5140);   // 20 30 21 31
    const uint32_t t2 = __byte_perm(w[0], w[1], 0x7362);   // 02 12 03 13
    const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);   // 22 32 23 33
    o[0] = __byte_perm(t0, t1, 0x5410);
    o[1] = __byte_perm(t0, t1, 0x7632);
    o[2] = __byte_perm(t2, t3, 0x5410);
    o[3] = __byte_perm(t2, t3, 0x7632);
}

// shared bytes of a P1 block: the staged panels A [32][k_chunk + pad] and
// B [k_chunk][32 + pad], two stages when K takes more than one chunk; at
// least the second warps' sums (2 halves x 32 lanes x 16 int32)
inline int int8_smem(int K, int k_chunk) {
    const int stage = I8_TILE * (k_chunk + I8_PAD)
        + k_chunk * (I8_TILE + I8_PAD);
    return max((K > k_chunk ? 2 : 1) * stage, 2 * 32 * 16 * 4);
}

__global__ void __launch_bounds__(I8_THREADS) int8_mma_kernel(
        const int8_t* __restrict__ a, const int8_t* __restrict__ b,
        int32_t* __restrict__ c, int M, int K, int N, int k_chunk,
        int a_vec, int b_vec) {
    extern __shared__ __align__(16) unsigned char i8_smem[];
    const int ald = k_chunk + I8_PAD, bld = I8_TILE + I8_PAD;
    const int sbytes = I8_TILE * ald + k_chunk * bld;
    const int n_chunks = (K + k_chunk - 1) / k_chunk;
    const int m0 = blockIdx.y * I8_TILE, n0 = blockIdx.x * I8_TILE;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int half = warp & 1, kw = warp >> 1;
    const int wm0 = 16 * half;

    auto stage = [&](int ci) {   // chunk ci: A [32][k_chunk], B [k_chunk][32]
        int8_t* as = reinterpret_cast<int8_t*>(i8_smem + (ci & 1) * sbytes);
        int8_t* bs = as + I8_TILE * ald;
        const int k0 = ci * k_chunk;
        stage_panel<I8_THREADS>(as, ald, a + (size_t)m0 * K + k0, K, I8_TILE,
                                k_chunk, M - m0, K - k0, a_vec);
        stage_panel<I8_THREADS>(bs, bld, b + (size_t)k0 * N + n0, N,
                                k_chunk, I8_TILE, K - k0, N - n0, b_vec);
    };

    int acc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
        acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0;
    stage(0);
    cp_async_commit();
    for (int ci = 0; ci < n_chunks; ++ci) {
        cp_async_wait<0>();
        __syncthreads();     // chunk ci has landed; chunk ci - 1 is read
        if (ci + 1 < n_chunks) stage(ci + 1);
        cp_async_commit();
        const int8_t* as = reinterpret_cast<const int8_t*>(
            i8_smem + (ci & 1) * sbytes);
        const int8_t* bs = as + I8_TILE * ald;
        for (int ks = kw * 32; ks < k_chunk; ks += 64) {
            const int8_t* ap = as + (wm0 + g) * ald + ks + 4 * t;
            const uint32_t af[4] = {ld32(ap), ld32(ap + 8 * ald),
                                    ld32(ap + 16), ld32(ap + 8 * ald + 16)};
            const int8_t* bp = bs + (ks + 4 * t) * bld + 4 * g;
            uint32_t w0[4], w1[4], b0[4], b1[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                w0[i] = ld32(bp + i * bld);
                w1[i] = ld32(bp + (16 + i) * bld);
            }
            transpose4x4(w0, b0);
            transpose4x4(w1, b1);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
                mma_s8(acc[nt], af, b0[nt], b1[nt]);
        }
    }
    // the second warp of each half hands its sums to the first through
    // the panels' shared memory
    cp_async_wait<0>();
    __syncthreads();
    int* red = reinterpret_cast<int*>(i8_smem) + (half * 32 + lane) * 16;
    if (kw == 1) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) red[nt * 4 + e] = acc[nt][e];
    }
    __syncthreads();
    if (kw == 1) return;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] += red[nt * 4 + e];
    // row g (+ 8): columns 8t .. 8t + 7 of the tile's 32, acc[nt][0 or 2]
    // at 8t + nt and [1 or 3] at 8t + 4 + nt
    const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0;
    const int col = n0 + 8 * t;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        const int row = m0 + wm0 + g + 8 * hr;
        if (row >= M) continue;
        int v[8];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
            v[nt] = acc[nt][2 * hr];
            v[4 + nt] = acc[nt][2 * hr + 1];
        }
        int32_t* cp = c + (size_t)row * N + col;
        if (vec && col + 8 <= N) {
            reinterpret_cast<int4*>(cp)[0] = make_int4(v[0], v[1], v[2], v[3]);
            reinterpret_cast<int4*>(cp)[1] = make_int4(v[4], v[5], v[6], v[7]);
        } else {
#pragma unroll
            for (int j = 0; j < 8; ++j)
                if (col + j < N) cp[j] = v[j];
        }
    }
}

// P2, P3 (b), (i): C [M, N] f32 = A . B on the tensor cores in bf16 with
// f32 sums, A [M, K] or (TA_T) [K, M] of TA in {f32, bf16, int8}, B [K, N]
// of TB in {bf16, int8}, over a BT x BT tile (ops/probe_mma.mixed_plan: 32
// or 64), K staged k_chunk at a time (whole, or a 2-stage ring); the
// panels hold each operand in its own dtype (bf16 as its 16 bits).
// 4 BT threads: warp w takes rows 16 (w % (BT / 16)) .. + 16 of the tile
// by its BT columns and every other k16 step of each staged chunk, from
// step w / (BT / 16); the two warps of a row group add their f32 sums in
// that order at the end. Fragments:
// - bf16 operands by ldmatrix.x4: A [m][k] as it is, a transposed A
//   [k][m] and B [k][n] with .trans (16-bit elements: sm_90 has it);
// - f32 A rounded to bf16 pairs (round to nearest even) as it is read;
// - int8 widened exactly as it is read: the byte b ^ 0x80 = b + 128 as
//   the low byte of the f32 2^23 by a byte permute, 2^23 + 128 taken off
//   by one f32 subtraction, the f32's high half IS b as a bf16 (at most 8
//   significant bits), two such halves one pair by a byte permute. An
//   int8 B [k][n] is read as P1 reads it: lane (g, t) takes one 32-bit
//   word at columns 4g of K rows 2t, 2t + 1, 2t + 8, 2t + 9 of each
//   32-column group, and byte j of the even row and of the odd row make
//   the pair of n-tile j, whose mma column g stands for column 4g + j:
//   the lane's sums land on 8 neighbouring columns of a row.
template <typename T> struct Raw { using type = T; };
template <> struct Raw<__nv_bfloat16> { using type = unsigned short; };

constexpr int MX_SMEM = 48 * 1024;   // a block's shared bytes, at most

// elements of a staged row of `cols` columns: 16 bytes of pad after each
template <typename T>
__host__ __device__ __forceinline__ int mx_ld(int cols) {
    return cols + 16 / (int)sizeof(T);
}

// bytes of one stage: A [bt][k_chunk] (TA_T: [k_chunk][bt]), then B
// [k_chunk][bt]; mirrors ops/probe_mma.mixed_stage_bytes
template <typename TA, typename TB, bool TA_T>
__host__ __device__ __forceinline__ int mx_a_bytes(int bt, int kc) {
    return (TA_T ? kc * mx_ld<TA>(bt) : bt * mx_ld<TA>(kc))
        * (int)sizeof(TA);
}
template <typename TA, typename TB, bool TA_T>
__host__ __device__ __forceinline__ int mx_stage_bytes(int bt, int kc) {
    return mx_a_bytes<TA, TB, TA_T>(bt, kc)
        + kc * mx_ld<TB>(bt) * (int)sizeof(TB);
}
// a block's: one stage, or two when K takes more than one chunk; at least
// the second k group's sums (bt^2 floats)
template <typename TA, typename TB, bool TA_T>
int mx_smem(int bt, int K, int kc) {
    return max((K > kc ? 2 : 1) * mx_stage_bytes<TA, TB, TA_T>(bt, kc),
               4 * bt * bt);
}

// byte `sel & 3` of ux (int8 bytes ^ 0x80) as an f32, exactly
__device__ __forceinline__ float i8_f32(uint32_t ux, int sel) {
    return __uint_as_float(__byte_perm(ux, 0x4B000000u, sel)) - 8388736.f;
}

// two integer-valued f32 of at most 8 significant bits as a bf16 pair
// (lo in bits 0-15): their high halves
__device__ __forceinline__ uint32_t hi_pair(float lo, float hi) {
    return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// the int8 bytes 0 (K k) and 1 (K k + 1) of u as a bf16 pair
__device__ __forceinline__ uint32_t i8_pair(uint32_t u) {
    const uint32_t ux = u ^ 0x8080u;
    return hi_pair(i8_f32(ux, 0x7440), i8_f32(ux, 0x7441));
}

__device__ __forceinline__ uint32_t f32_pair(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// the A fragment of rows r0 .. r0 + 15 and K k0 .. k0 + 15 from a staged
// panel as [m][ld] (TA_T: [k][ld])
template <typename TA, bool TA_T>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4],
                                       const typename Raw<TA>::type* as,
                                       int ld, int r0, int k0, int lane) {
    const int g = lane >> 2, t = lane & 3, i = lane >> 3;
    if constexpr (std::is_same<TA, __nv_bfloat16>::value) {
        if (TA_T)
            ldmatrix_x4_trans(a, as + (k0 + (lane & 7) + 8 * (i >> 1)) * ld
                                     + r0 + 8 * (i & 1));
        else
            ldmatrix_x4(a, as + (r0 + (lane & 15)) * ld + k0
                               + 8 * (lane >> 4));
    } else if constexpr (TA_T) {
        // [k][m]: K 2t and 2t + 1 of row g are a row apart
        const auto* p = as + (k0 + 2 * t) * ld + r0 + g;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const auto* q = p + 8 * (j & 1) + 8 * ld * (j >> 1);
            if constexpr (std::is_same<TA, float>::value)
                a[j] = f32_pair(q[0], q[ld]);
            else
                a[j] = i8_pair((uint32_t)(uint8_t)q[0]
                               | (uint32_t)(uint8_t)q[ld] << 8);
        }
    } else {
        const auto* p = as + (r0 + g) * ld + k0 + 2 * t;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const auto* q = p + 8 * ld * (j & 1) + 8 * (j >> 1);
            if constexpr (std::is_same<TA, float>::value) {
                const float2 v = *reinterpret_cast<const float2*>(q);
                a[j] = f32_pair(v.x, v.y);
            } else {
                a[j] = i8_pair(*reinterpret_cast<const uint16_t*>(q));
            }
        }
    }
}

// the B fragments of the warp's NTILE n-tiles, K k0 .. k0 + 15, from a
// staged panel [k][ld] (int8: n-tile 4q + j's column g is 32q + 4g + j)
template <typename TB, int NTILE>
__device__ __forceinline__ void b_frags(uint32_t (&b)[NTILE][2],
                                        const typename Raw<TB>::type* bs,
                                        int ld, int k0, int lane) {
    const int g = lane >> 2, t = lane & 3, i = lane >> 3;
    if constexpr (std::is_same<TB, __nv_bfloat16>::value) {
#pragma unroll
        for (int np = 0; np < NTILE / 2; ++np) {
            uint32_t r[4];
            ldmatrix_x4_trans(r, bs + (k0 + (lane & 7) + 8 * (i & 1)) * ld
                                     + 16 * np + 8 * (i >> 1));
            b[2 * np][0] = r[0];
            b[2 * np][1] = r[1];
            b[2 * np + 1][0] = r[2];
            b[2 * np + 1][1] = r[3];
        }
    } else {
#pragma unroll
        for (int q = 0; q < NTILE / 4; ++q) {
            const auto* p = bs + (k0 + 2 * t) * ld + 32 * q + 4 * g;
            const uint32_t w[4] = {ld32(p) ^ 0x80808080u,
                                   ld32(p + ld) ^ 0x80808080u,
                                   ld32(p + 8 * ld) ^ 0x80808080u,
                                   ld32(p + 9 * ld) ^ 0x80808080u};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                b[4 * q + j][0] = hi_pair(i8_f32(w[0], 0x7440 | j),
                                          i8_f32(w[1], 0x7440 | j));
                b[4 * q + j][1] = hi_pair(i8_f32(w[2], 0x7440 | j),
                                          i8_f32(w[3], 0x7440 | j));
            }
        }
    }
}

template <typename TA, typename TB, bool TA_T, int BT>
__global__ void __launch_bounds__(4 * BT) mixed_mma_kernel(
        const TA* __restrict__ a, const TB* __restrict__ b,
        float* __restrict__ c, int M, int K, int N, int k_chunk, int a_vec,
        int b_vec) {
    using SA = typename Raw<TA>::type;
    using SB = typename Raw<TB>::type;
    constexpr int THREADS = 4 * BT;
    constexpr int WM = BT / 16;          // row groups: warps a k group
    constexpr int NTILE = BT / 8;        // n-tiles a warp
    extern __shared__ __align__(16) unsigned char mx_smem_buf[];
    const SA* ag = reinterpret_cast<const SA*>(a)
        + (size_t)blockIdx.z * M * K;
    const SB* bg = reinterpret_cast<const SB*>(b)
        + (size_t)blockIdx.z * K * N;
    c += (size_t)blockIdx.z * M * N;
    const int m0 = blockIdx.y * BT, n0 = blockIdx.x * BT;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int rg = warp % WM, kw = warp / WM;
    const int ald = TA_T ? mx_ld<TA>(BT) : mx_ld<TA>(k_chunk);
    const int bld = mx_ld<TB>(BT);
    const int a_bytes = mx_a_bytes<TA, TB, TA_T>(BT, k_chunk);
    const int sbytes = mx_stage_bytes<TA, TB, TA_T>(BT, k_chunk);
    const int n_chunks = (K + k_chunk - 1) / k_chunk;

    auto stage = [&](int ci) {   // chunk ci into stage ci % 2
        SA* as = reinterpret_cast<SA*>(mx_smem_buf + (ci & 1) * sbytes);
        SB* bs = reinterpret_cast<SB*>(mx_smem_buf + (ci & 1) * sbytes
                                       + a_bytes);
        const int k0 = ci * k_chunk;
        if constexpr (TA_T)   // A [K, M]: rows k, contiguous along m
            stage_panel<THREADS>(as, ald, ag + (size_t)k0 * M + m0, M,
                                 k_chunk, BT, K - k0, M - m0, a_vec);
        else                  // A [M, K]: rows m, contiguous along k
            stage_panel<THREADS>(as, ald, ag + (size_t)m0 * K + k0, K, BT,
                                 k_chunk, M - m0, K - k0, a_vec);
        stage_panel<THREADS>(bs, bld, bg + (size_t)k0 * N + n0, N, k_chunk,
                             BT, K - k0, N - n0, b_vec);
    };

    float acc[NTILE][4];
#pragma unroll
    for (int i = 0; i < NTILE; ++i)
        acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    stage(0);
    cp_async_commit();
    for (int ci = 0; ci < n_chunks; ++ci) {
        cp_async_wait<0>();
        __syncthreads();     // chunk ci has landed; chunk ci - 1 is read
        if (ci + 1 < n_chunks) stage(ci + 1);
        cp_async_commit();
        const SA* as = reinterpret_cast<const SA*>(mx_smem_buf
                                                   + (ci & 1) * sbytes);
        const SB* bs = reinterpret_cast<const SB*>(
            mx_smem_buf + (ci & 1) * sbytes + a_bytes);
        for (int ks = 16 * kw; ks < k_chunk; ks += 32) {
            uint32_t af[4], bf[NTILE][2];
            a_frag<TA, TA_T>(af, as, ald, 16 * rg, ks, lane);
            b_frags<TB, NTILE>(bf, bs, bld, ks, lane);
#pragma unroll
            for (int nt = 0; nt < NTILE; ++nt)
                mma_bf16(acc[nt], af, bf[nt][0], bf[nt][1]);
        }
    }
    // the second k group hands its sums to the first through the panels'
    // shared memory
    cp_async_wait<0>();
    __syncthreads();
    float* red = reinterpret_cast<float*>(mx_smem_buf)
        + (rg * 32 + lane) * NTILE * 4;
    if (kw == 1) {
#pragma unroll
        for (int nt = 0; nt < NTILE; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) red[nt * 4 + e] = acc[nt][e];
    }
    __syncthreads();
    if (kw == 1) return;
#pragma unroll
    for (int nt = 0; nt < NTILE; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float v = acc[nt][e] + red[nt * 4 + e];
            const int row = m0 + 16 * rg + g + 8 * (e >> 1);
            const int col = n0 + (std::is_same<TB, int8_t>::value
                ? 32 * (nt / 4) + 4 * (2 * t + (e & 1)) + nt % 4
                : 8 * nt + 2 * t + (e & 1));
            if (row < M && col < N) c[(size_t)row * N + col] = v;
        }
}

// Row stride (elements) of a staged A panel: [BM][k_chunk + 16 bytes]
// for a row-major A (the pad turns rows 4 banks apart), [k_chunk][BM]
// for a transposed one; and one stage's bytes (A panel, then B [k_chunk]
// [BN]). Mirrors ops/probe_mma.dot_stage_bytes.
template <typename TA, bool TA_T, int BM>
__host__ __device__ __forceinline__ int a_ld(int k_chunk) {
    return TA_T ? BM : k_chunk + 16 / (int)sizeof(TA);
}
template <typename TA, typename TB, bool TA_T, int BM, int BN>
__host__ __device__ __forceinline__ int stage_bytes(int k_chunk) {
    return (TA_T ? k_chunk : BM) * a_ld<TA, TA_T, BM>(k_chunk) * sizeof(TA)
        + k_chunk * BN * sizeof(TB);
}

// C [batch, M, N] (or, n_split > 1, part [n_split, batch, M, N]) = A . B
// over this block's (BM x BN) tile and K range. blockIdx.z = batch index *
// n_split + split; split s contracts k in [s k_split, (s + 1) k_split).
// KG (1 or 2) groups of DOT_THREADS threads each take a KG-th of every
// staged chunk's k; with two, group 0 adds group 1's sums (through shared
// memory) and stores.
template <typename TA, typename TB, bool TA_T, int BM, int BN, int KG>
__global__ void __launch_bounds__(DOT_THREADS * KG) f32_dot_kernel(
        const TA* __restrict__ a, const TB* __restrict__ b,
        float* __restrict__ c, int M, int K, int N, int n_split,
        int k_split, int k_chunk, int a_vec, int b_vec,
        float* __restrict__ part) {
    static_assert(KG == 1 || KG == 2, "one or two k groups");
    constexpr int THREADS = DOT_THREADS * KG;
    constexpr int TM = BM * BN / (DOT_THREADS * DOT_TN);   // 4, or 2
    constexpr int NX = BN / DOT_TN;                        // threads along n
    extern __shared__ __align__(16) unsigned char dot_smem[];
    const int bi = blockIdx.z / n_split, split = blockIdx.z % n_split;
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
    const int kb = split * k_split, ke = min(K, kb + k_split);
    a += (size_t)bi * M * K;
    b += (size_t)bi * K * N;
    const int ald = a_ld<TA, TA_T, BM>(k_chunk);
    const int sbytes = stage_bytes<TA, TB, TA_T, BM, BN>(k_chunk);
    const int a_bytes = sbytes - k_chunk * BN * (int)sizeof(TB);
    const int n_chunks = (ke - kb + k_chunk - 1) / k_chunk;

    auto stage = [&](int ci) {   // chunk ci into stage ci % 2
        TA* as = reinterpret_cast<TA*>(dot_smem + (ci & 1) * sbytes);
        TB* bs = reinterpret_cast<TB*>(dot_smem + (ci & 1) * sbytes
                                       + a_bytes);
        const int k0 = kb + ci * k_chunk;
        if constexpr (TA_T)   // A [K, M]: rows k, contiguous along m
            stage_panel<THREADS>(as, ald, a + (size_t)k0 * M + m0, M,
                                 k_chunk, BM, ke - k0, M - m0, a_vec);
        else                  // A [M, K]: rows m, contiguous along k
            stage_panel<THREADS>(as, ald, a + (size_t)m0 * K + k0, K, BM,
                                 k_chunk, M - m0, ke - k0, a_vec);
        stage_panel<THREADS>(bs, BN, b + (size_t)k0 * N + n0, N, k_chunk,
                             BN, ke - k0, N - n0, b_vec);
    };

    const int tid = threadIdx.x % DOT_THREADS;
    const int kg = KG > 1 ? threadIdx.x / DOT_THREADS : 0;
    const int tx = tid % NX, ty = tid / NX;
    const int kh = k_chunk / KG;
    float acc[TM][DOT_TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < DOT_TN; ++j) acc[i][j] = 0.f;
    stage(0);
    cp_async_commit();
    for (int ci = 0; ci < n_chunks; ++ci) {
        cp_async_wait<0>();
        __syncthreads();   // chunk ci has landed; chunk ci - 1 is done with
        if (ci + 1 < n_chunks) stage(ci + 1);
        cp_async_commit();
        const TA* as = reinterpret_cast<const TA*>(dot_smem + (ci & 1)
                                                   * sbytes);
        const TB* bs = reinterpret_cast<const TB*>(dot_smem + (ci & 1)
                                                   * sbytes + a_bytes);
#pragma unroll 2
        for (int k = kg * kh; k < (kg + 1) * kh; k += 4) {
            float av[TM][4];          // av[i][kk] = A(ty TM + i, k + kk)
            if constexpr (TA_T) {
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) {
                    float col[TM];
                    lds<TM>(as + (k + kk) * ald + ty * TM, col);
#pragma unroll
                    for (int i = 0; i < TM; ++i) av[i][kk] = col[i];
                }
            } else {
#pragma unroll
                for (int i = 0; i < TM; ++i)
                    lds<4>(as + (ty * TM + i) * ald + k, av[i]);
            }
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                float bv[DOT_TN];
                lds<DOT_TN>(bs + (k + kk) * BN + tx * DOT_TN, bv);
#pragma unroll
                for (int i = 0; i < TM; ++i)
#pragma unroll
                    for (int j = 0; j < DOT_TN; ++j)
                        acc[i][j] = fmaf(av[i][kk], bv[j], acc[i][j]);
            }
        }
    }
    cp_async_wait<0>();
    if constexpr (KG > 1) {
        float* red = reinterpret_cast<float*>(dot_smem);
        __syncthreads();
        if (kg == 1)
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < DOT_TN; ++j)
                    red[(i * DOT_TN + j) * DOT_THREADS + tid] = acc[i][j];
        __syncthreads();
        if (kg == 1) return;
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < DOT_TN; ++j)
                acc[i][j] += red[(i * DOT_TN + j) * DOT_THREADS + tid];
    }
    float* out = n_split == 1 ? c + (size_t)bi * M * N
        : part + ((size_t)split * (gridDim.z / n_split) + bi) * M * N;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int row = m0 + ty * TM + i;
#pragma unroll
        for (int j = 0; j < DOT_TN; ++j) {
            const int col = n0 + tx * DOT_TN + j;
            if (row < M && col < N) out[(size_t)row * N + col] = acc[i][j];
        }
    }
}

// c[i] = part[0][i] + part[1][i] + ... + part[n_split - 1][i], in that
// order, for the `total` elements of C
__global__ void __launch_bounds__(SUM_THREADS) dot_split_sum_kernel(
        const float* __restrict__ part, float* __restrict__ c,
        long long total, int n_split) {
    for (long long i = blockIdx.x * (long long)SUM_THREADS + threadIdx.x;
         i < total; i += (long long)gridDim.x * SUM_THREADS) {
        float s = 0.f;
        for (int sp = 0; sp < n_split; ++sp) s += part[sp * total + i];
        c[i] = s;
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

bool bad_shape(int batch, int M, int K, int N) {
    return batch < 1 || batch > 65535 || M < 1 || K < 1 || N < 1
        || (M + 31) / 32 > 65535;
}

template <typename TA, typename TB, bool TA_T, int BT>
int mixed_launch(const void* a, const void* b, void* c, int batch, int M,
                 int K, int N, int k_chunk, cudaStream_t st) {
    const int smem = mx_smem<TA, TB, TA_T>(BT, K, k_chunk);
    if (smem > MX_SMEM) return ERR_SHAPE;
    const bool a_vec = reinterpret_cast<uintptr_t>(a) % 16 == 0
        && (size_t)(TA_T ? M : K) * sizeof(TA) % 16 == 0;
    const bool b_vec = reinterpret_cast<uintptr_t>(b) % 16 == 0
        && (size_t)N * sizeof(TB) % 16 == 0;
    mixed_mma_kernel<TA, TB, TA_T, BT>
        <<<dim3((N + BT - 1) / BT, (M + BT - 1) / BT, batch), 4 * BT, smem,
           st>>>(static_cast<const TA*>(a), static_cast<const TB*>(b),
                 static_cast<float*>(c), M, K, N, k_chunk, a_vec, b_vec);
    return (int)cudaGetLastError();
}

template <typename TA, typename TB>
int mixed_by_plan(int trans_a, const void* a, const void* b, void* c,
                  int batch, int M, int K, int N, int tile, int k_chunk,
                  cudaStream_t st) {
#define WA_MX(T_, BT)                                                       \
    if ((trans_a != 0) == T_ && tile == BT)                                 \
        return mixed_launch<TA, TB, T_, BT>(a, b, c, batch, M, K, N,        \
                                            k_chunk, st);
    WA_MX(false, 32)
    WA_MX(false, 64)
    WA_MX(true, 32)
    WA_MX(true, 64)
#undef WA_MX
    return ERR_SHAPE;
}

// the launch plan of P3's f32 contraction (ops/probe_mma.DotPlan)
struct DotPlan {
    int bm, bn, k_groups, n_split, k_split, k_chunk;
};

// P3's f32 contraction at one plan: the tile kernel, then (n_split > 1)
// the split sum; cudaGetLastError after each launch
template <typename TA, typename TB, bool TA_T, int BM, int BN, int KG>
int f32_dot(const void* a, const void* b, void* c, int batch, int M, int K,
            int N, DotPlan p, float* part, cudaStream_t st) {
    const int n_chunks = (min(K, p.k_split) + p.k_chunk - 1) / p.k_chunk;
    const int smem = max((n_chunks > 1 ? 2 : 1)
                         * stage_bytes<TA, TB, TA_T, BM, BN>(p.k_chunk),
                         KG > 1 ? BM * BN * 4 : 0);
    if (smem > DOT_SMEM) return ERR_SHAPE;
    const bool a_vec = reinterpret_cast<uintptr_t>(a) % 16 == 0
        && (size_t)(TA_T ? M : K) * sizeof(TA) % 16 == 0;
    const bool b_vec = reinterpret_cast<uintptr_t>(b) % 16 == 0
        && (size_t)N * sizeof(TB) % 16 == 0;
    f32_dot_kernel<TA, TB, TA_T, BM, BN, KG>
        <<<dim3((N + BN - 1) / BN, (M + BM - 1) / BM, batch * p.n_split),
           DOT_THREADS * KG, smem, st>>>(
            static_cast<const TA*>(a), static_cast<const TB*>(b),
            static_cast<float*>(c), M, K, N, p.n_split, p.k_split,
            p.k_chunk, a_vec, b_vec, part);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || p.n_split == 1) return (int)err;
    const long long total = (long long)batch * M * N;
    dot_split_sum_kernel<<<(int)min((total + SUM_THREADS - 1) / SUM_THREADS,
                                    (long long)4 * 132), SUM_THREADS, 0,
                           st>>>(part, static_cast<float*>(c), total,
                                 p.n_split);
    return (int)cudaGetLastError();
}

template <typename TA, typename TB>
int f32_dot_by_plan(int trans_a, const void* a, const void* b, void* c,
                    int batch, int M, int K, int N, DotPlan p, float* part,
                    cudaStream_t st) {
#define WA_TILE(BM, BN, KG)                                                 \
    if (p.bm == BM && p.bn == BN && p.k_groups == KG)                       \
        return trans_a                                                      \
            ? f32_dot<TA, TB, true, BM, BN, KG>(a, b, c, batch, M, K, N, p, \
                                                part, st)                   \
            : f32_dot<TA, TB, false, BM, BN, KG>(a, b, c, batch, M, K, N,   \
                                                 p, part, st);
    WA_TILE(32, 64, 1)
    WA_TILE(64, 32, 1)
    WA_TILE(32, 32, 1)
    WA_TILE(32, 32, 2)
#undef WA_TILE
    return ERR_SHAPE;
}

}  // namespace
}  // namespace wa

// P1: a [M, K] int8, b [K, N] int8, c [M, N] int32, all contiguous; K
// staged k_chunk (a multiple of 32, ops/probe_mma.int8_plan) at a time.
extern "C" int wa_probe_int8_mma(const void* a, const void* b, void* c,
                                 int M, int K, int N, int k_chunk,
                                 void* stream) {
    using namespace wa;
    if (bad_shape(1, M, K, N) || (M + I8_TILE - 1) / I8_TILE > 65535
            || k_chunk < 32 || k_chunk % 32 != 0
            || int8_smem(K, k_chunk) > 48 * 1024)
        return ERR_SHAPE;
    const bool a_vec = reinterpret_cast<uintptr_t>(a) % 16 == 0
        && K % 16 == 0;
    const bool b_vec = reinterpret_cast<uintptr_t>(b) % 16 == 0
        && N % 16 == 0;
    int8_mma_kernel<<<dim3((N + I8_TILE - 1) / I8_TILE,
                           (M + I8_TILE - 1) / I8_TILE),
                      I8_THREADS, int8_smem(K, k_chunk),
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
        static_cast<int32_t*>(c), M, K, N, k_chunk, a_vec, b_vec);
    return (int)cudaGetLastError();
}

// P2, P3 (b), (i): c [batch, M, N] f32 = a . b on the tensor cores; a
// [batch, M, K] or (trans_a) [batch, K, M] of dtype ta (f32, bf16, int8),
// b [batch, K, N] of dtype tb (bf16, int8), all contiguous; tile x tile
// outputs a block (32 or 64), K staged k_chunk (a multiple of 32) at a
// time (ops/probe_mma.mixed_plan).
extern "C" int wa_probe_mma_bf16(const void* a, int ta, int trans_a,
                                 const void* b, int tb, void* c, int batch,
                                 int M, int K, int N, int tile, int k_chunk,
                                 void* stream) {
    using namespace wa;
    if (bad_shape(batch, M, K, N) || k_chunk < 32 || k_chunk % 32 != 0)
        return ERR_SHAPE;
    auto st = static_cast<cudaStream_t>(stream);
#define WA_MIXED(TA_CODE, TA)                                               \
    if (ta == TA_CODE && tb == BF16)                                        \
        return mixed_by_plan<TA, __nv_bfloat16>(trans_a, a, b, c, batch, M, \
                                                K, N, tile, k_chunk, st);   \
    if (ta == TA_CODE && tb == I8)                                          \
        return mixed_by_plan<TA, int8_t>(trans_a, a, b, c, batch, M, K, N,  \
                                         tile, k_chunk, st);
    WA_MIXED(F32, float)
    WA_MIXED(BF16, __nv_bfloat16)
    WA_MIXED(I8, int8_t)
#undef WA_MIXED
    return ERR_DTYPE;
}

// P3 (a), (c), (e)-(h), (j): the same contraction on the CUDA cores in
// f32; ta and tb each f32 or int8, all contiguous. The plan (ops/
// probe_mma.dot_plan): a bm x bn tile (32 x 64, 64 x 32, or 32 x 32 with
// k_groups 1 or 2), n_split ranges of k_split (a multiple of 64 when
// n_split > 1; part, f32 [n_split * batch * M * N], takes the partials),
// staged k_chunk (a multiple of 16) at a time.
extern "C" int wa_probe_dot_f32(const void* a, int ta, int trans_a,
                                const void* b, int tb, void* c, int batch,
                                int M, int K, int N, int bm, int bn,
                                int k_groups, int n_split, int k_split,
                                int k_chunk, float* part, void* stream) {
    using namespace wa;
    if (bad_shape(batch, M, K, N) || (M + 31) / 32 > 65535 || n_split < 1
            || (long long)batch * n_split > 65535 || k_split < 1
            || (long long)n_split * k_split < K
            || (long long)(n_split - 1) * k_split >= K
            || (n_split > 1 && (k_split % 64 != 0 || part == nullptr))
            || k_chunk < 16 || k_chunk % 16 != 0)
        return ERR_SHAPE;
    auto st = static_cast<cudaStream_t>(stream);
    const DotPlan p{bm, bn, k_groups, n_split, k_split, k_chunk};
    if (ta == F32 && tb == F32)
        return f32_dot_by_plan<float, float>(trans_a, a, b, c, batch, M, K,
                                             N, p, part, st);
    if (ta == F32 && tb == I8)
        return f32_dot_by_plan<float, int8_t>(trans_a, a, b, c, batch, M, K,
                                              N, p, part, st);
    if (ta == I8 && tb == F32)
        return f32_dot_by_plan<int8_t, float>(trans_a, a, b, c, batch, M, K,
                                              N, p, part, st);
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
