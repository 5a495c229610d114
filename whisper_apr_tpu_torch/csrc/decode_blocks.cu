// Per-block decode kernels for one token at batch 1: K1 self_block,
// K2 cross_block and K3 ffn_block.
//
// Replace the Pallas kernels of whisper_apr_tpu/ops/decode_blocks.py
// (self_block/_self_kernel, cross_block/_cross_kernel,
// ffn_block/_ffn_kernel) and compute what they compute:
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
//
// What bounds them on the card: at batch 1 each call reads every int8
// weight byte of its sub-block once (large-v3: 6.55 MB QKV [1280, 3840]
// plus o-proj [1280, 1280], 3.3 MB q+o-proj, 13.1 MB fc1+fc2 per layer) and, for attention, every live
// cache row once (cross8 large-v3: 1500 int8 rows of K and V, 3.8 MB per
// layer). Arithmetic is two flops per byte, far under the card's
// flop/byte ratio, so the only lever is moving fewer bytes and keeping
// enough blocks in flight to pull the bandwidth.
//
// Design: one C entry per op. K1 and K3 make a few launches each, so that
// every matvec spreads its columns over many SMs (MV_COLS columns per
// block, the LN recomputed per block from the D-long input) and the
// attention spreads its rows (attention.cuh, at one slot); the k/v row of
// the current token is written out for the caller to scatter after the
// layer loop. K2 is one launch: at batch 1 each of its four steps moves
// well under a microsecond of bytes, so launches and the serial path
// inside each block, not bandwidth, set its time (below).
#include "attention.cuh"
#include "cp_async.cuh"

namespace wa {
namespace {

enum Epi { EPI_AFFINE = 0, EPI_GELU = 1, EPI_RESID = 2 };

// out[n] = epilogue(sum_k h[k] * w[k, n]) with h = [LN](xin) [rounded to
// bf16]; EPI_AFFINE: acc*s+b (f32 out), EPI_GELU: gelu(acc*s+b) [rounded
// to bf16] (f32 out), EPI_RESID: acc*s+b+resid -> RT out.
template <typename IT, typename RT, int EPI>
__global__ void __launch_bounds__(MV_THREADS) qmv_kernel(
        const IT* __restrict__ xin, int K, int N,
        const float* __restrict__ ln_w, const float* __restrict__ ln_b,
        int round_to_bf16, const int8_t* __restrict__ w,
        const float* __restrict__ scale, const float* __restrict__ bias,
        const RT* __restrict__ resid, void* __restrict__ out) {
    extern __shared__ float hs[];
    __shared__ float red[MV_KLANES][MV_COLS + 1];
    __shared__ float scratch[32];
    stage_input(xin, K, ln_w, ln_b, round_to_bf16, hs, scratch);
    const float acc = block_matvec_cols(hs, K, w, N, red);
    if (threadIdx.x < MV_COLS) {
        const int n = blockIdx.x * MV_COLS + threadIdx.x;
        const float y = acc * scale[n] + bias[n];
        if constexpr (EPI == EPI_AFFINE) {
            static_cast<float*>(out)[n] = y;
        } else if constexpr (EPI == EPI_GELU) {
            float g = 0.5f * y * (1.0f + erff(y * 0.7071067811865475f));
            if (round_to_bf16) g = round_bf16(g);
            static_cast<float*>(out)[n] = g;
        } else {
            static_cast<RT*>(out)[n] = from_f32<RT>(y + to_f32(resid[n]));
        }
    }
}

template <typename IT, typename RT, int EPI>
cudaError_t launch_qmv(const void* xin, int K, int N, const float* ln_w,
                       const float* ln_b, int round_to_bf16, const int8_t* w,
                       const float* scale, const float* bias,
                       const void* resid, void* out, cudaStream_t st) {
    const size_t smem = (size_t)K * sizeof(float);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            qmv_kernel<IT, RT, EPI>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    qmv_kernel<IT, RT, EPI><<<N / MV_COLS, MV_THREADS, smem, st>>>(
        static_cast<const IT*>(xin), K, N, ln_w, ln_b, round_to_bf16, w,
        scale, bias, static_cast<const RT*>(resid), out);
    return cudaGetLastError();
}

template <typename XT>
cudaError_t self_block_t(const void* x, int D, int H, const float* ln_w,
                         const float* ln_b, const int8_t* wqkv,
                         const float* sqkv, const float* bqkv,
                         const void* kq, const float* ks, const void* vq,
                         const float* vs, int cache_dtype, int T, int pos,
                         const int8_t* wo, const float* wos,
                         const float* wob, void* x_out, void* k_row,
                         float* k_scale, void* v_row, float* v_scale,
                         float* qkv, float* part, float* attn,
                         cudaStream_t st) {
    const int bf = sizeof(XT) == 2;
    cudaError_t e = launch_qmv<XT, XT, EPI_AFFINE>(
        x, D, 3 * D, ln_w, ln_b, bf, wqkv, sqkv, bqkv, nullptr, qkv, st);
    if (e != cudaSuccess) return e;
    // rows < pos are the history; the current row rides in qkv[D:3D]
    AttnArgs a{};
    a.q = qkv; a.q_stride = 3 * D;
    a.kc = kq; a.vc = vq; a.ks = ks; a.vs = vs;
    a.kv_stride = (long long)T * D; a.T = T; a.D = D; a.H = H;
    a.lens = nullptr; a.n_valid = pos; a.n_loop = pos;
    a.n_splits = n_att_splits(pos); a.part = part;
    a.kv_cur = qkv + D; a.cur_stride = 3 * D;
    a.k_row = k_row; a.v_row = v_row; a.k_scale = k_scale;
    a.v_scale = v_scale; a.attn_out = attn;
    e = attention(cache_dtype, a, 1, st);
    if (e != cudaSuccess) return e;
    return launch_qmv<float, XT, EPI_RESID>(attn, D, D, nullptr, nullptr, bf,
                                            wo, wos, wob, x, x_out, st);
}

// --------------------------------------------------------------------------
// K2 cross_block: one launch, one thread block cluster per head
// --------------------------------------------------------------------------
//
// Grid (C, H) with clusters of (C, 1, 1): the C blocks of head h's cluster
// split the head's work three ways (ops/decode_blocks.cross_plan chooses
// C, the rows per block and the rows staged at a time):
//   - q_h = LN2(x) . Wq[:, 64 h : 64 h + 64]: block r sums Wq rows
//     [r D / C, (r + 1) D / C) and stores its share into every block of
//     the cluster (st.async into distributed shared memory, counted by
//     the receiver's transaction barrier); each adds them in rank order;
//   - attention: block r takes cache rows [r rows, (r + 1) rows) below
//     n_loop, staged a chunk at a time: scores by groups of 4 threads a
//     row, the chunk's max through the warps, weights a row a thread, the
//     weighted V rows a dim a thread (a running max and sum across
//     chunks); its (m, l, acc[64]) goes to every block as q's shares did,
//     and each merges them in rank order;
//   - o-proj: y = sum_h attn_h . Wo[64 h : 64 h + 64, :]; block r takes
//     the columns [16 (r U / C), 16 ((r + 1) U / C)), U = D / 16, writes
//     its head's partial to scratch, and the last of the H blocks of that
//     column range to finish (an atomic ticket) adds the H partials in
//     head order, then the scale, the bias and the residual.
// Every sum runs in a fixed order: two runs give the same bits.
// x, and the block's share of Wq, of Wo and its first chunk of K/V rows
// (and their row scales) are loaded as the block starts (cp.async into
// shared memory), so the LayerNorm, the q matvec and the first exchange
// overlap those loads. Measured on an H100 (PERF.md): the time is the
// serial path of one block, a few hundred cycles to a microsecond a
// step, not the bytes.

constexpr int CB_THREADS = 256;
constexpr int CB_GROUPS = CB_THREADS / 4;          // scores: 4 threads a row
constexpr int CB_MAX_CHUNK = CB_THREADS;           // rows staged at a time
constexpr int CB_XMAX = 8;                         // x elements a thread loads
constexpr int CB_MAX_CLUSTER = 16;
constexpr int CB_KLANES = CB_THREADS / 16;         // q matvec: 16 threads a row
constexpr int CB_RED = 1024;                       // floats of reduction scratch
constexpr unsigned FULL = 0xffffffffu;

// shared-memory layout of a K2 block, in bytes (every offset a multiple
// of 16)
struct CrossLayout {
    int wq_rows, wo_cols;                 // most rows / columns a block takes
    int xs, wq, wo, k, v, ks, vs, s, p, red, qall, pall, q, att, flag,
        bars, total;
};

__host__ __device__ inline CrossLayout cross_layout(int D, int C, int chunk,
                                                    int cache_size) {
    CrossLayout L;
    L.wq_rows = (D + C - 1) / C;
    L.wo_cols = 16 * ((D / 16 + C - 1) / C);
    int o = 0;
    L.xs = o;   o += D * 4;
    L.wq = o;   o += L.wq_rows * HD;
    L.wo = o;   o += HD * L.wo_cols;
    L.k = o;    o += chunk * HD * cache_size;
    L.v = o;    o += chunk * HD * cache_size;
    L.ks = o;   o += chunk * 4;
    L.vs = o;   o += chunk * 4;
    L.s = o;    o += chunk * 4;           // the chunk's scores
    L.p = o;    o += chunk * 4;           // and weights
    L.red = o;  o += CB_RED * 4;
    L.qall = o; o += C * HD * 4;          // each block's share of q_h
    L.pall = o; o += C * (HD + 4) * 4;    // each block's m, l, acc[64]
    L.q = o;    o += HD * 4;
    L.att = o;  o += HD * 4;
    L.flag = o; o += 16;
    L.bars = o; o += 16;                  // the two barriers of the exchanges
    L.total = o;
    return L;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// Transaction barriers in shared memory (mbarrier): a block's barrier
// completes once the bytes it expects have been stored into it by
// st.async from the cluster's blocks; no cluster-wide barrier, no fence.
__device__ __forceinline__ void mbar_init_expect(uint64_t* bar,
                                                 uint32_t bytes) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
    uint32_t done;
    do {
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(smem_addr(bar)) : "memory");
    } while (!done);
}

// the address of local shared memory p in the cluster's block `rank`
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
    uint32_t a;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
    return a;
}

// v into another block's shared memory at cluster address `to`; counts 4
// bytes against that block's barrier at cluster address `bar`
__device__ __forceinline__ void st_async(uint32_t to, float v, uint32_t bar) {
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
                 "[%0], %1, [%2];\n"
                 :: "r"(to), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

// 16 consecutive cache elements (a quarter of a head's row) in shared
// memory, as f32
__device__ __forceinline__ void row16(const float* p, float (&v)[16]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float4 f = reinterpret_cast<const float4*>(p)[i];
        v[4 * i] = f.x; v[4 * i + 1] = f.y; v[4 * i + 2] = f.z;
        v[4 * i + 3] = f.w;
    }
}
__device__ __forceinline__ void row16(const __nv_bfloat16* p,
                                      float (&v)[16]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const uint4 u = reinterpret_cast<const uint4*>(p)[i];
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            v[8 * i + 2 * j] = __uint_as_float(w[j] << 16);
            v[8 * i + 2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
        }
    }
}
// int8 bytes widened exactly at the FMA rate (the int-to-float
// conversion runs at a quarter of it): biased to b + 128 by the xor, set
// as the low byte of the f32 2^23 + (b + 128) by a byte permute, the bias
// taken off by one subtraction
__device__ __forceinline__ void row16(const int8_t* p, float (&v)[16]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u,
                           u.z ^ 0x80808080u, u.w ^ 0x80808080u};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int b = 0; b < 4; ++b)
            v[4 * j + b] = __uint_as_float(
                __byte_perm(w[j], 0x4B000000u, 0x7540 | b)) - 8388736.f;
}
__device__ __forceinline__ void row16(const __nv_fp8_e4m3* p,
                                      float (&v)[16]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_fp8_e4m3* e = reinterpret_cast<const __nv_fp8_e4m3*>(&u);
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = to_f32(e[i]);
}

// one cache element in shared memory as f32 (int8 widened as row16 does)
template <typename CT>
__device__ __forceinline__ float elem(const CT* p) { return to_f32(*p); }
template <>
__device__ __forceinline__ float elem<int8_t>(const int8_t* p) {
    const uint32_t u = *reinterpret_cast<const uint8_t*>(p) ^ 0x80u;
    return __uint_as_float(0x4B000000u | u) - 8388736.f;
}

// grid (C, H), clusters (C, 1, 1); see above
template <typename XT, typename CT>
__global__ void __launch_bounds__(CB_THREADS) cross_block_kernel(
        const XT* __restrict__ x, int D, const float* __restrict__ ln_w,
        const float* __restrict__ ln_b, const int8_t* __restrict__ wq,
        const float* __restrict__ sq, const float* __restrict__ bq,
        const CT* __restrict__ kc, const CT* __restrict__ vc,
        const float* __restrict__ ks, const float* __restrict__ vs,
        int n_valid, int n_loop, int rows, int chunk,
        const int8_t* __restrict__ wo, const float* __restrict__ wos,
        const float* __restrict__ wob, XT* __restrict__ x_out,
        float* __restrict__ ypart, int* __restrict__ tickets) {
    extern __shared__ __align__(16) unsigned char cb_smem[];
    const int C = gridDim.x, r = blockIdx.x, h = blockIdx.y, H = gridDim.y;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const CrossLayout lay = cross_layout(D, C, chunk, sizeof(CT));
    // the exchanges' barriers expect every block's share of q_h and its
    // (m, l, acc[64]); a block stores into the others only once all have
    // set theirs up: arrive here, wait before the first remote store
    uint64_t* bar_q = reinterpret_cast<uint64_t*>(cb_smem + lay.bars);
    uint64_t* bar_p = bar_q + 1;
    if (tid == 0) {
        mbar_init_expect(bar_q, C * HD * 4);
        mbar_init_expect(bar_p, C * (HD + 2) * 4);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    float* xs = reinterpret_cast<float*>(cb_smem + lay.xs);
    int8_t* wq_s = reinterpret_cast<int8_t*>(cb_smem + lay.wq);
    int8_t* wo_s = reinterpret_cast<int8_t*>(cb_smem + lay.wo);
    CT* k_s = reinterpret_cast<CT*>(cb_smem + lay.k);
    CT* v_s = reinterpret_cast<CT*>(cb_smem + lay.v);
    float* ks_s = reinterpret_cast<float*>(cb_smem + lay.ks);
    float* vs_s = reinterpret_cast<float*>(cb_smem + lay.vs);
    float* s_sh = reinterpret_cast<float*>(cb_smem + lay.s);
    float* p_sh = reinterpret_cast<float*>(cb_smem + lay.p);
    float* red = reinterpret_cast<float*>(cb_smem + lay.red);
    float* qall = reinterpret_cast<float*>(cb_smem + lay.qall);  // [C][64]
    float* pall = reinterpret_cast<float*>(cb_smem + lay.pall);  // [C][68]
    float* qf = reinterpret_cast<float*>(cb_smem + lay.q);
    float* att = reinterpret_cast<float*>(cb_smem + lay.att);
    int* flag = reinterpret_cast<int*>(cb_smem + lay.flag);

    // this block's shares of Wq's rows, Wo's columns and the cache rows
    const int k0 = r * D / C, k1 = (r + 1) * D / C;
    const int U = D / 16;
    const int c0 = 16 * (r * U / C), c1 = 16 * ((r + 1) * U / C);
    const int t0 = min(n_loop, r * rows), t1 = min(n_loop, t0 + rows);
    const int n_chunks = (t1 - t0 + chunk - 1) / chunk;

    // 1. load x, and start the copies: Wq's rows, Wo's columns, the first
    //    chunk of K/V rows; three groups, in that order. Then the
    //    epilogue's operands of this block's columns (any block may finish
    //    last)
    float xr[CB_XMAX];
#pragma unroll
    for (int j = 0; j < CB_XMAX; ++j) {
        const int i = tid + j * CB_THREADS;
        xr[j] = i < D ? to_f32(x[i]) : 0.f;
    }
    for (int e = tid; e < (k1 - k0) * 4; e += CB_THREADS) {
        const int row = e >> 2, c = (e & 3) * 16;
        cp_async16(wq_s + row * HD + c, wq + (size_t)(k0 + row) * D + h * HD
                   + c, 16);
    }
    cp_async_commit();
    const int wo_pieces = (c1 - c0) / 16;
    for (int e = tid; e < HD * wo_pieces; e += CB_THREADS) {
        const int d = e / wo_pieces, c = (e % wo_pieces) * 16;
        cp_async16(wo_s + d * lay.wo_cols + c,
                   wo + (size_t)(h * HD + d) * D + c0 + c, 16);
    }
    cp_async_commit();
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
    stage_rows(t0, min(chunk, t1 - t0));
    float ep_s[CB_RED / CB_THREADS], ep_b[CB_RED / CB_THREADS],
        ep_x[CB_RED / CB_THREADS];
#pragma unroll
    for (int j = 0; j < CB_RED / CB_THREADS; ++j) {
        const int n = c0 + tid + j * CB_THREADS;
        const bool in = n < c1;
        ep_s[j] = in ? wos[n] : 0.f;
        ep_b[j] = in ? wob[n] : 0.f;
        ep_x[j] = in ? to_f32(x[n]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < CB_XMAX; ++j) {
        const int i = tid + j * CB_THREADS;
        if (i < D) xs[i] = xr[j];
    }
    __syncthreads();

    // 2. LayerNorm: every warp takes the f32 statistics over all of x
    //    itself (the same sums in the same order), no block reduction; the
    //    block's Wq rows normalized and rounded to x's dtype
    float sum = 0.f;
    for (int i = lane; i < D; i += 32) sum += xs[i];
    const float mean = warp_sum(sum) / (float)D;
    float var = 0.f;
    for (int i = lane; i < D; i += 32) {
        const float d = xs[i] - mean;
        var += d * d;
    }
    const float rstd = rsqrtf(warp_sum(var) / (float)D + LN_EPS);
    __syncthreads();                // every warp has read x
    for (int i = k0 + tid; i < k1; i += CB_THREADS) {
        const float hv = (xs[i] - mean) * rstd * ln_w[i] + ln_b[i];
        xs[i] = sizeof(XT) == 2 ? round_bf16(hv) : hv;
    }
    cp_async_wait<2>();             // Wq's rows have landed
    __syncthreads();

    // 3. this block's share of q_h (16 threads of 4 columns a row, 16 rows
    //    in flight), stored into every block of the cluster; each adds the
    //    shares in rank order
    {
        const int c4 = tid & 15, kl = tid >> 4;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        for (int k = k0 + kl; k < k1; k += CB_KLANES) {
            const char4 w = *reinterpret_cast<const char4*>(
                wq_s + (k - k0) * HD + 4 * c4);
            const float hv = xs[k];
            a0 += hv * (float)w.x;
            a1 += hv * (float)w.y;
            a2 += hv * (float)w.z;
            a3 += hv * (float)w.w;
        }
        a0 += __shfl_xor_sync(FULL, a0, 16);
        a1 += __shfl_xor_sync(FULL, a1, 16);
        a2 += __shfl_xor_sync(FULL, a2, 16);
        a3 += __shfl_xor_sync(FULL, a3, 16);
        if (lane < 16) {
            float* o = red + warp * HD + 4 * c4;
            o[0] = a0; o[1] = a1; o[2] = a2; o[3] = a3;
        }
    }
    __syncthreads();
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    {   // the 4 groups of 64 threads each store to every 4th block
        const int c = tid & (HD - 1);
        float q = 0.f;
#pragma unroll
        for (int w = 0; w < CB_THREADS / 32; ++w) q += red[w * HD + c];
        for (int rr = tid >> 6; rr < C; rr += CB_THREADS / HD)
            st_async(cluster_addr(qall + r * HD + c, rr), q,
                     cluster_addr(bar_q, rr));
    }
    mbar_wait(bar_q);               // every block's share of q_h is in place
    if (tid < HD) {
        float qs[CB_MAX_CLUSTER];
#pragma unroll
        for (int rr = 0; rr < CB_MAX_CLUSTER; ++rr)
            qs[rr] = rr < C ? qall[rr * HD + tid] : 0.f;
        float q = 0.f;
#pragma unroll
        for (int rr = 0; rr < CB_MAX_CLUSTER; ++rr)
            if (rr < C) q += qs[rr];
        qf[tid] = (q * sq[h * HD + tid] + bq[h * HD + tid]) * QSCALE;
    }
    cp_async_wait<0>();             // Wo's columns and the first rows too
    __syncthreads();
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
    {   // as q's shares: each group of 64 threads to every 4th block
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
    // M) once, then the sums in rank order
    mbar_wait(bar_p);
    float* fac = red + 4 * HD;
    if (tid < C) {
        float M = -INFINITY;
#pragma unroll
        for (int rr = 0; rr < CB_MAX_CLUSTER; ++rr)
            if (rr < C) M = fmaxf(M, pall[rr * (HD + 4)]);
        fac[tid] = expf(pall[tid * (HD + 4)] - M);  // an empty block: 0
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
        for (int d = dc * dlen; d < (dc + 1) * dlen; ++d) {
            const char4 w = *reinterpret_cast<const char4*>(
                wo_s + d * lay.wo_cols + 4 * g);
            const float av = att[d];
            a0 += av * (float)w.x;
            a1 += av * (float)w.y;
            a2 += av * (float)w.z;
            a3 += av * (float)w.w;
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
    //    partials in head order, then scale, bias and residual
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");    // release
    __syncthreads();
    if (tid == 0) {
        const int ticket = atomicAdd(tickets + r, 1);
        *flag = ticket == H - 1;
        if (ticket == H - 1)
            asm volatile("fence.acq_rel.gpu;\n" ::: "memory");  // acquire
    }
    __syncthreads();
    if (!*flag) return;
#pragma unroll
    for (int j = 0; j < CB_RED / CB_THREADS; ++j) {
        const int n = c0 + tid + j * CB_THREADS;
        if (n < c1) {
            float y = 0.f;
            for (int hh = 0; hh < H; ++hh)
                y += __ldcg(ypart + (size_t)hh * D + n);
            x_out[n] = from_f32<XT>(y * ep_s[j] + ep_b[j] + ep_x[j]);
        }
    }
    if (tid == 0) tickets[r] = 0;   // ready for the next launch
}

template <typename XT, typename CT>
int launch_cross(const void* x, int D, int H, const float* ln_w,
                 const float* ln_b, const int8_t* wq, const float* sq,
                 const float* bq, const void* kc, const float* ks,
                 const void* vc, const float* vs, int n_valid, int n_loop,
                 int C, int rows, int chunk, const int8_t* wo,
                 const float* wos, const float* wob, void* x_out,
                 float* ypart, int* tickets, cudaStream_t st) {
    const auto kernel = cross_block_kernel<XT, CT>;
    const int smem = cross_layout(D, C, chunk, sizeof(CT)).total;
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
        &cfg, kernel, static_cast<const XT*>(x), D, ln_w, ln_b, wq, sq, bq,
        static_cast<const CT*>(kc), static_cast<const CT*>(vc), ks, vs,
        n_valid, n_loop, rows, chunk, wo, wos, wob, static_cast<XT*>(x_out),
        ypart, tickets);
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
#define WA_CROSS_CT(CT)                                                      \
    launch_cross<XT, CT>(x, D, H, ln_w, ln_b, wq, sq, bq, kc, ks, vc, vs,    \
                         n_valid, n_loop, C, rows, chunk, wo, wos, wob,      \
                         x_out, ypart, tickets, st)
    switch (cache_dtype) {
        case F32: return WA_CROSS_CT(float);
        case BF16: return WA_CROSS_CT(__nv_bfloat16);
        case I8: return WA_CROSS_CT(int8_t);
        case FP8: return WA_CROSS_CT(__nv_fp8_e4m3);
        default: return ERR_DTYPE;
    }
#undef WA_CROSS_CT
}

template <typename XT>
cudaError_t ffn_block_t(const void* x, int D, int Hd, const float* ln_w,
                        const float* ln_b, const int8_t* w1, const float* s1,
                        const float* b1, const int8_t* w2, const float* s2,
                        const float* b2, void* x_out, float* g,
                        cudaStream_t st) {
    const int bf = sizeof(XT) == 2;
    cudaError_t e = launch_qmv<XT, XT, EPI_GELU>(
        x, D, Hd, ln_w, ln_b, bf, w1, s1, b1, nullptr, g, st);
    if (e != cudaSuccess) return e;
    return launch_qmv<float, XT, EPI_RESID>(g, Hd, D, nullptr, nullptr, bf,
                                            w2, s2, b2, x, x_out, st);
}

}  // namespace
}  // namespace wa

using namespace wa;

extern "C" int wa_self_block(
        const void* x, int x_dtype, int D, int H, const void* ln_w,
        const void* ln_b, const void* wqkv, const void* sqkv,
        const void* bqkv, const void* kq, const void* ks, const void* vq,
        const void* vs, int cache_dtype, int T, int pos, const void* wo,
        const void* wos, const void* wob, void* x_out, void* k_row,
        void* k_scale, void* v_row, void* v_scale, void* qkv, void* part,
        void* attn, void* stream) {
    if (!shape_ok(D, H) || pos < 0 || pos > T) return ERR_SHAPE;
    if ((cache_dtype == I8) != (ks != nullptr && vs != nullptr))
        return ERR_DTYPE;
    auto st = static_cast<cudaStream_t>(stream);
#define WA_SELF(XT)                                                          \
    self_block_t<XT>(x, D, H, (const float*)ln_w, (const float*)ln_b,        \
                     (const int8_t*)wqkv, (const float*)sqkv,                \
                     (const float*)bqkv, kq, (const float*)ks, vq,           \
                     (const float*)vs, cache_dtype, T, pos,                 \
                     (const int8_t*)wo,                                      \
                     (const float*)wos, (const float*)wob, x_out, k_row,     \
                     (float*)k_scale, v_row, (float*)v_scale, (float*)qkv,   \
                     (float*)part, (float*)attn, st)
    if (x_dtype == F32) return (int)WA_SELF(float);
    if (x_dtype == BF16) return (int)WA_SELF(__nv_bfloat16);
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
    if (!shape_ok(D, H) || D > CB_THREADS * CB_XMAX || T < 1 || enc_len < 0
            || enc_len > T)
        return ERR_SHAPE;
    // no valid row at all: every padded row takes part at score NEG
    const int n_loop = enc_len > 0 ? enc_len : T;
    if (cluster < 1 || cluster > CB_MAX_CLUSTER || rows < 1
            || (long long)rows * cluster < n_loop || chunk < CB_GROUPS
            || chunk > CB_MAX_CHUNK || chunk % CB_GROUPS != 0
            || cross_layout(D, cluster, chunk, cache_dtype == F32 ? 4
                            : cache_dtype == BF16 ? 2 : 1).total
               > 227 * 1024
            || 16 * ((D / 16 + cluster - 1) / cluster) > CB_RED)
        return ERR_SHAPE;
    const uintptr_t bases = reinterpret_cast<uintptr_t>(wq)      // 16-byte
        | reinterpret_cast<uintptr_t>(wo) | reinterpret_cast<uintptr_t>(kq)
        | reinterpret_cast<uintptr_t>(vq);                       // copies
    if (bases % 16 != 0) return ERR_SHAPE;
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

extern "C" int wa_ffn_block(
        const void* x, int x_dtype, int D, int Hd, const void* ln_w,
        const void* ln_b, const void* w1, const void* s1, const void* b1,
        const void* w2, const void* s2, const void* b2, void* x_out, void* g,
        void* stream) {
    if (D % MV_COLS != 0 || Hd % MV_COLS != 0) return ERR_SHAPE;
    auto st = static_cast<cudaStream_t>(stream);
#define WA_FFN(XT)                                                           \
    ffn_block_t<XT>(x, D, Hd, (const float*)ln_w, (const float*)ln_b,        \
                    (const int8_t*)w1, (const float*)s1, (const float*)b1,   \
                    (const int8_t*)w2, (const float*)s2, (const float*)b2,   \
                    x_out, (float*)g, st)
    if (x_dtype == F32) return (int)WA_FFN(float);
    if (x_dtype == BF16) return (int)WA_FFN(__nv_bfloat16);
#undef WA_FFN
    return ERR_DTYPE;
}
