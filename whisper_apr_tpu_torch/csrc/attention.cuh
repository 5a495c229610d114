// Decode attention of one query over a single slot's cache rows, used by
// the self block over k-quant weights (K12 in decode_blocks_kq.cu); NEG,
// QSCALE and shape_ok also serve K1, K2, K13, K5 and K6.
//
// One block per (head, split of ATT_ROWS rows) writes a partial (max,
// sum, acc[64]); a combine kernel of HD threads per head merges the
// splits and, for the self blocks, forms the current token's k/v row in
// the cache's form, writes it out and attends to it (the dequantized int8
// row when the cache is int8). Masked scores are -0.7 * f32max (the JAX
// kernels' _NEG) and the softmax sum is clamped to 1e-30.
#pragma once

#include <type_traits>

#include "common.cuh"

// Kernels of a header live in an unnamed namespace: every translation unit
// that includes it registers its own copies.
namespace wa {
namespace {

constexpr float NEG = -0.7f * 3.4028234663852886e38f;
constexpr int ATT_ROWS = 64;           // cache rows per attention split
constexpr int ATT_THREADS = 128;
constexpr int ATT_RPW = ATT_ROWS / (ATT_THREADS / 32);  // rows per warp
constexpr int PART = 2 + HD;           // (m, l, acc[HD]) per split
constexpr float QSCALE = 0.125f;       // HD ** -0.5

// The operands of one attention launch. The kernels also take the
// pointers as kernel parameters and read them from there: the compiler
// knows parameter pointers to be global memory and loads through them
// directly.
struct AttnArgs {
    const float* q;          // pre-projection query row (f32) [D]
    const void* kc;          // cache rows [T, D] of the layer
    const void* vc;
    const float* ks;         // f32 row scales [T] (int8 caches) or null
    const float* vs;
    int T, D, H;
    int n_valid, n_loop;     // rows that count / rows read
    int n_splits;            // splits per head
    float* part;             // [H, n_splits, PART] scratch
    const float* kv_cur;     // current k row [D] (its v row D further);
                             // null: no current row
    void* k_row;             // [D] out, cache dtype
    void* v_row;
    float* k_scale;          // [1] out
    float* v_scale;
    float* attn_out;         // [D] out (f32)
};

__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    a = v.x; b = v.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float& a,
                                      float& b) {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
    a = __bfloat162float(v.x); b = __bfloat162float(v.y);
}
__device__ __forceinline__ void load2(const int8_t* p, float& a, float& b) {
    const char2 v = *reinterpret_cast<const char2*>(p);
    a = (float)v.x; b = (float)v.y;
}
__device__ __forceinline__ void load2(const __nv_fp8_e4m3* p, float& a,
                                      float& b) {
    a = to_f32(p[0]); b = to_f32(p[1]);
}

// Grid (H, n_splits). Rows t < n_loop take part; rows n_valid <= t <
// n_loop score NEG (only when no row is valid, as the JAX kernels' masked
// tiles do); rows past n_loop are excluded. Writes the split's
// (m, l, acc[HD]) with l = sum exp(s - m) and
// acc = sum exp(s - m) * vscale * v.
template <typename CT>
__global__ void __launch_bounds__(ATT_THREADS) attn_part_kernel(
        const AttnArgs a, const float* q, const void* kc_p,
        const void* vc_p, const float* ks, const float* vs, float* part) {
    __shared__ float s_sh[ATT_ROWS];
    __shared__ float acc_sh[ATT_THREADS / HD][HD];
    const int h = blockIdx.x, sp = blockIdx.y;
    const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
    const int n_valid = a.n_valid, n_loop = a.n_loop;
    const int row0 = sp * ATT_ROWS;
    float* o = part + ((size_t)h * a.n_splits + sp) * PART;
    const int D = a.D;
    const CT* kc = static_cast<const CT*>(kc_p);
    const CT* vc = static_cast<const CT*>(vc_p);
    const float q0 = q[h * HD + 2 * lane] * QSCALE;
    const float q1 = q[h * HD + 2 * lane + 1] * QSCALE;

    float dots[ATT_RPW];
#pragma unroll
    for (int i = 0; i < ATT_RPW; ++i) {
        const int t = row0 + wid * ATT_RPW + i;
        float d = 0.f;
        if (t < n_loop) {
            float k0, k1;
            load2(kc + (size_t)t * D + h * HD + 2 * lane, k0, k1);
            d = k0 * q0 + k1 * q1;
        }
        dots[i] = d;
    }
#pragma unroll
    for (int i = 0; i < ATT_RPW; ++i) {
        const float d = warp_sum(dots[i]);
        if (lane == 0) {
            const int t = row0 + wid * ATT_RPW + i;
            float s;
            if (t >= n_loop) s = -INFINITY;
            else if (t >= n_valid) s = NEG;
            else s = ks != nullptr ? d * ks[t] : d;
            s_sh[wid * ATT_RPW + i] = s;
        }
    }
    __syncthreads();
    float m = -INFINITY;
    for (int i = 0; i < ATT_ROWS; ++i) m = fmaxf(m, s_sh[i]);

    const int d = tid % HD, grp = tid / HD;
    constexpr int RPG = ATT_ROWS / (ATT_THREADS / HD);
    float acc = 0.f;
    for (int i = grp * RPG; i < grp * RPG + RPG; ++i) {
        const int t = row0 + i;
        if (t < n_loop) {
            float p = expf(s_sh[i] - m);
            if (vs != nullptr) p *= vs[t];
            acc += p * to_f32(vc[(size_t)t * D + h * HD + d]);
        }
    }
    acc_sh[grp][d] = acc;
    __syncthreads();
    if (tid < HD) {
        float s = 0.f;
#pragma unroll
        for (int g = 0; g < ATT_THREADS / HD; ++g) s += acc_sh[g][tid];
        o[2 + tid] = s;
        if (tid == 0) {
            float l = 0.f;
            for (int i = 0; i < ATT_ROWS; ++i)
                if (row0 + i < n_loop) l += expf(s_sh[i] - m);
            o[0] = m;
            o[1] = l;
        }
    }
}

// Sum over the HD (= 64) threads of a combine block.
__device__ __forceinline__ float head_sum(float v, float* sh2) {
    v = warp_sum(v);
    __syncthreads();
    if ((threadIdx.x & 31) == 0) sh2[threadIdx.x >> 5] = v;
    __syncthreads();
    const float r = sh2[0] + sh2[1];
    __syncthreads();
    return r;
}

__device__ __forceinline__ float head_max(float v, float* sh2) {
    v = warp_max(v);
    __syncthreads();
    if ((threadIdx.x & 31) == 0) sh2[threadIdx.x >> 5] = v;
    __syncthreads();
    const float r = fmaxf(sh2[0], sh2[1]);
    __syncthreads();
    return r;
}

// Grid (H), HD threads: merge the splits; with kv_cur (self blocks) also
// form the current token's k/v row in the cache's form, write it out, and
// attend to it.
template <typename CT>
__global__ void __launch_bounds__(HD) attn_combine_kernel(
        const AttnArgs a, const float* part_p, const float* q,
        const float* kv_cur, void* k_row_p, void* v_row_p,
        float* k_scale_p, float* v_scale_p, float* attn_out_p) {
    __shared__ float sh2[2];
    const int h = blockIdx.x, d = threadIdx.x;
    const int D = a.D;
    const float* part = part_p + (size_t)h * a.n_splits * PART;
    float M = -INFINITY;
    for (int sp = 0; sp < a.n_splits; ++sp) M = fmaxf(M, part[sp * PART]);
    float l = 0.f, acc = 0.f;
    for (int sp = 0; sp < a.n_splits; ++sp) {
        const float* p = part + sp * PART;
        const float w = expf(p[0] - M);
        l += p[1] * w;
        acc += p[2 + d] * w;
    }
    if (kv_cur != nullptr) {
        const float* kf = kv_cur;                               // [D] k
        const float* vf = kf + D;                               // [D] v
        CT* k_row = static_cast<CT*>(k_row_p);
        CT* v_row = static_cast<CT*>(v_row_p);
        const int c = h * HD + d;
        float kcur, vcur, ksc = 1.f, vsc = 1.f;
        if constexpr (std::is_same<CT, int8_t>::value) {
            float ka = 0.f, va = 0.f;
            for (int i = d; i < D; i += HD) {
                ka = fmaxf(ka, fabsf(kf[i]));
                va = fmaxf(va, fabsf(vf[i]));
            }
            ka = head_max(ka, sh2);
            va = head_max(va, sh2);
            ksc = fmaxf(ka, 1e-12f) / 127.f;
            vsc = fmaxf(va, 1e-12f) / 127.f;
            const float kq = fminf(fmaxf(rintf(kf[c] / ksc), -127.f), 127.f);
            const float vq = fminf(fmaxf(rintf(vf[c] / vsc), -127.f), 127.f);
            k_row[c] = (int8_t)kq;
            v_row[c] = (int8_t)vq;
            kcur = kq * ksc;
            vcur = vq * vsc;
        } else {
            const CT kr = from_f32<CT>(kf[c]);
            const CT vr = from_f32<CT>(vf[c]);
            k_row[c] = kr;
            v_row[c] = vr;
            kcur = to_f32(kr);
            vcur = to_f32(vr);
        }
        if (h == 0 && d == 0) {
            *k_scale_p = ksc;
            *v_scale_p = vsc;
        }
        const float sc = head_sum(kcur * (q[c] * QSCALE), sh2);
        const float Mn = fmaxf(M, sc);
        const float alpha = expf(M - Mn);
        const float pc = expf(sc - Mn);
        l = l * alpha + pc;
        acc = acc * alpha + pc * vcur;
    }
    attn_out_p[h * HD + d] = acc / fmaxf(l, 1e-30f);
}

template <typename CT>
cudaError_t launch_attention(const AttnArgs& a, cudaStream_t st) {
    if (a.n_splits > 0) {
        attn_part_kernel<CT><<<dim3(a.H, a.n_splits), ATT_THREADS, 0, st>>>(
            a, a.q, a.kc, a.vc, a.ks, a.vs, a.part);
        cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return e;
    }
    attn_combine_kernel<CT><<<a.H, HD, 0, st>>>(
        a, a.part, a.q, a.kv_cur, a.k_row, a.v_row, a.k_scale, a.v_scale,
        a.attn_out);
    return cudaGetLastError();
}

// int8 caches (I8) carry f32 row scales ks/vs; every other row type is
// read as is.
inline cudaError_t attention(int cache_dtype, const AttnArgs& a,
                             cudaStream_t st) {
    switch (cache_dtype) {
        case F32: return launch_attention<float>(a, st);
        case BF16: return launch_attention<__nv_bfloat16>(a, st);
        case I8: return launch_attention<int8_t>(a, st);
        case FP8: return launch_attention<__nv_fp8_e4m3>(a, st);
        default: return (cudaError_t)ERR_DTYPE;
    }
}

inline int n_att_splits(int rows) { return (rows + ATT_ROWS - 1) / ATT_ROWS; }

inline bool shape_ok(int D, int H) {
    return H > 0 && D == H * HD && D % MV_COLS == 0;
}

}  // namespace
}  // namespace wa
