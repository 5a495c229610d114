// K15: decode attention over a paged KV pool.
//
// Replaces the Pallas kernel of whisper_apr_tpu/ops/paged_attention.py
// (_paged_attn_kernel / paged_attention_stacked, pallas_call at :115):
// one query row per slot attends to that slot's history, which lives in
// 16-row pages of a pool shared by every slot and is found through the
// slot's page table. Per head h and slot b:
//
//   s[t] = sum_d k[t, d] * (q[d] * hd^-0.5)     (f32, d in head h)
//   out  = sum_t softmax(s)[t] * v[t]           (f32, cast to q's dtype)
//
// over rows t < n = min(lengths[b], 16 * P), row t in page
// tables[b, t / 16] at offset t % 16 of pool[layer]. As in the JAX kernel,
// a slot with no valid row (lengths[b] <= 0) scores every row of its P
// pages -0.7 * f32max, and the softmax sum is clamped to 1e-30. Page ids
// are clamped into the pool (the JAX gather clamps out-of-range indices).
//
// Bound: the bytes of the K and V rows read (2 * n * D * elem per slot),
// far below the compute rate, so the design only has to read each row
// once at full width: one block per (head, slot), each warp walks every
// WARPS-th row with its 32 lanes on the head's 64 dims (two each, one
// 4- or 8-byte load per lane, a warp reduction per row), an online
// softmax per warp, and the warps' partials merge in shared memory. Rows
// past n are never read, so garbage pages past a slot's length cannot
// reach the softmax.
#include "common.cuh"

namespace wa {
namespace {

constexpr float PA_NEG = -0.7f * 3.4028234663852886e38f;
constexpr int PA_PAGE = 16;
constexpr int PA_WARPS = 8;
constexpr float PA_QSCALE = 0.125f;    // HD ** -0.5

__device__ __forceinline__ void pa_load2(const float* p, float& a, float& b) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    a = v.x; b = v.y;
}
__device__ __forceinline__ void pa_load2(const __nv_bfloat16* p, float& a,
                                         float& b) {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
    a = __bfloat162float(v.x); b = __bfloat162float(v.y);
}

template <typename T>
__global__ void __launch_bounds__(PA_WARPS * 32) paged_attn_kernel(
        const T* __restrict__ q, const T* __restrict__ kp,
        const T* __restrict__ vp, const int* __restrict__ tables,
        const int* __restrict__ lengths, int P, int n_pages, int D,
        T* __restrict__ out) {
    __shared__ float m_sh[PA_WARPS], l_sh[PA_WARPS];
    __shared__ float acc_sh[PA_WARPS][HD];
    const int h = blockIdx.x, b = blockIdx.y;
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const int cap = P * PA_PAGE;
    const int n_valid = min(max(lengths[b], 0), cap);
    const int n_loop = n_valid > 0 ? n_valid : cap;
    const int d0 = h * HD + 2 * lane;
    float q0, q1;
    pa_load2(q + (size_t)b * D + d0, q0, q1);
    q0 *= PA_QSCALE;
    q1 *= PA_QSCALE;
    const int* tb = tables + (size_t)b * P;
    float m = -INFINITY, l = 0.f, a0 = 0.f, a1 = 0.f;
#pragma unroll 4
    for (int t = wid; t < n_loop; t += PA_WARPS) {
        const int page = min(max(tb[t / PA_PAGE], 0), n_pages - 1);
        const size_t row = ((size_t)page * PA_PAGE + t % PA_PAGE) * D + d0;
        float k0, k1, v0, v1;
        pa_load2(kp + row, k0, k1);
        pa_load2(vp + row, v0, v1);
        float s = warp_sum(k0 * q0 + k1 * q1);
        if (t >= n_valid) s = PA_NEG;
        const float m_new = fmaxf(m, s);
        const float alpha = expf(m - m_new);
        const float p = expf(s - m_new);
        l = l * alpha + p;
        a0 = a0 * alpha + p * v0;
        a1 = a1 * alpha + p * v1;
        m = m_new;
    }
    if (lane == 0) {
        m_sh[wid] = m;
        l_sh[wid] = l;
    }
    acc_sh[wid][2 * lane] = a0;
    acc_sh[wid][2 * lane + 1] = a1;
    __syncthreads();
    if (threadIdx.x < HD) {
        float M = -INFINITY;
#pragma unroll
        for (int w = 0; w < PA_WARPS; ++w) M = fmaxf(M, m_sh[w]);
        float L = 0.f, A = 0.f;
#pragma unroll
        for (int w = 0; w < PA_WARPS; ++w) {
            // a warp without rows holds m = -inf: its weight is 0
            const float e = m_sh[w] == -INFINITY ? 0.f : expf(m_sh[w] - M);
            L += l_sh[w] * e;
            A += acc_sh[w][threadIdx.x] * e;
        }
        out[(size_t)b * D + h * HD + threadIdx.x] =
            from_f32<T>(A / fmaxf(L, 1e-30f));
    }
}

template <typename T>
int launch(const void* q, int B, int D, int H, const void* kp,
           const void* vp, int n_pages, const int* tables, int P,
           const int* lengths, void* out, cudaStream_t st) {
    paged_attn_kernel<T><<<dim3(H, B), PA_WARPS * 32, 0, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(kp),
        static_cast<const T*>(vp), tables, lengths, P, n_pages, D,
        static_cast<T*>(out));
    return (int)cudaGetLastError();
}

}  // namespace
}  // namespace wa

// q [B, D] and out [B, D] in the pool's dtype (f32 or bf16); k_pool and
// v_pool point at the layer's [n_pages, 16, D] block; tables [B, P] and
// lengths [B] int32 on the device. D = H * 64.
extern "C" int wa_paged_attention(const void* q, int dtype, int B, int D,
                                  int H, const void* k_pool,
                                  const void* v_pool, int n_pages,
                                  const int* tables, int P,
                                  const int* lengths, void* out,
                                  void* stream) {
    using namespace wa;
    if (D != H * HD || B < 1 || P < 1 || n_pages < 1) return ERR_SHAPE;
    auto st = static_cast<cudaStream_t>(stream);
    if (dtype == F32)
        return launch<float>(q, B, D, H, k_pool, v_pool, n_pages, tables, P,
                             lengths, out, st);
    if (dtype == BF16)
        return launch<__nv_bfloat16>(q, B, D, H, k_pool, v_pool, n_pages,
                                     tables, P, lengths, out, st);
    return ERR_DTYPE;
}
