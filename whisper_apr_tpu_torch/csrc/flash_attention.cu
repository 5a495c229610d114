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
// bytes: at Whisper's 1500 frames the work, not the bytes, bounds it.
//
// bf16 (flash_mma_kernel): the products run on the tensor cores with
// mma.sync m16n8k16 (bf16 in, f32 sums). A block holds 64 query rows, a
// warp 16 of them with their q fragments in registers; per 64-key tile
// the warp forms its 16 x 64 scores (32 mma), masks, rescales and
// exponentiates them in registers, packs p to bf16 straight into the A
// fragments of p . v (the score fragment's layout is the operand's) and
// adds 16 x 64 outputs (32 mma). K rows and V (transposed, dim-major)
// are staged in shared memory with a 72-element row stride, so each
// fragment load of a warp touches 32 banks. Requires 16-byte aligned
// rows (strides multiples of 8, as every caller's).
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
#include <type_traits>

#include "common.cuh"

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

constexpr int FM_LD = HD + 8;          // smem row stride (elements)

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
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

__global__ void __launch_bounds__(FA_THREADS) flash_mma_kernel(
        const __nv_bfloat16* __restrict__ q, Strides sq,
        const __nv_bfloat16* __restrict__ k, Strides sk,
        const __nv_bfloat16* __restrict__ v, Strides sv,
        __nv_bfloat16* __restrict__ o, Strides so, int H, int Tq, int Tk,
        int kv_valid, float sm_scale, int causal) {
    __shared__ __align__(16) __nv_bfloat16 ks[FA_BK][FM_LD];
    __shared__ __align__(16) __nv_bfloat16 vt[HD][FM_LD];   // [dim][key]
    const int qt = blockIdx.x, h = blockIdx.y % H, b = blockIdx.y / H;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;      // fragment row / column pair
    const int r0 = qt * FA_BQ + warp * 16 + g, r1 = r0 + 8;
    const __nv_bfloat16* qp = q + b * sq.b + h * sq.h;
    const __nv_bfloat16* kp = k + b * sk.b + h * sk.h;
    const __nv_bfloat16* vp = v + b * sv.b + h * sv.h;

    uint32_t qa[HD / 16][4];                    // A fragments of q
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
        const int c = kc * 16 + 2 * t;
        qa[kc][0] = r0 < Tq ? ld_pair(qp + r0 * sq.t + c) : 0u;
        qa[kc][1] = r1 < Tq ? ld_pair(qp + r1 * sq.t + c) : 0u;
        qa[kc][2] = r0 < Tq ? ld_pair(qp + r0 * sq.t + c + 8) : 0u;
        qa[kc][3] = r1 < Tq ? ld_pair(qp + r1 * sq.t + c + 8) : 0u;
    }
    float acc[HD / 8][4];
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
        acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    int n_tiles = (Tk + FA_BK - 1) / FA_BK;
    if (causal) {
        const int last = min(qt * FA_BQ + FA_BQ - 1, Tk - 1);
        n_tiles = min(n_tiles, last / FA_BK + 1);
    }
    for (int kt = 0; kt < n_tiles; ++kt) {
        const int k0 = kt * FA_BK;
        __syncthreads();
        for (int e = tid; e < FA_BK * HD / 8; e += FA_THREADS) {
            const int r = e / (HD / 8), c8 = (e % (HD / 8)) * 8, j = k0 + r;
            uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
            if (j < Tk) {
                kv = *reinterpret_cast<const uint4*>(kp + j * sk.t + c8);
                vv = *reinterpret_cast<const uint4*>(vp + j * sv.t + c8);
            }
            *reinterpret_cast<uint4*>(&ks[r][c8]) = kv;
            const __nv_bfloat16* pv = reinterpret_cast<const __nv_bfloat16*>(
                &vv);
#pragma unroll
            for (int i = 0; i < 8; ++i) vt[c8 + i][r] = pv[i];
        }
        __syncthreads();
        float s[FA_BK / 8][4];
#pragma unroll
        for (int nt = 0; nt < FA_BK / 8; ++nt) {
            s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
            for (int kc = 0; kc < HD / 16; ++kc) {
                const __nv_bfloat16* kr = &ks[nt * 8 + g][kc * 16 + 2 * t];
                mma_bf16(s[nt], qa[kc], ld_pair(kr), ld_pair(kr + 8));
            }
        }
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < FA_BK / 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int j = k0 + nt * 8 + 2 * t + (e & 1);
                const int row = e < 2 ? r0 : r1;
                const bool ok = j < kv_valid && (!causal || j <= row);
                s[nt][e] = ok ? s[nt][e] * sm_scale : FA_MASK;
            }
            mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
            mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
        }
#pragma unroll
        for (int o_ = 1; o_ <= 2; o_ <<= 1) {   // the quad holding a row
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
        }
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int nt = 0; nt < FA_BK / 8; ++nt) {
            s[nt][0] = expf(s[nt][0] - mn0);
            s[nt][1] = expf(s[nt][1] - mn0);
            s[nt][2] = expf(s[nt][2] - mn1);
            s[nt][3] = expf(s[nt][3] - mn1);
            ps0 += s[nt][0] + s[nt][1];
            ps1 += s[nt][2] + s[nt][3];
        }
        l0 = l0 * a0 + ps0;      // this thread's share; the quad sums at
        l1 = l1 * a1 + ps1;      // the end
#pragma unroll
        for (int i = 0; i < HD / 8; ++i) {
            acc[i][0] *= a0;
            acc[i][1] *= a0;
            acc[i][2] *= a1;
            acc[i][3] *= a1;
        }
#pragma unroll
        for (int kc = 0; kc < FA_BK / 16; ++kc) {
            // p in bf16 (as the JAX kernel): the score fragments of key
            // tiles 2kc and 2kc+1 are the A fragment of keys 16kc..16kc+15
            const uint32_t pa[4] = {
                pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
            for (int dn = 0; dn < HD / 8; ++dn) {
                const __nv_bfloat16* vr = &vt[dn * 8 + g][kc * 16 + 2 * t];
                mma_bf16(acc[dn], pa, ld_pair(vr), ld_pair(vr + 8));
            }
        }
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
        l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
    }
    const float i0 = 1.f / (l0 == 0.f ? 1.f : l0);
    const float i1 = 1.f / (l1 == 0.f ? 1.f : l1);
    __nv_bfloat16* op = o + b * so.b + h * so.h;
#pragma unroll
    for (int dn = 0; dn < HD / 8; ++dn) {
        const int c = dn * 8 + 2 * t;
        if (r0 < Tq)
            *reinterpret_cast<uint32_t*>(op + r0 * so.t + c) =
                pack_bf16(acc[dn][0] * i0, acc[dn][1] * i0);
        if (r1 < Tq)
            *reinterpret_cast<uint32_t*>(op + r1 * so.t + c) =
                pack_bf16(acc[dn][2] * i1, acc[dn][3] * i1);
    }
}

__host__ __forceinline__ bool rows_aligned(const void* p, Strides s) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0
        && s.h % 8 == 0 && s.t % 8 == 0;
}

template <typename T>
int launch(const void* q, Strides sq, const void* k, Strides sk,
           const void* v, Strides sv, void* o, Strides so, int B, int H,
           int Tq, int Tk, int kv_valid, float sm_scale, int causal,
           cudaStream_t st) {
    const dim3 grid((Tq + FA_BQ - 1) / FA_BQ, B * H);
    if (std::is_same<T, __nv_bfloat16>::value && rows_aligned(q, sq)
            && rows_aligned(k, sk) && rows_aligned(v, sv)
            && rows_aligned(o, so)) {
        flash_mma_kernel<<<grid, FA_THREADS, 0, st>>>(
            static_cast<const __nv_bfloat16*>(q), sq,
            static_cast<const __nv_bfloat16*>(k), sk,
            static_cast<const __nv_bfloat16*>(v), sv,
            static_cast<__nv_bfloat16*>(o), so, H, Tq, Tk, kv_valid,
            sm_scale, causal);
        return (int)cudaGetLastError();
    }
    flash_kernel<T><<<grid, FA_THREADS, 0, st>>>(
        static_cast<const T*>(q), sq, static_cast<const T*>(k), sk,
        static_cast<const T*>(v), sv, static_cast<T*>(o), so, H, Tq, Tk,
        kv_valid, sm_scale, causal);
    return (int)cudaGetLastError();
}

}  // namespace
}  // namespace wa

// q [B, H, Tq, 64], k/v [B, H, Tk, 64], out [B, H, Tq, 64], each given by
// its pointer and its (batch, head, row) strides in elements, the last
// dim contiguous; one dtype for all (f32 or bf16); 1 <= kv_valid <= Tk.
extern "C" int wa_flash_attention(
        const void* q, long long sqb, long long sqh, long long sqt,
        const void* k, long long skb, long long skh, long long skt,
        const void* v, long long svb, long long svh, long long svt,
        void* out, long long sob, long long soh, long long sot, int dtype,
        int B, int H, int Tq, int Tk, int kv_valid, float sm_scale,
        int causal, void* stream) {
    using namespace wa;
    if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || kv_valid < 1 || kv_valid > Tk
            || (long long)B * H > 65535)
        return ERR_SHAPE;
    auto st = static_cast<cudaStream_t>(stream);
    const Strides a{sqb, sqh, sqt}, b{skb, skh, skt}, c{svb, svh, svt},
        d{sob, soh, sot};
    if (dtype == F32)
        return launch<float>(q, a, k, b, v, c, out, d, B, H, Tq, Tk,
                             kv_valid, sm_scale, causal, st);
    if (dtype == BF16)
        return launch<__nv_bfloat16>(q, a, k, b, v, c, out, d, B, H, Tq, Tk,
                                     kv_valid, sm_scale, causal, st);
    return ERR_DTYPE;
}
