// Device helpers of the decode kernels that run as thread block clusters
// (decode_blocks.cu: K1-K3; decode_blocks_batched.cu: K5, K6): 4-byte
// asynchronous copies, transaction barriers and st.async stores into the
// cluster's distributed shared memory, the atomic ticket that picks the
// last block of a sum, cache rows read from shared memory as f32, and the
// dispatch on the cache's row type.
#pragma once

#include "common.cuh"
#include "cp_async.cuh"

namespace wa {
namespace {

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

// mbar_wait where the bytes expected come from a launch plan: were they
// ever more than the bytes stored, the wait would spin for good, so after
// about two seconds (2^32 cycles) it traps and the launch reports an error
__device__ __forceinline__ void mbar_wait_bounded(uint64_t* bar) {
    const long long t0 = clock64();
    uint32_t done;
    do {
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(smem_addr(bar)) : "memory");
        if (!done && clock64() - t0 > (1ll << 32)) __trap();
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

// four floats into another block's shared memory at cluster address `to`
// (16-byte aligned); counts 16 bytes against its barrier at `bar`
__device__ __forceinline__ void st_async4(uint32_t to, const float (&v)[4],
                                          uint32_t bar) {
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes"
                 ".v4.b32 [%0], {%1, %2, %3, %4}, [%5];\n"
                 :: "r"(to), "r"(__float_as_uint(v[0])),
                    "r"(__float_as_uint(v[1])), "r"(__float_as_uint(v[2])),
                    "r"(__float_as_uint(v[3])), "r"(bar) : "memory");
}

// four int8 bytes (one 32-bit word) widened exactly at the FMA rate (the
// int-to-float conversion runs at a quarter of it): biased to b + 128 by
// the xor, set as the low byte of the f32 2^23 + (b + 128) by a byte
// permute, the bias taken off by one subtraction
__device__ __forceinline__ void widen4(uint32_t w, float (&v)[4]) {
    w ^= 0x80808080u;
#pragma unroll
    for (int b = 0; b < 4; ++b)
        v[b] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | b))
            - 8388736.f;
}

// After the block's partials are written: true in the block that takes
// the last of n tickets at *ticket, which then sees every block's
// partials (release before the ticket, acquire after the last one)
__device__ __forceinline__ bool last_ticket(int* ticket, int n, int* flag) {
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");    // release
    __syncthreads();
    if (threadIdx.x == 0) {
        const int t = atomicAdd(ticket, 1);
        *flag = t == n - 1;
        if (t == n - 1)
            asm volatile("fence.acq_rel.gpu;\n" ::: "memory");  // acquire
    }
    __syncthreads();
    return *flag;
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
// int8 widened by widen4
__device__ __forceinline__ void row16(const int8_t* p, float (&v)[16]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        float f[4];
        widen4(w[j], f);
#pragma unroll
        for (int b = 0; b < 4; ++b) v[4 * j + b] = f[b];
    }
}
__device__ __forceinline__ void row16(const __nv_fp8_e4m3* p,
                                      float (&v)[16]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_fp8_e4m3* e = reinterpret_cast<const __nv_fp8_e4m3*>(&u);
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = to_f32(e[i]);
}

// 4 consecutive cache elements in shared memory as f32 (int8 widened as
// row16 does)
__device__ __forceinline__ void row4(const float* p, float (&v)[4]) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
__device__ __forceinline__ void row4(const __nv_bfloat16* p,
                                     float (&v)[4]) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(u.x << 16);
    v[1] = __uint_as_float(u.x & 0xffff0000u);
    v[2] = __uint_as_float(u.y << 16);
    v[3] = __uint_as_float(u.y & 0xffff0000u);
}
__device__ __forceinline__ void row4(const int8_t* p, float (&v)[4]) {
    widen4(*reinterpret_cast<const uint32_t*>(p), v);
}
__device__ __forceinline__ void row4(const __nv_fp8_e4m3* p,
                                     float (&v)[4]) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
    const __nv_fp8_e4m3* e = reinterpret_cast<const __nv_fp8_e4m3*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = to_f32(e[i]);
}

// one cache element in shared memory as f32 (int8 widened as row16 does)
template <typename CT>
__device__ __forceinline__ float elem(const CT* p) { return to_f32(*p); }
template <>
__device__ __forceinline__ float elem<int8_t>(const int8_t* p) {
    const uint32_t u = *reinterpret_cast<const uint8_t*>(p) ^ 0x80u;
    return __uint_as_float(0x4B000000u | u) - 8388736.f;
}

// the cache's row type -> f(CT{}); ERR_DTYPE for another code
template <typename F>
int with_cache_type(int cache_dtype, F&& f) {
    switch (cache_dtype) {
        case F32: return f(float{});
        case BF16: return f(__nv_bfloat16{});
        case I8: return f(int8_t{});
        case FP8: return f(__nv_fp8_e4m3{});
        default: return ERR_DTYPE;
    }
}

}  // namespace
}  // namespace wa
