// Asynchronous staging into shared memory and 16-bit fragment loads, for
// the tiled kernels that pipeline their operands (flash_attention.cu's
// bf16 kernel, probe_mma.cu's f32 contraction).
//
// cp_async16 copies 16 bytes from global to shared memory without passing
// through registers (cp.async.cg: cached in L2 only). Its src-size
// operand zero-fills: 0 copies nothing and writes 16 zero bytes, so a
// tile's rows past the edge are cleared without a branch around the copy
// (the source address must still be a valid one). Copies issued by a
// thread form a group at cp_async_commit; cp_async_wait<N> returns once
// at most N of the thread's groups are still in flight, and a barrier
// after it makes every thread's landed copies visible to all.
#pragma once

#include <stdint.h>

namespace wa {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// four 8 x 8 matrices of 16-bit elements: lanes 8i .. 8i + 7 give the
// addresses of matrix i's rows (16 contiguous bytes each); r[i] is
// matrix i's element pair of this lane (row lane / 4, columns 2 (lane % 4)
// and + 1)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* row) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(row)));
}

// the same, each matrix transposed: r[i] holds rows 2 (lane % 4) and + 1
// of column lane / 4
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(row)));
}

}  // namespace wa
