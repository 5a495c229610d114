// Shared device helpers of the kernels (decode_blocks.cu,
// int8_matmul.cu, ...): dtype and error codes, element conversions, warp
// reductions and the column granule of the decoder's weights.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace wa {

// dtype codes shared with the Python wrappers (ops/_build.py)
enum DType { F32 = 0, BF16 = 1, I8 = 2, FP8 = 3 };

// argument errors returned by the C entry points (CUDA errors are > 0)
enum ArgError { ERR_DTYPE = -1, ERR_SHAPE = -2 };

constexpr float LN_EPS = 1e-5f;
constexpr int HD = 64;                 // head dim of every Whisper size

// the column granule of the decoder's weights: every output width a
// multiple of it (attention.cuh, kquant.cuh)
constexpr int MV_COLS = 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 v) {
    return static_cast<float>(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
    return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
        float v) {
    return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __nv_fp8_e4m3 from_f32<__nv_fp8_e4m3>(
        float v) {
    return __nv_fp8_e4m3(v);
}

__device__ __forceinline__ float round_bf16(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ int warp_min_int(int v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

}  // namespace wa
