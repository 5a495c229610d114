// Constants of decode attention shared by the head-cluster kernels: K1,
// K2, K12 and K13 (decode_blocks.cu), K5 and K6 (decode_blocks_batched.cu).
// Masked scores are -0.7 * f32max (the JAX kernels' _NEG); a query is
// scaled by HD ** -0.5 before its dots.
#pragma once

#include "common.cuh"

namespace wa {
namespace {

constexpr float NEG = -0.7f * 3.4028234663852886e38f;
constexpr float QSCALE = 0.125f;       // HD ** -0.5

// every head HD (= 64) wide, the width a multiple of 32
inline bool shape_ok(int D, int H) {
    return H > 0 && D == H * HD && D % MV_COLS == 0;
}

}  // namespace
}  // namespace wa
