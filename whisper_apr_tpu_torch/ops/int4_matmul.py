"""Matmul over packed int4 weights (K18): port of
``whisper_apr_tpu/ops/int4_matmul.py``.

``int4_matmul`` computes y = x @ unpack(wq) * scale, f32 sum, cast to x's
dtype: wq [K, N/2] holds two 4-bit values a byte, the low nibble the even
column and the high nibble the odd one, each ``((v & 15) ^ 8) - 8``
(``quant.quantize_int4``'s packing). The output has both columns of every
byte, N = 2 * wq.shape[1]; ``linear_int4`` cuts it to the QTensor's
``orig_last`` and adds the bias. Columns past the scale's length (an odd
width's padded last column) take scale 0.

``USE_PALLAS_INT4`` (off by default, the JAX package's name) routes the
per-channel int4 linears of ``basic.linear`` through this kernel for CUDA
tensors. ``int4_matmul`` runs the hand-written CUDA kernel
(``csrc/dequant_matmul.cu``) for CUDA tensors and the plain PyTorch
version below for CPU tensors. The JAX signature's block sizes are the
TPU kernel's tiling and are not taken. Every row count runs on the
tensor cores, f32 x as three bf16 terms whose sum is x (each product with
the exactly widened weight exact, the sums f32). At most 16 rows the
kernel splits K over the blocks of a thread block cluster and sums the
splits inside it, in the same launch and with no scratch; ``int4_plan``
says how.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .int8_matmul import SplitPlan, _check_operands
from .quant import QTensor

# opt-in switch (see ops/basic.linear)
USE_PALLAS_INT4 = False

# launches of the kernel in this process (reset by the caller): all, and
# those of the tile kernel on f32 x (three bf16 terms), as the C entry
# point reports the kernel it launched
LAUNCHES = {"int4_matmul": 0, "int4_matmul_f32": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _scale_vector(scale: torch.Tensor, N: int) -> torch.Tensor:
    """The scale as f32 [1] (one for every column) or [N - 1] / [N] (one
    per column of an odd or even width)."""
    s = torch.as_tensor(scale).reshape(-1)
    if s.numel() != 1 and not N - 1 <= s.numel() <= N:
        raise ValueError(f"scale of {s.numel()} values for {N} columns: "
                         "want 1 or one per column")
    return s.float().contiguous()


def unpack_plain(wq: torch.Tensor) -> torch.Tensor:
    """Packed [K, N/2] bytes -> f32 values [K, N]."""
    u = wq.to(torch.int32) & 0xFF
    lo = ((u & 15) ^ 8) - 8
    hi = (((u >> 4) & 15) ^ 8) - 8
    return torch.stack([lo, hi], dim=-1).reshape(wq.shape[0], -1).float()


def int4_matmul_plain(x: torch.Tensor, wq: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    N = 2 * wq.shape[1]
    s = _scale_vector(scale, N).to(x.device)
    if 1 < s.numel() < N:
        s = torch.cat([s, s.new_zeros(N - s.numel())])
    return ((x.float() @ unpack_plain(wq)) * s).to(x.dtype)


# the decode-row kernel (csrc/dequant_matmul.cu int4_mv_mma_kernel): a
# block owns STRIP output columns and a range of K rows, in 16-row steps;
# the splits of a strip form one cluster (at most MAX_SPLIT blocks)
DECODE_ROWS = 16       # at most this many rows of x take it
STRIP = 256
STEP = 16
MAX_SPLIT = 16
BLOCKS = 96            # blocks a launch aims at: on an H100 (132 SMs)
                       # split grids past about 100 blocks measured slower
                       # (PERF.md section 6)


def int4_plan(M: int, K: int, N: int) -> SplitPlan:
    """How K18 spreads K over blocks. Above ``DECODE_ROWS`` rows: one
    block per output tile, K whole. Else each strip of ``STRIP`` columns
    takes enough splits for about ``BLOCKS`` blocks, at most
    ``MAX_SPLIT`` (the splits are summed inside their cluster, in the same
    launch: no scratch), in whole 16-row steps spread evenly, none
    empty."""
    if M > DECODE_ROWS:
        return SplitPlan(1, K)
    want = max(1, min(MAX_SPLIT, BLOCKS // math.ceil(N / STRIP)))
    rows = STEP * math.ceil(K / want / STEP)
    return SplitPlan(math.ceil(K / rows), rows)


def _int4_cuda(x, wq, scale):
    M, K = x.shape
    N = 2 * wq.shape[1]
    s = _scale_vector(scale, N)
    _check_operands(x, wq, s, N)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    P = _build.ptr
    tile = ctypes.c_int(0)     # the C entry sets it: 1 for the tile kernel
    rc = _build.library().wa_int4_matmul(
        P(x), _build.DTYPE_CODES[x.dtype], M, K, P(wq), N, P(s), s.numel(),
        P(y), *int4_plan(M, K, N), ctypes.addressof(tile), _build.stream())
    _build.check(rc, "int4_matmul")
    LAUNCHES["int4_matmul"] += 1
    LAUNCHES["int4_matmul_f32"] += x.dtype == torch.float32 and tile.value
    return y


def int4_matmul(x: torch.Tensor, wq: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """K18: x [M, K] (f32 or bf16) @ unpack(wq [K, N/2] int8 bytes) times
    scale (one value, or one per column); f32 sum; [M, N] in x's dtype."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, wq, scale)
    if x.device.type == "cuda":
        return _int4_cuda(x, wq, scale)
    raise ValueError(f"no kernel for device {x.device}")


def takes(w: QTensor) -> bool:
    """Whether a QTensor is one K18 computes: per-channel int4 [K, N/2]
    (one scale per output column). Group-scaled, asymmetric, k-quant and
    per-tensor int4 QTensors are not (``basic.linear`` dequantizes them)."""
    return (w.int4 and w.group is None and w.zero is None and not w.kpack
            and w.q.dim() == 2 and w.orig_last is not None
            and w.scale.numel() == w.orig_last)


def linear_int4(x: torch.Tensor, qt: QTensor,
                b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Linear layer over a packed-int4 QTensor through K18: x [..., K] ->
    [..., orig_last]; the bias is added after the kernel's cast."""
    lead = x.shape[:-1]
    y = int4_matmul(x.reshape(-1, x.shape[-1]).contiguous(), qt.q,
                    qt.scale)[:, : qt.orig_last]
    if b is not None:
        y = y + b.to(y.dtype)
    return y.reshape(lead + (y.shape[-1],))
