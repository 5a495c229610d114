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
TPU kernel's tiling and are not taken.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .int8_matmul import _check_operands, split_k_partials
from .quant import QTensor

# opt-in switch (see ops/basic.linear)
USE_PALLAS_INT4 = False

# launches of the kernel in this process (reset by the caller)
LAUNCHES = {"int4_matmul": 0}


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


def _int4_cuda(x, wq, scale):
    M, K = x.shape
    N = 2 * wq.shape[1]
    s = _scale_vector(scale, N)
    _check_operands(x, wq, s, N)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    P = _build.ptr
    rc = _build.library().wa_int4_matmul(
        P(x), _build.DTYPE_CODES[x.dtype], M, K, P(wq), N, P(s), s.numel(),
        P(y), split_k_partials(x, M, K, N), _build.stream())
    _build.check(rc, "int4_matmul")
    LAUNCHES["int4_matmul"] += 1
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
