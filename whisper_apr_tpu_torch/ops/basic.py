"""Core compute primitives shared by encoder and decoder, in plain PyTorch.

Port of ``whisper_apr_tpu/ops/basic.py``. LayerNorm statistics and softmax
accumulate in f32 whatever the compute dtype; matmuls run in the dtype of
their inputs (f32 matmuls are full f32 unless the caller enables TF32).
"""

from __future__ import annotations

from typing import Optional

import torch

from .quant import dequant, is_quantized

LN_EPS = 1e-5  # reference: src/model/encoder.rs:219
_F32_MIN = torch.finfo(torch.float32).min


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = LN_EPS) -> torch.Tensor:
    """Pre-norm LayerNorm, f32 statistics, result in x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    normed = (x32 - mean) * torch.rsqrt(var + eps)
    out = normed * weight.float() + bias.float()
    return out.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as HF Whisper."""
    return torch.nn.functional.gelu(x, approximate="none")


def linear(x: torch.Tensor, w, b: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """y = x @ w (+ b) with w input-major ``[d_in, d_out]``; an int8
    QTensor is dequantized to x's dtype first."""
    if is_quantized(w):
        w = dequant(w, x.dtype)
    elif w.dtype != x.dtype:
        w = w.to(x.dtype)
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax in f32, result in x's dtype."""
    return torch.softmax(x.float(), dim=dim).to(x.dtype)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_heads: int,
        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head attention over projected q/k/v.

    q [B, Tq, D], k/v [B, Tk, D] -> [B, Tq, D]; q scaled by head_dim**-0.5;
    masked scores take the f32 minimum, as the JAX ``mha``.
    """
    B, Tq, D = q.shape
    Tk = k.shape[1]
    hd = D // n_heads
    qh = q.reshape(B, Tq, n_heads, hd) * (hd ** -0.5)
    kh = k.reshape(B, Tk, n_heads, hd)
    vh = v.reshape(B, Tk, n_heads, hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", qh, kh)
    if mask is not None:
        # a Python scalar (no host-to-device copy: CUDA-graph capturable);
        # the f32 minimum rounds to -inf in bf16, as the JAX mask's does
        fill = _F32_MIN if scores.dtype in (torch.float32, torch.float64) \
            else float("-inf")
        scores = torch.where(mask, scores, fill)
    weights = softmax(scores, dim=-1).to(vh.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, vh)
    return out.reshape(B, Tq, D)


def causal_mask(t: int, device=None) -> torch.Tensor:
    """Lower-triangular [1, 1, T, T] bool mask."""
    return torch.tril(torch.ones((t, t), dtype=torch.bool,
                                 device=device))[None, None]
