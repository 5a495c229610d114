"""Core compute primitives shared by encoder and decoder, in plain PyTorch.

Port of ``whisper_apr_tpu/ops/basic.py``. LayerNorm statistics and softmax
accumulate in f32 whatever the compute dtype; matmuls run in the dtype of
their inputs (f32 matmuls are full f32 unless the caller enables TF32).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import int4_matmul as i4
from . import int8_matmul as i8
from .quant import dequant, is_quantized
from .tp import is_shard, linear_shard

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
    """y = x @ w (+ b) with w input-major ``[d_in, d_out]``.

    A QTensor is dequantized to x's dtype first, except for a CUDA x with
    an opt-in switch on (JAX ``basic.py:61-76``): ``int8_matmul.
    USE_PALLAS_INT8`` sends a plain int8 QTensor to K17 and ``int4_matmul.
    USE_PALLAS_INT4`` a per-channel int4 one to K18 (the kernel runs or
    the call raises). The JAX ``linear`` routes by ``w.int4`` alone and
    so hands group-scaled, asymmetric and k-quant QTensors to kernels
    that ignore their groups, zeros and packing; here only the QTensors a
    kernel's contract covers (``i8.takes``, ``i4.takes``) reach it, and
    the others dequantize as with the switches off.

    A tp-split weight (``ops/tp.TPShard``) multiplies its local slice: a
    column split stays local, a row split sums its partial product over
    the tp group and adds the bias once (``tp.linear_shard``)."""
    if is_shard(w):
        return linear_shard(x, w, b, linear)
    if is_quantized(w):
        route = kernel_route(w, x.device, i8.USE_PALLAS_INT8,
                             i4.USE_PALLAS_INT4)
        if route == "int8":
            return i8.linear_int8(x, w, b)
        if route == "int4":
            return i4.linear_int4(x, w, b)
        w = dequant(w, x.dtype)
    elif w.dtype != x.dtype:
        w = w.to(x.dtype)
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def kernel_route(w, device: torch.device, int8_on: bool,
                 int4_on: bool) -> Optional[str]:
    """The kernel ``linear`` sends a QTensor to: "int8" (K17) or "int4"
    (K18) for an input on a CUDA device with that switch on and a QTensor
    of the kernel's contract, else None (dequantize)."""
    if device.type != "cuda":
        return None
    if int8_on and i8.takes(w):
        return "int8"
    if int4_on and i4.takes(w):
        return "int4"
    return None


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
