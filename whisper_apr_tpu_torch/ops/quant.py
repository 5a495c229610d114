"""Weight quantization: port of ``whisper_apr_tpu/ops/quant.py``.

A quantized weight is a :class:`QTensor` holding integer data ``q`` and an
f32 ``scale`` that broadcasts against it (per-tensor, per-channel over the
last axis, or per K-group, with a leading layer axis when stacked), plus
the packing metadata of the JAX class:

- int8 (quant.py:107): scale = absmax/127, q = clip(round(w / scale),
  -127, 127) (reference: quantized.rs:1732 / :1769);
- int4 (``int4``): values in [-7, 7] packed two per byte along the LAST
  axis, low nibble = even index; ``orig_last`` is the unpadded last dim
  (quantized.rs:1824-1960);
- group scales (``group``): one scale per ``group`` consecutive K values
  (the second-to-last axis), [..., K/group, N];
- asymmetric k-quant planes (``zero``): x = q * scale - zero per K-group,
  q stored as int8 views of unsigned values (Q5_K, ``ops/kquants.py``);
- planar Q4_K (``kpack``): nibble pairs packed along K, [..., K/2, N],
  even K rows in the low nibble (``ops/q4k.py``).

The quantizers run in numpy exactly as the JAX package's, so both give the
same bytes for the same weights.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch


@dataclasses.dataclass
class QTensor:
    """Quantized weight: integer ``q``, f32 ``scale`` (and ``zero``), and
    the packing metadata (module docstring)."""

    q: torch.Tensor
    scale: torch.Tensor
    zero: Optional[torch.Tensor] = None
    int4: bool = False
    orig_last: Optional[int] = None
    group: Optional[int] = None
    kpack: bool = False

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return self.q.dtype

    @property
    def size(self) -> int:
        """Elements of ``q`` (the JAX ``QTensor.size``)."""
        return self.q.numel()

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "QTensor":
        """``fn`` applied to q, scale and zero; metadata kept."""
        return dataclasses.replace(
            self, q=fn(self.q), scale=fn(self.scale),
            zero=None if self.zero is None else fn(self.zero))

    def to(self, device) -> "QTensor":
        return self.map(lambda t: t.to(device))

    def __repr__(self) -> str:
        kind = "int4" if self.int4 else "int8"
        if self.group:
            kind = f"{kind}-g{self.group}"
        return f"QTensor({kind}, q={tuple(self.q.shape)})"


def is_quantized(w: Any) -> bool:
    return isinstance(w, QTensor)


def _scale_axes(ndim: int, per_channel: bool, stacked: bool) -> tuple:
    """Axes reduced by absmax: all but the layer axis (0, when stacked)
    and the channel axis (last, when per_channel)."""
    axes = list(range(ndim))
    if stacked and ndim > 1:
        axes.remove(0)
    if per_channel and ndim > 1 and (ndim - 1) in axes:
        axes.remove(ndim - 1)
    return tuple(axes) if axes else (0,)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def quantize_int8(w, per_channel: bool = False,
                  stacked: bool = False) -> QTensor:
    """Symmetric absmax int8 (quant.py:107)."""
    w = np.asarray(w, dtype=np.float32)
    if w.ndim <= 1:
        per_channel = False
        stacked = False
    axes = _scale_axes(w.ndim, per_channel, stacked)
    absmax = np.max(np.abs(w), axis=axes, keepdims=True)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return QTensor(_t(q), _t(scale))


def _pack_pairs_last(q: np.ndarray) -> np.ndarray:
    """int8 values in [-7, 7] -> bytes of two along the last axis (odd
    last dims padded), even index in the low nibble."""
    if q.shape[-1] % 2:
        q = np.pad(q, [(0, 0)] * (q.ndim - 1) + [(0, 1)])
    lo, hi = q[..., 0::2], q[..., 1::2]
    return ((lo & 0x0F) | ((hi & 0x0F) << 4)).astype(np.int8)


def quantize_int4(w, per_channel: bool = False,
                  stacked: bool = False) -> QTensor:
    """Symmetric absmax int4 in [-7, 7], packed pairs along the last axis
    (quant.py:127)."""
    w = np.asarray(w, dtype=np.float32)
    if w.ndim <= 1:
        per_channel = False
        stacked = False
    axes = _scale_axes(w.ndim, per_channel, stacked)
    absmax = np.max(np.abs(w), axis=axes, keepdims=True)
    scale = np.where(absmax > 0, absmax / 7.0, 1.0).astype(np.float32)
    q = np.clip(np.round(w / scale), -7, 7).astype(np.int8)
    return QTensor(_t(_pack_pairs_last(q)), _t(scale), int4=True,
                   orig_last=q.shape[-1])


def quantize_q4_block(w, group: int = 32) -> QTensor:
    """Group-scale int4 (quant.py:152): one absmax scale per ``group`` K
    values, w [..., K, N] -> q packed along the last axis, scale
    [..., K/group, N]. K not a multiple of ``group`` falls back to
    per-channel int4."""
    w = np.asarray(w, dtype=np.float32)
    if w.ndim < 2:
        return quantize_int4(w)
    K, N = w.shape[-2], w.shape[-1]
    if K % group != 0:
        return quantize_int4(w, per_channel=True, stacked=w.ndim > 2)
    lead = w.shape[:-2]
    wg = w.reshape(lead + (K // group, group, N))
    absmax = np.max(np.abs(wg), axis=-2, keepdims=True)
    scale = np.where(absmax > 0, absmax / 7.0, 1.0).astype(np.float32)
    q = np.clip(np.round(wg / scale), -7, 7).astype(np.int8)
    q = q.reshape(lead + (K, N))
    return QTensor(_t(_pack_pairs_last(q)),
                   _t(scale.reshape(lead + (K // group, N))), int4=True,
                   orig_last=N, group=group)


def _unpack_int4(packed: torch.Tensor, orig_last: int) -> torch.Tensor:
    """Packed bytes -> int8 values in [-8, 7] (4-bit two's complement),
    original last dim (quant.py:192)."""
    u = packed.to(torch.int16) & 0xFF
    lo, hi = u & 0x0F, (u >> 4) & 0x0F
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = torch.where(hi > 7, hi - 16, hi)
    out = torch.stack([lo, hi], dim=-1).reshape(
        packed.shape[:-1] + (packed.shape[-1] * 2,))
    return out[..., :orig_last].to(torch.int8)


def _match_rank(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """A layer-sliced weight keeps its scale's leading 1s: drop them."""
    while t.ndim > ndim:
        t = t[0]
    return t


def dequant(w, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain tensor passes through (cast); a QTensor dequantizes in
    ``dtype`` with scale (and zero) cast to ``dtype`` before they multiply,
    as the JAX ``dequant`` (quant.py:209)."""
    if not is_quantized(w):
        return w if w.dtype == dtype else w.to(dtype)
    if w.zero is not None and w.kpack:
        from .q4k import dequant_q4k
        return dequant_q4k(w, dtype)
    if w.zero is not None:
        # asymmetric int8 plane (Q5_K): unsigned values stored as int8
        q = w.q
        g = int(w.group)
        K, N = q.shape[-2], q.shape[-1]
        scale = _match_rank(w.scale.to(dtype), q.ndim)
        zero = _match_rank(w.zero.to(dtype), q.ndim)
        qg = (q.to(torch.int16) & 0xFF).to(dtype).reshape(
            q.shape[:-2] + (K // g, g, N))
        out = qg * scale[..., :, None, :] - zero[..., :, None, :]
        return out.reshape(q.shape[:-2] + (K, N))
    q = w.q
    if w.int4:
        q = _unpack_int4(q, int(w.orig_last))
    scale = _match_rank(w.scale.to(dtype), q.ndim)
    if w.group:
        g = int(w.group)
        K, N = q.shape[-2], q.shape[-1]
        qg = q.reshape(q.shape[:-2] + (K // g, g, N)).to(dtype)
        return (qg * scale[..., :, None, :]).reshape(q.shape[:-2] + (K, N))
    return q.to(dtype) * scale


# ---------------------------------------------------------------------------
# error metrics (quant.py:257-272), in float64 on the host
# ---------------------------------------------------------------------------

def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().double().numpy()
    return np.asarray(a, np.float64)


def quantization_error(original, dequantized) -> float:
    """Mean absolute error."""
    return float(np.mean(np.abs(_f64(original) - _f64(dequantized))))


def compute_sqnr(original, dequantized) -> float:
    """Signal-to-quantization-noise ratio in dB (inf for no noise)."""
    a, b = _f64(original), _f64(dequantized)
    signal = np.mean(a * a)
    noise = np.mean((a - b) ** 2)
    if noise == 0:
        return float("inf")
    return float(10.0 * np.log10(signal / max(noise, 1e-30)))
