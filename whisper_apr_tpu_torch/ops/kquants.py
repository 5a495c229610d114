# Copied from whisper_apr_tpu/ops/kquants.py (the numpy codec; the planar QTensor made with torch); keep the two in step.
"""Exact Q5_K / Q6_K super-block quantization and the k-quant matvec K11.

The numpy codec is the JAX package's (``whisper_apr_tpu/ops/kquants.py``),
the GGML ``block_q5_K`` / ``block_q6_K`` super-blocks, byte-compatible:

Q5_K super-block (256 values, 176 bytes = 5.5 bits/weight):

    [0:2]    d      f16 — scale-of-scales
    [2:4]    dmin   f16 — scale-of-mins
    [4:16]   scales[12] — eight 6-bit sub-scales + eight 6-bit sub-mins
                          (same packing as Q4_K)
    [16:48]  qh[32]     — 5th bits: bit (2c)   of qh[l] = value 64c+l,
                          bit (2c+1) of qh[l] = value 64c+32+l
    [48:176] qs[128]    — low 4 bits, chunked 64 at a time like Q4_K

    x = d*ls[j] * q - dmin*lm[j],  q in [0, 31]  (asymmetric)

Q6_K super-block (256 values, 210 bytes = 6.5625 bits/weight):

    [0:128]   ql[128] — low 4 bits; per 128-chunk, ql[l] low nibble is
                        value l, high nibble value l+64; ql[l+32] low is
                        value l+32, high value l+96 (l in 0..31)
    [128:192] qh[64]  — upper 2 bits; per chunk, qh[l] bits 0-1/2-3/4-5/6-7
                        belong to values l / l+32 / l+64 / l+96
    [192:208] scales[16] int8 — one per 16-value sub-block
    [208:210] d f16

    x = d * sc[v//16] * (q - 32),  q in [0, 63]  (symmetric, signed)

Planar forms on the device: an input-major ``[K, N]`` weight becomes

    Q5_K: q int8 [K, N] in [0, 31], scale/zero f32 [K/32, N]  (group=32)
    Q6_K: q int8 [K, N] in [-32, 31], scale f32 [K/16, N]     (group=16)

K11 ``kq_matvec_stacked``: y [M, N] = x [M, K] @ one layer of such an
[L, ...] stack, per group S·Σ(x·q) (− Z·Σx for Q5_K), f32 accumulation;
the CUDA kernel is K10's tensor-core kernel (``csrc/kquant_matvec.cu``
``kq_mv_mma_kernel``) over the int8 value planes, launched by
``q4k.kq_matvec_cuda`` at ``q4k.kq_plan`` in the format's groups.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .q4k import kq_matvec_cuda
from .quant import QTensor


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


QK_K = 256
SUB5 = 32                    # Q5_K sub-block size
NSUB5 = QK_K // SUB5         # 8
SUB6 = 16                    # Q6_K sub-block size
NSUB6 = QK_K // SUB6         # 16
Q5K_BLOCK_BYTES = 176
Q6K_BLOCK_BYTES = 210


# ---------------------------------------------------------------------------
# shared 6-bit scale/min packing (identical to Q4_K's scales[12])
# ---------------------------------------------------------------------------

def _pack_scales12(ls: np.ndarray, lm: np.ndarray) -> np.ndarray:
    """ls/lm [..., 8] 6-bit -> [..., 12] packed bytes."""
    scales = np.zeros(ls.shape[:-1] + (12,), np.uint8)
    scales[..., 0:4] = ls[..., 0:4] | ((ls[..., 4:8] >> 4) << 6)
    scales[..., 4:8] = lm[..., 0:4] | ((lm[..., 4:8] >> 4) << 6)
    scales[..., 8:12] = (ls[..., 4:8] & 0xF) | ((lm[..., 4:8] & 0xF) << 4)
    return scales


def _unpack_scales12(sc: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[..., 12] packed -> (ls [..., 8], lm [..., 8]) 6-bit values."""
    ls = np.empty(sc.shape[:-1] + (8,), np.uint8)
    lm = np.empty_like(ls)
    ls[..., 0:4] = sc[..., 0:4] & 63
    lm[..., 0:4] = sc[..., 4:8] & 63
    ls[..., 4:8] = (sc[..., 8:12] & 0xF) | ((sc[..., 0:4] >> 6) << 4)
    lm[..., 4:8] = (sc[..., 8:12] >> 4) | ((sc[..., 4:8] >> 6) << 4)
    return ls, lm


# ---------------------------------------------------------------------------
# Q5_K codec
# ---------------------------------------------------------------------------

def quantize_q5k_raw(x: np.ndarray) -> np.ndarray:
    """[..., K] f32 (K % 256 == 0) -> raw super-blocks [..., K/256, 176]."""
    x = np.asarray(x, np.float32)
    K = x.shape[-1]
    if K % QK_K:
        raise ValueError(f"last dim {K} not a multiple of {QK_K}")
    lead = x.shape[:-1]
    S = K // QK_K
    xb = np.ascontiguousarray(x).reshape(-1, S, NSUB5, SUB5)
    R = xb.shape[0]

    xmin = np.minimum(xb.min(-1), 0.0)                   # [R, S, 8]
    xmax = np.maximum(xb.max(-1), 0.0)
    scale = (xmax - xmin) / 31.0
    mins = -xmin

    d16 = (scale.max(-1) / 63.0).astype(np.float16)      # [R, S]
    dm16 = (mins.max(-1) / 63.0).astype(np.float16)
    df = d16.astype(np.float32)[..., None]
    dmf = dm16.astype(np.float32)[..., None]

    ls = np.where(df > 0, np.round(scale / np.where(df > 0, df, 1.0)), 0.0)
    ls = np.clip(ls, 0, 63).astype(np.uint8)
    lm = np.where(dmf > 0, np.round(mins / np.where(dmf > 0, dmf, 1.0)), 0.0)
    lm = np.clip(lm, 0, 63).astype(np.uint8)

    sc_eff = df * ls
    m_eff = dmf * lm
    denom = np.where(sc_eff > 0, sc_eff, 1.0)[..., None]
    q = np.round((xb + m_eff[..., None]) / denom)
    q = np.where(sc_eff[..., None] > 0, q, 0.0)
    q = np.clip(q, 0, 31).astype(np.uint8)               # [R, S, 8, 32]

    qc = q.reshape(R, S, 4, 2, SUB5)                     # chunks of 64
    nib = qc & 0xF
    bit = qc >> 4                                        # the 5th bit
    qs = (nib[..., 0, :] | (nib[..., 1, :] << 4)).reshape(R, S, 128)
    qh = np.zeros((R, S, SUB5), np.uint8)
    for c in range(4):
        qh |= (bit[:, :, c, 0, :] << (2 * c)).astype(np.uint8)
        qh |= (bit[:, :, c, 1, :] << (2 * c + 1)).astype(np.uint8)

    raw = np.empty((R, S, Q5K_BLOCK_BYTES), np.uint8)
    raw[..., 0:2] = np.ascontiguousarray(d16[..., None]).view(np.uint8)
    raw[..., 2:4] = np.ascontiguousarray(dm16[..., None]).view(np.uint8)
    raw[..., 4:16] = _pack_scales12(ls, lm)
    raw[..., 16:48] = qh
    raw[..., 48:176] = qs
    return raw.reshape(lead + (S, Q5K_BLOCK_BYTES))


def _decode_parts_q5k(raw: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """raw [..., S, 176] -> (q [..., S*256] uint8 0..31,
    sc_eff [..., S*8] f32, m_eff [..., S*8] f32)."""
    raw = np.asarray(raw, np.uint8)
    lead, S = raw.shape[:-2], raw.shape[-2]
    r = np.ascontiguousarray(raw).reshape(-1, S, Q5K_BLOCK_BYTES)
    d = r[..., 0:2].copy().view("<f2")[..., 0].astype(np.float32)
    dmin = r[..., 2:4].copy().view("<f2")[..., 0].astype(np.float32)
    ls, lm = _unpack_scales12(r[..., 4:16])
    qh = r[..., 16:48]                                   # [R, S, 32]
    qs = r[..., 48:176].reshape(-1, S, 4, SUB5)
    lo = qs & 0xF
    hi = qs >> 4
    q = np.empty(r.shape[:2] + (4, 2, SUB5), np.uint8)
    for c in range(4):
        q[:, :, c, 0, :] = lo[:, :, c, :] | (((qh >> (2 * c)) & 1) << 4)
        q[:, :, c, 1, :] = hi[:, :, c, :] | (((qh >> (2 * c + 1)) & 1) << 4)
    q = q.reshape(-1, S, QK_K)
    sc_eff = (d[..., None] * ls).astype(np.float32)
    m_eff = (dmin[..., None] * lm).astype(np.float32)
    return (q.reshape(lead + (S * QK_K,)),
            sc_eff.reshape(lead + (S * NSUB5,)),
            m_eff.reshape(lead + (S * NSUB5,)))


def dequantize_q5k_raw(raw: np.ndarray) -> np.ndarray:
    """raw super-blocks [..., S, 176] -> f32 values [..., S*256]."""
    q, sc, m = _decode_parts_q5k(raw)
    lead = q.shape[:-1]
    K = q.shape[-1]
    qb = q.reshape(lead + (K // SUB5, SUB5)).astype(np.float32)
    out = qb * sc[..., None] - m[..., None]
    return out.reshape(lead + (K,)).astype(np.float32)


# ---------------------------------------------------------------------------
# Q6_K codec
# ---------------------------------------------------------------------------

def quantize_q6k_raw(x: np.ndarray) -> np.ndarray:
    """[..., K] f32 (K % 256 == 0) -> raw super-blocks [..., K/256, 210]."""
    x = np.asarray(x, np.float32)
    K = x.shape[-1]
    if K % QK_K:
        raise ValueError(f"last dim {K} not a multiple of {QK_K}")
    lead = x.shape[:-1]
    S = K // QK_K
    xb = np.ascontiguousarray(x).reshape(-1, S, NSUB6, SUB6)
    R = xb.shape[0]

    amax = np.abs(xb).max(-1)                            # [R, S, 16]
    sub_scale = amax / 31.0                              # q stays in [-31,31]
    d16 = (sub_scale.max(-1) / 127.0).astype(np.float16)  # [R, S]
    df = d16.astype(np.float32)[..., None]
    sc = np.where(df > 0, np.round(sub_scale / np.where(df > 0, df, 1.0)), 0.0)
    sc = np.clip(sc, 0, 127).astype(np.int8)             # [R, S, 16]

    eff = df * sc                                        # decode-time scales
    denom = np.where(eff > 0, eff, 1.0)[..., None]
    q = np.round(xb / denom)
    q = np.where(eff[..., None] > 0, q, 0.0)
    q = np.clip(q, -32, 31).astype(np.int32) + 32        # [R,S,16,16] 0..63
    v = q.astype(np.uint8).reshape(R, S, 2, 128)         # two 128-chunks

    L = v & 0xF
    H = v >> 4
    ql = np.empty((R, S, 2, 64), np.uint8)
    ql[..., 0:32] = L[..., 0:32] | (L[..., 64:96] << 4)
    ql[..., 32:64] = L[..., 32:64] | (L[..., 96:128] << 4)
    qh = (H[..., 0:32] | (H[..., 32:64] << 2)
          | (H[..., 64:96] << 4) | (H[..., 96:128] << 6))  # [R, S, 2, 32]

    raw = np.empty((R, S, Q6K_BLOCK_BYTES), np.uint8)
    raw[..., 0:128] = ql.reshape(R, S, 128)
    raw[..., 128:192] = qh.reshape(R, S, 64)
    raw[..., 192:208] = sc.view(np.uint8)
    raw[..., 208:210] = np.ascontiguousarray(d16[..., None]).view(np.uint8)
    return raw.reshape(lead + (S, Q6K_BLOCK_BYTES))


def _decode_parts_q6k(raw: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """raw [..., S, 210] -> (q [..., S*256] int8 in [-32, 31],
    eff [..., S*16] f32 per-sub-block effective scales)."""
    raw = np.asarray(raw, np.uint8)
    lead, S = raw.shape[:-2], raw.shape[-2]
    r = np.ascontiguousarray(raw).reshape(-1, S, Q6K_BLOCK_BYTES)
    ql = r[..., 0:128].reshape(-1, S, 2, 64)
    qh = r[..., 128:192].reshape(-1, S, 2, 32)
    sc = r[..., 192:208].view(np.int8)                   # [R, S, 16]
    d = r[..., 208:210].copy().view("<f2")[..., 0].astype(np.float32)

    v = np.empty(r.shape[:2] + (2, 128), np.int16)
    v[..., 0:32] = (ql[..., 0:32] & 0xF) | ((qh & 3) << 4)
    v[..., 32:64] = (ql[..., 32:64] & 0xF) | (((qh >> 2) & 3) << 4)
    v[..., 64:96] = (ql[..., 0:32] >> 4) | (((qh >> 4) & 3) << 4)
    v[..., 96:128] = (ql[..., 32:64] >> 4) | (((qh >> 6) & 3) << 4)
    q = (v - 32).astype(np.int8).reshape(-1, S, QK_K)
    eff = (d[..., None] * sc.astype(np.float32)).astype(np.float32)
    return (q.reshape(lead + (S * QK_K,)),
            eff.reshape(lead + (S * NSUB6,)))


def dequantize_q6k_raw(raw: np.ndarray) -> np.ndarray:
    """raw super-blocks [..., S, 210] -> f32 values [..., S*256]."""
    q, eff = _decode_parts_q6k(raw)
    lead = q.shape[:-1]
    K = q.shape[-1]
    qb = q.reshape(lead + (K // SUB6, SUB6)).astype(np.float32)
    out = qb * eff[..., None]
    return out.reshape(lead + (K,)).astype(np.float32)


# ---------------------------------------------------------------------------
# planar forms
# ---------------------------------------------------------------------------

def quantize_q5k(w: np.ndarray, stacked: bool = False) -> QTensor:
    """Input-major weight [..., K, N] -> planar Q5_K QTensor.

    Quantization runs along K per output column (matches a raw-bytes
    round trip bit-exactly). ``stacked`` accepted for signature parity.
    """
    w = np.asarray(w, np.float32)
    if w.ndim < 2 or w.shape[-2] % QK_K:
        raise ValueError(f"need [..., K, N] with K % {QK_K} == 0, "
                         f"got {w.shape}")
    wt = np.swapaxes(w, -1, -2)                          # [..., N, K]
    q, sc, m = _decode_parts_q5k(quantize_q5k_raw(wt))
    qk = np.swapaxes(q, -1, -2).astype(np.uint8).view(np.int8)  # [..., K, N]
    scale = np.ascontiguousarray(np.swapaxes(sc, -1, -2))
    zero = np.ascontiguousarray(np.swapaxes(m, -1, -2))
    return QTensor(_t(np.ascontiguousarray(qk)), _t(scale),
                   zero=_t(zero), group=SUB5)


def quantize_q6k(w: np.ndarray, stacked: bool = False) -> QTensor:
    """Input-major weight [..., K, N] -> planar Q6_K QTensor (symmetric,
    group=16, no zero — rides ops/quant.dequant's group branch as-is)."""
    w = np.asarray(w, np.float32)
    if w.ndim < 2 or w.shape[-2] % QK_K:
        raise ValueError(f"need [..., K, N] with K % {QK_K} == 0, "
                         f"got {w.shape}")
    wt = np.swapaxes(w, -1, -2)
    q, eff = _decode_parts_q6k(quantize_q6k_raw(wt))
    qk = np.ascontiguousarray(np.swapaxes(q, -1, -2))    # [..., K, N] int8
    scale = np.ascontiguousarray(np.swapaxes(eff, -1, -2))
    return QTensor(_t(qk), _t(scale), group=SUB6)


def planar_from_raw_q5k(raw: np.ndarray, d_out: int, d_in: int) -> QTensor:
    """File super-blocks for a [d_out, d_in] weight -> planar QTensor.

    ``raw`` is the .apr tensor payload [(d_out*d_in)/256, 176]; output-row
    n owns the d_in/256 consecutive super-blocks starting at n*d_in/256
    (GGML row-major convention). Bit-exact: no dequantize->requantize.
    """
    raw = np.asarray(raw, np.uint8).reshape(d_out, d_in // QK_K,
                                            Q5K_BLOCK_BYTES)
    q, sc, m = _decode_parts_q5k(raw)            # [d_out, d_in], [d_out, G]
    qk = np.ascontiguousarray(np.swapaxes(q, -1, -2)).view(np.int8)
    scale = np.ascontiguousarray(np.swapaxes(sc, -1, -2))
    zero = np.ascontiguousarray(np.swapaxes(m, -1, -2))
    return QTensor(_t(qk), _t(scale),
                   zero=_t(zero), group=SUB5)


def planar_from_raw_q6k(raw: np.ndarray, d_out: int, d_in: int) -> QTensor:
    """File super-blocks for a [d_out, d_in] weight -> planar QTensor."""
    raw = np.asarray(raw, np.uint8).reshape(d_out, d_in // QK_K,
                                            Q6K_BLOCK_BYTES)
    q, eff = _decode_parts_q6k(raw)
    qk = np.ascontiguousarray(np.swapaxes(q, -1, -2))
    scale = np.ascontiguousarray(np.swapaxes(eff, -1, -2))
    return QTensor(_t(qk), _t(scale), group=SUB6)


def q5k_bytes(n_elements: int) -> int:
    if n_elements % QK_K:
        raise ValueError("not a k-quant-aligned element count")
    return n_elements // QK_K * Q5K_BLOCK_BYTES


def q6k_bytes(n_elements: int) -> int:
    if n_elements % QK_K:
        raise ValueError("not a k-quant-aligned element count")
    return n_elements // QK_K * Q6K_BLOCK_BYTES


# ---------------------------------------------------------------------------
# K11: the matvec over the int8 value planes (Q5_K, Q6_K)
# ---------------------------------------------------------------------------

# launches of each kernel in this process (reset by the caller)
LAUNCHES = {"kq_matvec_stacked": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def kq_mv_f32(h: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
              zero: Optional[torch.Tensor]) -> torch.Tensor:
    """h [M, K] f32 @ one layer's int8 value plane (wq [K, N], scale [G,
    N], zero [G, N] or None; group sub = K/G) -> [M, N] f32: per group g,
    S[g]·Σ(h·q) (− Z[g]·Σh)."""
    M, K = h.shape
    G, N = scale.shape
    sub = K // G
    hg = h.reshape(M, G, sub)
    p = torch.einsum("mgr,grn->mgn", hg, wq.float().reshape(G, sub, N))
    y = (p * scale.float()).sum(1)
    if zero is not None:
        y = y - hg.sum(-1) @ zero.float()
    return y


def kq_matvec_stacked_plain(x: torch.Tensor, wq: torch.Tensor,
                            scale: torch.Tensor,
                            zero: Optional[torch.Tensor],
                            layer: int) -> torch.Tensor:
    return kq_mv_f32(x.float(), wq[layer], scale[layer],
                     None if zero is None else zero[layer]).to(x.dtype)


def kq_matvec_stacked(x: torch.Tensor, wq: torch.Tensor,
                      scale: torch.Tensor, zero: Optional[torch.Tensor],
                      layer: int) -> torch.Tensor:
    """K11: x [M, K] (f32 or bf16) @ a planar q5k/q6k weight stack, the
    layer a host int. wq [L, K, N] int8 values (q5k 0..31, q6k
    -32..31); scale [L, G, N] f32 effective per-group scales (G = K/32
    for q5k, K/16 for q6k); zero [L, G, N] f32 (q5k) or None (q6k).
    Returns [M, N] in x's dtype."""
    if x.device.type == "cpu":
        return kq_matvec_stacked_plain(x, wq, scale, zero, int(layer))
    if x.device.type == "cuda":
        fmt = "q6k" if zero is None else "q5k"
        return kq_matvec_cuda(x, wq, scale, zero, int(layer), fmt,
                              "kq_matvec_stacked", LAUNCHES)
    raise ValueError(f"no kernel for device {x.device}")
