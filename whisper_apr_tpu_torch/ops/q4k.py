# Copied from whisper_apr_tpu/ops/q4k.py (the numpy codec; the planar QTensor made with torch); keep the two in step.
"""Exact Q4_K super-block quantization and the Q4_K matvec K10.

The numpy codec is the JAX package's (``whisper_apr_tpu/ops/q4k.py``), the
GGML ``block_q4_K`` super-block, byte-compatible:

Super-block (256 values, 144 bytes = 4.5 bits/weight):

    [0:2]    d     f16  — scale-of-scales
    [2:4]    dmin  f16  — scale-of-mins
    [4:16]   scales[12] — eight 6-bit sub-scales + eight 6-bit sub-mins
    [16:144] qs[128]    — 4-bit quants, chunked 64 at a time
                          (low nibbles = values c*64..c*64+31,
                           high nibbles = values c*64+32..c*64+63)

Dequantization rule per 32-value sub-block j:  x = d*ls[j]*q - dmin*lm[j]
with q in [0, 15]. The quantizer targets the decode-time effective scales
(f16-rounded d/dmin times the 6-bit integers), so a raw-bytes round trip
reproduces the device values bit-exactly.

Planar form on the device: an input-major ``[K, N]`` weight becomes

    q     int8 [K/2, N]   — even K rows in low nibbles, odd in high (the
                            raw bytes viewed as signed)
    scale f32  [K/32, N]  — effective d*ls per (K-group, output)
    zero  f32  [K/32, N]  — effective dmin*lm

carried on a QTensor with a ``zero`` (``ops/quant.py``).

K10 ``q4k_matvec_stacked``: y [M, N] = x [M, K] @ the planar weight of
one layer of an [L, ...] stack, per 32-group S·Σ(x·q) − Z·Σx, f32
accumulation; the wrapper runs the CUDA kernel (``csrc/kquant_matvec.cu``,
on the tensor cores, K split over a cluster as ``kq_plan`` says; K11's
kernel too) for CUDA tensors and the plain version below for CPU
tensors.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build
from .int8_matmul import SplitPlan
from .quant import QTensor


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


QK_K = 256
BLOCK_BYTES = 144
SUB = 32                     # values per sub-block
NSUB = QK_K // SUB           # 8 sub-blocks per super-block


# ---------------------------------------------------------------------------
# byte-exact codec (numpy, host side)
# ---------------------------------------------------------------------------

def quantize_q4k_raw(x: np.ndarray) -> np.ndarray:
    """[..., K] f32 (K % 256 == 0) -> raw super-blocks [..., K/256, 144]."""
    x = np.asarray(x, np.float32)
    K = x.shape[-1]
    if K % QK_K:
        raise ValueError(f"last dim {K} not a multiple of {QK_K}")
    lead = x.shape[:-1]
    S = K // QK_K
    xb = np.ascontiguousarray(x).reshape(-1, S, NSUB, SUB)
    R = xb.shape[0]

    xmin = np.minimum(xb.min(-1), 0.0)           # [R, S, 8]
    xmax = np.maximum(xb.max(-1), 0.0)
    scale = (xmax - xmin) / 15.0
    mins = -xmin

    d16 = (scale.max(-1) / 63.0).astype(np.float16)     # [R, S]
    dm16 = (mins.max(-1) / 63.0).astype(np.float16)
    df = d16.astype(np.float32)[..., None]
    dmf = dm16.astype(np.float32)[..., None]

    ls = np.where(df > 0, np.round(scale / np.where(df > 0, df, 1.0)), 0.0)
    ls = np.clip(ls, 0, 63).astype(np.uint8)             # [R, S, 8]
    lm = np.where(dmf > 0, np.round(mins / np.where(dmf > 0, dmf, 1.0)), 0.0)
    lm = np.clip(lm, 0, 63).astype(np.uint8)

    sc_eff = df * ls                                     # decode-time scales
    m_eff = dmf * lm
    denom = np.where(sc_eff > 0, sc_eff, 1.0)[..., None]
    q = np.round((xb + m_eff[..., None]) / denom)
    q = np.where(sc_eff[..., None] > 0, q, 0.0)
    q = np.clip(q, 0, 15).astype(np.uint8)               # [R, S, 8, 32]

    scales = np.zeros((R, S, 12), np.uint8)
    scales[..., 0:4] = ls[..., 0:4] | ((ls[..., 4:8] >> 4) << 6)
    scales[..., 4:8] = lm[..., 0:4] | ((lm[..., 4:8] >> 4) << 6)
    scales[..., 8:12] = (ls[..., 4:8] & 0xF) | ((lm[..., 4:8] & 0xF) << 4)

    qc = q.reshape(R, S, 4, 2, SUB)                      # chunks of 64
    qs = (qc[..., 0, :] | (qc[..., 1, :] << 4)).reshape(R, S, 128)

    raw = np.empty((R, S, BLOCK_BYTES), np.uint8)
    raw[..., 0:2] = np.ascontiguousarray(d16[..., None]).view(np.uint8)
    raw[..., 2:4] = np.ascontiguousarray(dm16[..., None]).view(np.uint8)
    raw[..., 4:16] = scales
    raw[..., 16:144] = qs.astype(np.uint8)
    return raw.reshape(lead + (S, BLOCK_BYTES))


def _decode_parts(raw: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """raw [..., S, 144] -> (q [..., S*256] uint8, sc_eff [..., S*8] f32,
    m_eff [..., S*8] f32)."""
    raw = np.asarray(raw, np.uint8)
    lead, S = raw.shape[:-2], raw.shape[-2]
    r = np.ascontiguousarray(raw).reshape(-1, S, BLOCK_BYTES)
    d = r[..., 0:2].copy().view("<f2")[..., 0].astype(np.float32)   # [R, S]
    dmin = r[..., 2:4].copy().view("<f2")[..., 0].astype(np.float32)
    sc = r[..., 4:16]
    ls = np.empty(r.shape[:2] + (NSUB,), np.uint8)
    lm = np.empty_like(ls)
    ls[..., 0:4] = sc[..., 0:4] & 63
    lm[..., 0:4] = sc[..., 4:8] & 63
    ls[..., 4:8] = (sc[..., 8:12] & 0xF) | ((sc[..., 0:4] >> 6) << 4)
    lm[..., 4:8] = (sc[..., 8:12] >> 4) | ((sc[..., 4:8] >> 6) << 4)
    qs = r[..., 16:144].reshape(-1, S, 4, SUB)
    lo = qs & 0xF
    hi = qs >> 4
    q = np.stack([lo, hi], axis=-2).reshape(-1, S, QK_K)
    sc_eff = (d[..., None] * ls).astype(np.float32)
    m_eff = (dmin[..., None] * lm).astype(np.float32)
    return (q.reshape(lead + (S * QK_K,)),
            sc_eff.reshape(lead + (S * NSUB,)),
            m_eff.reshape(lead + (S * NSUB,)))


def dequantize_q4k_raw(raw: np.ndarray) -> np.ndarray:
    """raw super-blocks [..., S, 144] -> f32 values [..., S*256]."""
    q, sc, m = _decode_parts(raw)
    lead = q.shape[:-1]
    K = q.shape[-1]
    qb = q.reshape(lead + (K // SUB, SUB)).astype(np.float32)
    out = qb * sc[..., None] - m[..., None]
    return out.reshape(lead + (K,)).astype(np.float32)


# ---------------------------------------------------------------------------
# planar form
# ---------------------------------------------------------------------------

def _planar_from_parts(q: np.ndarray, sc: np.ndarray,
                       m: np.ndarray) -> QTensor:
    """(q [..., N, K] 0..15, sc/m [..., N, K/32]) -> planar QTensor."""
    qk = np.swapaxes(q, -1, -2)                  # [..., K, N] values 0..15
    scale = np.ascontiguousarray(np.swapaxes(sc, -1, -2))  # [..., K/32, N]
    zero = np.ascontiguousarray(np.swapaxes(m, -1, -2))
    lo = qk[..., 0::2, :]
    hi = qk[..., 1::2, :]
    packed = (lo | (hi << 4)).astype(np.uint8).view(np.int8)  # [..., K/2, N]
    return QTensor(_t(packed), _t(scale),
                   zero=_t(zero), int4=True, group=SUB, kpack=True)


def quantize_q4k(w: np.ndarray, stacked: bool = False) -> QTensor:
    """Input-major weight [..., K, N] -> planar Q4_K QTensor.

    Quantization runs along K per output column — the same rows the raw
    format quantizes — so values match a raw-bytes round trip bit-exactly.
    ``stacked`` is accepted for signature parity (the layout already keeps
    the leading layer axis).
    """
    w = np.asarray(w, np.float32)
    if w.ndim < 2 or w.shape[-2] % QK_K:
        raise ValueError(f"need [..., K, N] with K % {QK_K} == 0, "
                         f"got {w.shape}")
    wt = np.swapaxes(w, -1, -2)                  # [..., N, K]
    raw = quantize_q4k_raw(wt)
    return _planar_from_parts(*_decode_parts(raw))


def planar_from_raw(raw: np.ndarray, d_out: int, d_in: int) -> QTensor:
    """File super-blocks for a [d_out, d_in] weight -> planar QTensor.

    ``raw`` is the .apr tensor payload [(d_out*d_in)/256, 144]; output-row
    n owns the d_in/256 consecutive super-blocks starting at n*d_in/256
    (GGML row-major convention). Bit-exact: no dequantize->requantize.
    """
    raw = np.asarray(raw, np.uint8).reshape(d_out, d_in // QK_K, BLOCK_BYTES)
    q, sc, m = _decode_parts(raw)                # [d_out, d_in], [d_out, g]
    return _planar_from_parts(q, sc, m)




def dequant_q4k(w: QTensor, dtype: torch.dtype = torch.float32
                ) -> torch.Tensor:
    """Planar QTensor -> dense [..., K, N] in ``dtype`` (q4k.py:190):
    q * scale - zero per 32-group, scale and zero cast to ``dtype``."""
    u = w.q.to(torch.int16) & 0xFF
    lo, hi = (u & 0x0F).to(dtype), ((u >> 4) & 0x0F).to(dtype)
    Kh, N = u.shape[-2], u.shape[-1]
    full = torch.stack([lo, hi], dim=-2).reshape(u.shape[:-2] + (2 * Kh, N))
    scale, zero = w.scale.to(dtype), w.zero.to(dtype)
    while scale.ndim > full.ndim:
        scale, zero = scale[0], zero[0]
    fg = full.reshape(full.shape[:-2] + (2 * Kh // SUB, SUB, N))
    out = fg * scale[..., :, None, :] - zero[..., :, None, :]
    return out.reshape(full.shape[:-2] + (2 * Kh, N))


def q4k_bytes(n_elements: int) -> int:
    """Stored bytes for a tensor of ``n_elements`` values."""
    if n_elements % QK_K:
        raise ValueError("not a Q4_K-aligned element count")
    return n_elements // QK_K * BLOCK_BYTES


# ---------------------------------------------------------------------------
# K10: the Q4_K matvec (and the launch shared with K11, ops/kquants.py)
# ---------------------------------------------------------------------------

# weight format codes of the C entry points (csrc/kquant.cuh KqFmt)
KQ_FMT = {"q4k": 0, "q5k": 1, "q6k": 2}

# launches of each kernel in this process (reset by the caller)
LAUNCHES = {"q4k_matvec_stacked": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def q4k_mv_f32(h: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
               zero: torch.Tensor) -> torch.Tensor:
    """h [M, K] f32 @ one layer's planar Q4_K weight (wq [K/2, N], scale
    and zero [K/32, N]) -> [M, N] f32: per group g, S[g]·Σ(h·q) −
    Z[g]·Σh, the even K values against the low nibbles and the odd ones
    against the high nibbles."""
    M, K = h.shape
    G, N = scale.shape
    u = wq.to(torch.int16) & 0xFF
    lo = (u & 0x0F).float().reshape(G, SUB // 2, N)
    hi = (u >> 4).float().reshape(G, SUB // 2, N)
    xe = h[:, 0::2].reshape(M, G, SUB // 2)
    xo = h[:, 1::2].reshape(M, G, SUB // 2)
    p = torch.einsum("mgr,grn->mgn", xe, lo) \
        + torch.einsum("mgr,grn->mgn", xo, hi)
    xsum = h.reshape(M, G, SUB).sum(-1)
    return (p * scale.float()).sum(1) - xsum @ zero.float()


def q4k_matvec_stacked_plain(x: torch.Tensor, wq: torch.Tensor,
                             scale: torch.Tensor, zero: torch.Tensor,
                             layer: int) -> torch.Tensor:
    return q4k_mv_f32(x.float(), wq[layer], scale[layer],
                      zero[layer]).to(x.dtype)


# The launch of K10 and K11 (csrc/kquant_matvec.cu kq_mv_mma_kernel): a
# block owns STRIP output columns and a range of whole groups of K (32
# values; Q6_K's 16), taken by its WARPS warps in turn; the splits of a
# strip form one cluster. A block holds its SM (200+ registers a thread),
# so a launch takes at most BLOCKS blocks, in clusters of a power of 2
# (clusters of 3, 10, 12 or 13 measured a second wave's time on an H100,
# PERF.md). ``kq_smem`` mirrors its shared memory.
STRIP = 128
WARPS = 8
MAX_SPLIT = 16
BLOCKS = 120
SLOT_ROW = 8 * 17      # a warp's slot row: 8 vectors of 16 columns, padded


def kq_plan(K: int, N: int, sub: int = SUB) -> SplitPlan:
    """How K10 and K11 spread K over blocks: each strip of ``STRIP``
    columns takes the most splits, a power of 2 up to ``MAX_SPLIT`` and
    the groups of K, that keep the launch within ``BLOCKS`` blocks (summed
    inside their cluster, in the same launch: no scratch), each whole
    ``sub``-groups (32, or Q6_K's 16), spread evenly, none empty. The scan
    step's D x D projections take 8-16 splits where one block a strip
    would leave most of the card idle. The same plan at every row count:
    above 8 rows the block holds its SM too."""
    G = K // sub
    strips = math.ceil(N / STRIP)
    n = 1
    while 2 * n <= min(MAX_SPLIT, G) and 2 * n * strips <= BLOCKS:
        n *= 2
    per = math.ceil(G / n)
    return SplitPlan(math.ceil(G / per), sub * per)


def kq_smem(M: int, plan: SplitPlan) -> int:
    """Bytes of shared memory of a K10 / K11 block (csrc
    ``kq_smem_floats``): the warps' slots and, with split K, every split's
    share of the block's outputs."""
    total = M * STRIP
    shares = plan.n_split * math.ceil(total / plan.n_split) \
        if plan.n_split > 1 else 0
    return 4 * (WARPS * M * SLOT_ROW + shares)


def kq_matvec_cuda(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                   zero: Optional[torch.Tensor], layer: int, fmt: str,
                   name: str, launches: dict) -> torch.Tensor:
    """Launch ``wa_kq_matvec`` (K10 for "q4k"; K11 for "q5k"/"q6k") with
    ``kq_plan`` once per 32-row chunk of x [M, K]; returns [M, N] in x's
    dtype."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be f32 or bf16, got {x.dtype}")
    if wq.dtype != torch.int8 or scale.dtype != torch.float32 \
            or (zero is not None and zero.dtype != torch.float32):
        raise TypeError("weights must be int8, scale and zero f32")
    L, KW, N = wq.shape
    K = 2 * KW if fmt == "q4k" else KW
    sub = 16 if fmt == "q6k" else 32
    want_zero = fmt != "q6k"
    if tuple(scale.shape) != (L, K // sub, N) \
            or (zero is not None and zero.shape != scale.shape) \
            or (zero is not None) != want_zero:
        raise ValueError(f"{fmt} weight {tuple(wq.shape)}: scale "
                         f"{tuple(scale.shape)}, zero "
                         f"{None if zero is None else tuple(zero.shape)}")
    if not (x.dim() == 2 and x.shape[0] >= 1 and x.shape[1] == K):
        raise ValueError(f"x must be [M, {K}], got {tuple(x.shape)}")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside the {L}-layer stack")
    for n, t in (("x", x), ("wq", wq), ("scale", scale), ("zero", zero)):
        if t is not None and (t.device != x.device
                              or not t.is_contiguous()):
            raise ValueError(f"{n} must be a contiguous tensor on "
                             f"{x.device}")
    M = x.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    P = _build.ptr
    st = _build.stream()
    G = K // sub
    plan = kq_plan(K, N, sub)

    def launch(rows):
        r, m = rows.start, rows.stop - rows.start   # chunk = pointer offsets
        rc = _build.library().wa_kq_matvec(
            P(x, r * K), _build.DTYPE_CODES[x.dtype], m, K, KQ_FMT[fmt],
            P(wq, layer * KW * N), N, P(scale, layer * G * N),
            P(zero, layer * G * N), P(out, r * N), *plan, st)
        _build.check(rc, name)
        launches[name] += 1

    _build.in_row_chunks(M, launch)
    return out


def q4k_matvec_stacked(x: torch.Tensor, wq: torch.Tensor,
                       scale: torch.Tensor, zero: torch.Tensor,
                       layer: int) -> torch.Tensor:
    """K10: x [M, K] (f32 or bf16) @ planar Q4_K weight stack, the layer a
    host int. wq [L, K/2, N] int8 (even K rows in the low nibble);
    scale/zero [L, K/32, N] f32 effective per-group values; N a multiple
    of 32. Returns [M, N] in x's dtype. The group sums Σx are taken in
    f32 from x as given."""
    if x.device.type == "cpu":
        return q4k_matvec_stacked_plain(x, wq, scale, zero, int(layer))
    if x.device.type == "cuda":
        return kq_matvec_cuda(x, wq, scale, zero, int(layer), "q4k",
                              "q4k_matvec_stacked", LAUNCHES)
    raise ValueError(f"no kernel for device {x.device}")
