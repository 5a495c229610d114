"""Per-block decode kernels for one token over k-quant weights (Q4_K,
Q5_K, Q6_K): port of ``whisper_apr_tpu/ops/decode_blocks_kq.py``, at
batch 1 (K12-K14).

  self_block_kq : K1 (``ops/decode_blocks.py``) with the QKV and o-proj
                  matvecs over k-quant weights, biases added in f32
  cross_block_kq: K2 likewise for the q and o-proj matvecs
  ffn_block_kq  : LN3 -> fc1 + b1 -> exact GELU -> fc2, + b2 + residual
                  in f32, cast once

``blk`` is ``model.qdecode.kq_block_operands``: LayerNorms [L, 1, D],
stacked weight triples (values, scale, zero or None) per linear
(``qkv``, ``self_o``, ``cross_q``, ``cross_o``, ``fc1``, ``fc2``) and
biases [L, 1, N] (``bqkv``, ``b_self_o``, ...). :func:`weight_fmt` tells
the format from a triple's shapes, as the JAX ``_weight_fmt``: a q4k
plane packs two K values per row, so its rows are 16 per scale row; the
int8 value planes keep one value per row (32 per scale row for Q5_K, 16
for Q6_K, which has no zero).

Each wrapper runs its hand-written CUDA kernel for CUDA tensors, all in
``csrc/decode_blocks.cu`` (K12 and K13 on K1's and K2's head-cluster
kernel, both planned by :func:`cross_kq_plan`; K14 on K3's cluster
kernel, its units a block as :func:`ffn_kq_units` says) and the plain
PyTorch version, in this module, for CPU tensors; nothing else picks
between the two. Numerics
kept from the JAX kernels: LayerNorm in f32; every matvec input (the LN
output, the attention output, the GELU output) rounded to the compute
dtype before its dot and before its group sums; f32 accumulation;
attention as K1/K2's.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .basic import gelu, layer_norm
from .decode_blocks import (CROSS_MAX_CLUSTER, HEAD_DIM, CrossPlan,
                            _check_tensor, _dispatch, cross_attention_plain,
                            cross_plan, self_attention_plain)
from .kquants import kq_mv_f32
from .q4k import KQ_FMT, q4k_mv_f32

# launches of each kernel in this process (reset by the caller)
LAUNCHES = {"self_block_kq": 0, "cross_block_kq": 0, "ffn_block_kq": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def weight_fmt(tri) -> str:
    """"q4k", "q5k" or "q6k" of a stacked triple (decode_blocks_kq.py
    :201): the ratio of weight rows to scale rows is 16 for q4k (with a
    zero), 32 for q5k (with a zero) and 16 for q6k (without)."""
    wq, s, z = tri
    ratio = wq.shape[1] // s.shape[1]
    if z is None:
        return "q6k"
    return "q4k" if ratio == 16 else "q5k"


def kq_mv(h32: torch.Tensor, tri, layer: int, cdt) -> torch.Tensor:
    """h32 [B, K] f32 @ one layer of a stacked k-quant triple -> [B, N]
    f32, h rounded to ``cdt`` first (before the dot and the group
    sums)."""
    wq, s, z = tri
    hc = h32.to(cdt).float()
    if weight_fmt(tri) == "q4k":
        return q4k_mv_f32(hc, wq[layer], s[layer], z[layer])
    return kq_mv_f32(hc, wq[layer], s[layer],
                     None if z is None else z[layer])


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU path, and the reference on the card)
# ---------------------------------------------------------------------------

def self_block_kq_plain(x, blk, kq, ks, vq, vs, pos, layer: int,
                        n_heads: int):
    l, cdt = layer, x.dtype
    x32 = x.float()
    h = layer_norm(x32, blk["ln1_w"][l, 0], blk["ln1_b"][l, 0])
    qkv = kq_mv(h, blk["qkv"], l, cdt) + blk["bqkv"][l]
    out, *rows = self_attention_plain(qkv, kq, ks, vq, vs, pos, l, n_heads)
    y = kq_mv(out, blk["self_o"], l, cdt) + blk["b_self_o"][l]
    return ((y + x32).to(cdt), *rows)


def cross_block_kq_plain(x, blk, kq, ks, vq, vs, enc_len: int, layer: int,
                         n_heads: int):
    l, cdt = layer, x.dtype
    x32 = x.float()
    h = layer_norm(x32, blk["ln2_w"][l, 0], blk["ln2_b"][l, 0])
    q = kq_mv(h, blk["cross_q"], l, cdt) + blk["b_cross_q"][l]
    out = cross_attention_plain(q, kq, ks, vq, vs, enc_len, l, n_heads)
    y = kq_mv(out, blk["cross_o"], l, cdt) + blk["b_cross_o"][l]
    return (y + x32).to(cdt)


def ffn_block_kq_plain(x, blk, layer: int):
    l, cdt = layer, x.dtype
    x32 = x.float()
    h = layer_norm(x32, blk["ln3_w"][l, 0], blk["ln3_b"][l, 0])
    g = gelu(kq_mv(h, blk["fc1"], l, cdt) + blk["b_fc1"][l])
    y = kq_mv(g, blk["fc2"], l, cdt) + blk["b_fc2"][l]
    return (y + x32).to(cdt)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/decode_blocks.cu: K12, K13, K14)
# ---------------------------------------------------------------------------

_X_DTYPES = (torch.float32, torch.bfloat16)
_LINEARS = {"qkv": ("bqkv", 1, 3), "self_o": ("b_self_o", 1, 1),
            "cross_q": ("b_cross_q", 1, 1), "cross_o": ("b_cross_o", 1, 1),
            "fc1": ("b_fc1", 1, 4), "fc2": ("b_fc2", 4, 1)}


def check_blk_kq(blk: dict) -> str:
    """Raise unless ``blk`` has the layout the kernels read: LayerNorms
    [L, 1, D] f32; per linear [L, K, N] (D in, N out; q4k [L, K/2, N]) int8
    values with f32 [L, K/sub, N] scales (and zeros: not Q6_K), one format
    for all, and an f32 [L, 1, N] bias; all contiguous on one device.
    ``kq_block_operands`` runs it once; the wrappers trust a ``blk`` from
    there. Returns the format."""
    fmt = weight_fmt(blk["qkv"])
    L, _, D = blk["ln1_w"].shape
    dev = blk["ln1_w"].device
    f32 = torch.float32
    for k in ("ln1_w", "ln1_b", "ln2_w", "ln2_b", "ln3_w", "ln3_b"):
        _check_tensor(f"blk[{k!r}]", blk[k], dev, f32, (L, 1, D))
    sub = 16 if fmt == "q6k" else 32
    for name, (bias, k_mult, n_mult) in _LINEARS.items():
        wq, s, z = blk[name]
        K, N = k_mult * D, n_mult * D
        if weight_fmt(blk[name]) != fmt:
            raise TypeError(f"blk[{name!r}] is {weight_fmt(blk[name])}, "
                            f"the others {fmt}")
        rows = K // 2 if fmt == "q4k" else K
        _check_tensor(f"blk[{name!r}] values", wq, dev, torch.int8,
                      (L, rows, N))
        _check_tensor(f"blk[{name!r}] scale", s, dev, f32, (L, K // sub, N))
        if z is not None:
            _check_tensor(f"blk[{name!r}] zero", z, dev, f32,
                          (L, K // sub, N))
        _check_tensor(f"blk[{bias!r}]", blk[bias], dev, f32, (L, 1, N))
    return fmt


def _check_call(x: torch.Tensor, blk: dict, layer: int,
                kq: Optional[torch.Tensor] = None) -> None:
    """Per-call checks: x [1, D] f32/bf16 beside a checked ``blk``, the
    layer, and a checked cache of the same L and D at one slot."""
    L, _, D = blk["ln1_w"].shape
    if x.dtype not in _X_DTYPES:
        raise TypeError(f"activations must be f32 or bf16, got {x.dtype}")
    if tuple(x.shape) != (1, D) or x.device != blk["ln1_w"].device \
            or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [1, {D}] tensor on "
                         f"{blk['ln1_w'].device}, got {tuple(x.shape)} on "
                         f"{x.device}")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside the {L}-layer stacks")
    if kq is not None and (kq.device != x.device or kq.shape[0] != L
                           or kq.shape[1] != 1 or kq.shape[3] != D):
        raise ValueError(f"cache {tuple(kq.shape)} on {kq.device} does not "
                         f"match [{L}, 1, T, {D}] on {x.device}")


def _w(tri, l: int):
    """Pointers of one layer of a weight triple (zero NULL for Q6_K)."""
    wq, s, z = tri
    P = _build.ptr
    return (P(wq, l * wq.shape[1] * wq.shape[2]),
            P(s, l * s.shape[1] * s.shape[2]),
            P(z, l * s.shape[1] * s.shape[2]))


# K12's and K13's launch: K1's and K2's (``decode_blocks.cross_plan``), the
# cluster capped at the groups of Wq's rows so that every block's share is
# whole groups and none is empty. ``head_smem`` mirrors the kernel's
# shared-memory layout (csrc head_layout), ``kq_shares`` its cut of Wq's
# rows.
KQ_SUB = {"q4k": 32, "q5k": 32, "q6k": 16}       # K values a group
KQ_VPB = {"q4k": 2, "q5k": 1, "q6k": 1}          # K values a byte row
KQ_PLANES = {"q4k": 2, "q5k": 2, "q6k": 1}       # scale (and zero)
_HEAD_RED = 1024                                 # csrc CB_RED


def cross_kq_plan(n_heads: int, D: int, n_loop: int, cache_size: int,
                  fmt: str) -> CrossPlan:
    """K13's launch for ``n_loop`` cross rows of ``cache_size`` bytes an
    element over ``fmt`` weights: K2's plan with at most D / sub blocks a
    head. K12 takes it too, with its ``pos`` history rows as ``n_loop``:
    a block's share of each of a head's three 64-column QKV pieces is the
    same whole groups as its share of Wq."""
    return cross_plan(n_heads, D, n_loop, cache_size,
                      min(CROSS_MAX_CLUSTER, D // KQ_SUB[fmt]))


def kq_shares(D: int, cluster: int, fmt: str) -> list:
    """The K rows [k0, k1) of Wq that each block of a head's cluster sums
    (csrc head_block_kernel): whole groups of the format, in rank order."""
    sub = KQ_SUB[fmt]
    G = D // sub
    return [(sub * (r * G // cluster), sub * ((r + 1) * G // cluster))
            for r in range(cluster)]


def head_smem(D: int, cluster: int, chunk: int, cache_size: int,
              fmt: str, W: int = HEAD_DIM) -> int:
    """Bytes of shared memory of a K13 (``W`` = 64 projected columns a
    head) or K12 block (``W`` = 192: q, k and v) (csrc head_layout): x in
    f32, the share of Wq's byte rows and its groups' f32 planes, the
    head's rows of Wo's columns and theirs, a chunk of K/V rows and their
    scales, scores and weights, reduction scratch, the exchanged shares and
    partials, q and the attention row, K12's current row (the head's
    projection, its k and v rows as the cache holds them, the warps'
    maxima and its score), the flag and the barriers."""
    C = cluster
    sub, vpb, planes = KQ_SUB[fmt], KQ_VPB[fmt], KQ_PLANES[fmt]
    groups = -(-(D // sub) // C)
    wo_cols = 16 * (-(-(D // 16) // C))
    return (4 * D + groups * sub // vpb * W + planes * groups * W * 4
            + HEAD_DIM // vpb * wo_cols
            + planes * (HEAD_DIM // sub) * wo_cols * 4
            + 2 * chunk * HEAD_DIM * cache_size + 4 * chunk * 4
            + max(_HEAD_RED, 8 * W) * 4 + C * W * 4 + C * (HEAD_DIM + 4) * 4
            + 2 * HEAD_DIM * 4
            + ((W + 2 * HEAD_DIM + 20) * 4 if W > HEAD_DIM else 0) + 32)


def _self_block_kq_cuda(x, blk, kq, ks, vq, vs, pos: int, l: int,
                        n_heads: int):
    _check_call(x, blk, l, kq)
    D, T = x.shape[1], kq.shape[2]
    dev, st = x.device, _build.stream()
    x_out = torch.empty_like(x)
    k_row = torch.empty((1, D), dtype=kq.dtype, device=dev)
    v_row = torch.empty((1, D), dtype=kq.dtype, device=dev)
    k_scale = torch.empty(1, dtype=torch.float32, device=dev)
    v_scale = torch.empty(1, dtype=torch.float32, device=dev)
    fmt = weight_fmt(blk["qkv"])
    plan = cross_kq_plan(n_heads, D, int(pos), kq.element_size(), fmt)
    W = _build.workspace
    P = _build.ptr
    rc = _build.library().wa_self_block_kq(
        P(x), _build.DTYPE_CODES[x.dtype], D, n_heads, KQ_FMT[fmt],
        P(blk["ln1_w"], l * D), P(blk["ln1_b"], l * D),
        *_w(blk["qkv"], l), P(blk["bqkv"], l * 3 * D),
        P(kq, l * T * D), P(ks, l * T), P(vq, l * T * D), P(vs, l * T),
        _build.DTYPE_CODES[kq.dtype], T, int(pos),
        *_w(blk["self_o"], l), P(blk["b_self_o"], l * D),
        P(x_out), P(k_row), P(k_scale), P(v_row), P(v_scale), *plan,
        W(st, dev, "self_y", max(1, n_heads) * D),
        W(st, dev, "self_tickets", CROSS_MAX_CLUSTER, torch.int32,
          zero=True),
        # int8 rows: the projection between the kernel's two launches
        W(st, dev, "self_qkv", 3 * D) if ks is not None else None, st)
    _build.check(rc, "self_block_kq")
    LAUNCHES["self_block_kq"] += 1
    return x_out, k_row, k_scale, v_row, v_scale


def _cross_block_kq_cuda(x, blk, kq, ks, vq, vs, enc_len: int, l: int,
                         n_heads: int):
    _check_call(x, blk, l, kq)
    D, T = x.shape[1], kq.shape[2]
    dev, st = x.device, _build.stream()
    x_out = torch.empty_like(x)
    fmt = weight_fmt(blk["cross_q"])
    plan = cross_kq_plan(n_heads, D, int(enc_len) if enc_len > 0 else T,
                         kq.element_size(), fmt)
    W = _build.workspace
    P = _build.ptr
    rc = _build.library().wa_cross_block_kq(
        P(x), _build.DTYPE_CODES[x.dtype], D, n_heads, KQ_FMT[fmt],
        P(blk["ln2_w"], l * D), P(blk["ln2_b"], l * D),
        *_w(blk["cross_q"], l), P(blk["b_cross_q"], l * D),
        P(kq, l * T * D), P(ks, l * T), P(vq, l * T * D), P(vs, l * T),
        _build.DTYPE_CODES[kq.dtype], T, int(enc_len),
        *_w(blk["cross_o"], l), P(blk["b_cross_o"], l * D), P(x_out),
        *plan, W(st, dev, "cross_y", max(1, n_heads) * D),
        W(st, dev, "cross_tickets", CROSS_MAX_CLUSTER, torch.int32,
          zero=True), st)
    _build.check(rc, "cross_block_kq")
    LAUNCHES["cross_block_kq"] += 1
    return x_out


# K14's launch (csrc ffn_block_kernel over WKq): K3's grid of clusters of
# FFN_CLUSTER blocks, each block ``ffn_kq_units`` hidden units; ``ffn_kq_smem``
# mirrors its shared-memory layout (csrc ffn_layout).
FFN_CLUSTER = 8                 # csrc FB_CLUSTER
FFN_MIN_BLOCKS = 96             # csrc FB_MIN_BLOCKS
FFN_WARPS = 8                   # csrc FB_WARPS


def ffn_kq_units(H: int, fmt: str) -> int:
    """Hidden units a K14 block owns for a hidden layer of H (csrc
    ffn_units_kq): K3's (32 where that still gives ``FFN_MIN_BLOCKS``
    blocks, else 16), but at least a group, so that a block's rows of fc2
    are whole groups."""
    k3 = 32 if H // 32 >= FFN_MIN_BLOCKS else 16
    return max(k3, KQ_SUB[fmt])


def ffn_kq_smem(D: int, H: int, fmt: str) -> int:
    """Bytes of shared memory of a K14 block (csrc ffn_layout): x in f32,
    W1's slab of U columns (byte rows) and its groups' f32 planes, W2's U
    rows (byte rows) and theirs, the groups' sums of h and g, the warps'
    fc1 sums, g, the cluster's shares of the block's columns, the flag and
    the barrier."""
    U = ffn_kq_units(H, fmt)
    sub, vpb, planes = KQ_SUB[fmt], KQ_VPB[fmt], KQ_PLANES[fmt]
    return (4 * D + D // vpb * U + planes * (D // sub) * U * 4
            + U // vpb * D + planes * (U // sub) * D * 4
            + 16 * -(-(D // sub + U // sub) // 4)
            + FFN_WARPS * U * 4 + U * 4 + 4 * D + 32)


def _ffn_block_kq_cuda(x, blk, l: int):
    _check_call(x, blk, l)
    D, H = x.shape[1], blk["b_fc1"].shape[2]
    dev, st = x.device, _build.stream()
    x_out = torch.empty_like(x)
    lib = _build.library()
    W = _build.workspace
    P = _build.ptr
    # K3's scratch: the kernel cuts the hidden layer over clusters itself
    rc = lib.wa_ffn_block_kq(
        P(x), _build.DTYPE_CODES[x.dtype], D, H,
        KQ_FMT[weight_fmt(blk["fc1"])],
        P(blk["ln3_w"], l * D), P(blk["ln3_b"], l * D),
        *_w(blk["fc1"], l), P(blk["b_fc1"], l * H),
        *_w(blk["fc2"], l), P(blk["b_fc2"], l * D), P(x_out),
        W(st, dev, "ffn_y", max(1, lib.wa_ffn_scratch(D, H))),
        W(st, dev, "ffn_tickets", CROSS_MAX_CLUSTER, torch.int32, zero=True),
        st)
    _build.check(rc, "ffn_block_kq")
    LAUNCHES["ffn_block_kq"] += 1
    return x_out


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def self_block_kq(x: torch.Tensor, blk: dict, kq: torch.Tensor,
                  ks: Optional[torch.Tensor], vq: torch.Tensor,
                  vs: Optional[torch.Tensor], pos: int, layer: int,
                  n_heads: int):
    """K12: ``decode_blocks.self_block`` (K1) over k-quant weights. x
    [1, D]; ``blk`` from ``kq_block_operands``; caches [L, 1, T, D] as
    K1's; rows < pos are the history. Returns (x_out [1, D], k_row
    [1, D], k_scale [1], v_row [1, D], v_scale [1]); the caller writes
    the rows at ``pos``."""
    return _dispatch(x, self_block_kq_plain, _self_block_kq_cuda, blk, kq,
                     ks, vq, vs, int(pos), int(layer), n_heads)


def cross_block_kq(x: torch.Tensor, blk: dict, kq: torch.Tensor,
                   ks: Optional[torch.Tensor], vq: torch.Tensor,
                   vs: Optional[torch.Tensor], enc_len: int, layer: int,
                   n_heads: int) -> torch.Tensor:
    """K13: ``cross_block`` (K2) over k-quant weights; x [1, D] -> [1, D],
    rows < enc_len of the padded cross cache take part."""
    return _dispatch(x, cross_block_kq_plain, _cross_block_kq_cuda, blk, kq,
                     ks, vq, vs, int(enc_len), int(layer), n_heads)


def ffn_block_kq(x: torch.Tensor, blk: dict, layer: int) -> torch.Tensor:
    """K14: x + fc2(gelu(fc1(LN3(x)) + b1)) + b2 over k-quant weights, the
    GELU output rounded to x's dtype before fc2, b2 and the residual
    added in f32. x [1, D] -> [1, D]."""
    return _dispatch(x, ffn_block_kq_plain, _ffn_block_kq_cuda, blk,
                     int(layer))
