"""Per-block decode kernels for one token: port of
``whisper_apr_tpu/ops/decode_blocks.py``, at batch 1 (K1-K3) and at B
slots (K5-K7, the ``*_batched`` kernels).

  self_block : x -> LN1 -> fused QKV int8 matvec -> the new k/v row in
               the cache's form -> attention over the self cache rows
               < pos plus the current row -> o-proj -> +bias -> +residual
  cross_block: x -> LN2 -> q matvec -> attention over the cross rows
               < enc_len -> o-proj -> +bias -> +residual
  ffn_block  : x -> LN3 -> fc1 -> exact GELU -> fc2 -> *scale +bias
               -> +residual

At B slots, x is [B, D], slot b attends over its own rows (self: rows
< pos[b], pos a device int32 [B]; cross: rows < enc_len, one length for
all slots), and each weight is read once for all B rows.

Each wrapper runs its hand-written CUDA kernel (``csrc/decode_blocks.cu``,
``csrc/decode_blocks_batched.cu``; K7 ``csrc/ffn_batched.cu``, the
tensor-core kernel it shares with K9, launched as ``ffn_plan`` says) for
CUDA tensors and the plain PyTorch version, in this module, for CPU
tensors — nothing else picks between the two. One plain version per
sub-block serves both kernels: it takes any B.
A batched launch takes at most ``_build.MAX_ROWS`` slots; the wrappers
launch once per chunk of slots (``_build.in_row_chunks``), each chunk a
pointer offset into x, the positions, the outputs and the layer's
[B, T, D] cache block.
Operands are the stacked ``blk`` views of ``model.qdecode.prepare_qdecode``
and the [L, B, T, D] cache stacks; the layer is a host integer. Their
layouts are checked once, where they are made (``check_blk``,
``check_cache``); a launch checks only x, the layer, the positions and
the cache's kind.

Numerics kept from the JAX kernels: LayerNorm in f32; the LN output, the
attention output and the GELU output are rounded to the compute dtype
before their int8 dots (f32 accumulation); the current token attends to
its row exactly as the cache will hold it (the dequantized int8 row when
the cache is int8); masked scores are -0.7 * f32max and the softmax sum
is clamped to 1e-30; int8 rows use f32 row scales that fold into the
scores and the probabilities.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build
from .basic import gelu, layer_norm
from .decode_attention import quantize_row

NEG = -0.7 * torch.finfo(torch.float32).max
HEAD_DIM = 64          # every Whisper size; the kernels require it

# launches of each kernel in this process (reset by the caller)
LAUNCHES = {"self_block": 0, "cross_block": 0, "ffn_block": 0,
            "self_block_batched": 0, "cross_block_batched": 0,
            "ffn_block_batched": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU path, and the reference on the card)
# ---------------------------------------------------------------------------

def _rows_f32(q: torch.Tensor, s: Optional[torch.Tensor]) -> torch.Tensor:
    """One layer's cache rows [B, T, D] as f32 (int8 rows times their
    scale)."""
    r = q.float()
    return r * s.float() if s is not None else r


def _attend(qs: torch.Tensor, K: torch.Tensor, V: torch.Tensor,
            valid: torch.Tensor, n_heads: int,
            cur: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
            ) -> torch.Tensor:
    """Softmax attention of pre-scaled queries qs [B, D], each over its
    own rows K/V [B, T, D] (f32) masked by ``valid`` [B, T], plus an
    optional current row per slot (kc, vc) [B, D] that is always valid.
    Returns [B, D] f32."""
    B, T, D = K.shape
    hd = D // n_heads
    qh = qs.reshape(B, 1, n_heads, hd)
    s = (K.reshape(B, T, n_heads, hd) * qh).sum(-1)           # [B, T, H]
    s = torch.where(valid[:, :, None], s, torch.full_like(s, NEG))
    if cur is not None:
        kc, vc = cur
        s = torch.cat([s, (kc.reshape(B, 1, n_heads, hd) * qh).sum(-1)], 1)
        V = torch.cat([V, vc[:, None]], 1)
    m = s.amax(1, keepdim=True)
    p = torch.exp(s - m)                                      # [B, T', H]
    l = p.sum(1)                                              # [B, H]
    o = torch.einsum("bth,bthd->bhd", p, V.reshape(B, -1, n_heads, hd))
    return (o / torch.clamp_min(l, 1e-30)[..., None]).reshape(B, D)


def _out_proj(out: torch.Tensor, x32: torch.Tensor, wo, wos, wob,
              cdt: torch.dtype) -> torch.Tensor:
    y = out.to(cdt).float() @ wo.float()
    return ((y * wos + wob) + x32).to(cdt)


def _lengths(n, B: int, device) -> torch.Tensor:
    """A row count per slot: an int broadcast (filled on the device, no
    host copy), or a [B] tensor as is."""
    if isinstance(n, torch.Tensor):
        return n.reshape(-1).expand(B)
    return torch.full((B,), int(n), device=device)


def cast_row(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """New k or v rows [B, D] in a float cache's dtype (int8 rows go
    through ``quantize_row``)."""
    return t.to(dtype)


def self_attention_plain(qkv: torch.Tensor, kq, ks, vq, vs, pos,
                         layer: int, n_heads: int):
    """The attention part of K1, K5 and K12: from the projected qkv
    [B, 3D] (f32, bias added), the new k/v rows in the cache's form and
    the attention of each slot over its rows < pos[b] plus that row.
    Returns (out [B, D] f32, k_row, k_scale, v_row, v_scale)."""
    l, device = layer, qkv.device
    B, D = qkv.shape[0], qkv.shape[1] // 3
    q, k, v = qkv[:, :D], qkv[:, D:2 * D], qkv[:, 2 * D:]
    if ks is not None:
        k_row, k_scale = quantize_row(k)
        v_row, v_scale = quantize_row(v)
        kc = k_row.float() * k_scale[:, None]
        vc = v_row.float() * v_scale[:, None]
    else:
        k_row, v_row = cast_row(k, kq.dtype), cast_row(v, vq.dtype)
        kc, vc = k_row.float(), v_row.float()
        k_scale = torch.ones(B, dtype=torch.float32, device=device)
        v_scale = k_scale
    T = kq.shape[2]
    valid = torch.arange(T, device=device)[None, :] \
        < _lengths(pos, B, device)[:, None]
    K = _rows_f32(kq[l], None if ks is None else ks[l])
    V = _rows_f32(vq[l], None if vs is None else vs[l])
    out = _attend(q * (D // n_heads) ** -0.5, K, V, valid, n_heads, (kc, vc))
    return out, k_row, k_scale, v_row, v_scale


def self_block_plain(x, blk, kq, ks, vq, vs, pos, layer: int,
                     n_heads: int):
    """K1 and K5: ``pos`` is an int or a [B] tensor (rows < pos[b] are
    slot b's history)."""
    l, cdt = layer, x.dtype
    x32 = x.float()
    h = layer_norm(x32, blk["ln1_w"][l, 0], blk["ln1_b"][l, 0]).to(cdt)
    qkv = (h.float() @ blk["wqkv"][l].float()) * blk["sqkv"][l] \
        + blk["bqkv"][l]
    out, *rows = self_attention_plain(qkv, kq, ks, vq, vs, pos, l, n_heads)
    x_out = _out_proj(out, x32, blk["self_wo"][l], blk["self_wos"][l],
                      blk["self_wob"][l], cdt)
    return (x_out, *rows)


def cross_attention_plain(q: torch.Tensor, kq, ks, vq, vs, enc_len: int,
                          layer: int, n_heads: int) -> torch.Tensor:
    """The attention part of K2, K6 and K13: the projected q [B, D] (f32,
    bias added) of each slot over its cross rows < enc_len -> [B, D]
    f32."""
    l = layer
    B, D = q.shape
    T = kq.shape[2]
    valid = (torch.arange(T, device=q.device) < enc_len).expand(B, T)
    K = _rows_f32(kq[l], None if ks is None else ks[l])
    V = _rows_f32(vq[l], None if vs is None else vs[l])
    return _attend(q * (D // n_heads) ** -0.5, K, V, valid, n_heads)


def cross_block_plain(x, blk, kq, ks, vq, vs, enc_len: int, layer: int,
                      n_heads: int):
    """K2 and K6: rows < enc_len of every slot take part."""
    l, cdt = layer, x.dtype
    x32 = x.float()
    h = layer_norm(x32, blk["ln2_w"][l, 0], blk["ln2_b"][l, 0]).to(cdt)
    q = (h.float() @ blk["wcq"][l].float()) * blk["scq"][l] + blk["bcq"][l]
    out = cross_attention_plain(q, kq, ks, vq, vs, enc_len, l, n_heads)
    return _out_proj(out, x32, blk["cross_wo"][l], blk["cross_wos"][l],
                     blk["cross_wob"][l], cdt)


def ffn_block_plain(x, blk, layer: int):
    """K3 and K7, for x [B, D]."""
    l, cdt = layer, x.dtype
    x32 = x.float()
    h = layer_norm(x32, blk["ln3_w"][l, 0], blk["ln3_b"][l, 0]).to(cdt)
    t1 = (h.float() @ blk["w1"][l].float()) * blk["s1"][l] + blk["b1"][l]
    g = gelu(t1).to(cdt)
    acc = g.float() @ blk["w2"][l].float()
    return (acc * blk["fc2_s"][l] + blk["fc2_b"][l] + x32).to(cdt)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/decode_blocks.cu)
# ---------------------------------------------------------------------------

_X_DTYPES = (torch.float32, torch.bfloat16)

# blk keys of each sub-block: (ln_w, ln_b, w_in, s_in, b_in, w_out, s_out,
# b_out)
_SELF_KEYS = ("ln1_w", "ln1_b", "wqkv", "sqkv", "bqkv", "self_wo",
              "self_wos", "self_wob")
_CROSS_KEYS = ("ln2_w", "ln2_b", "wcq", "scq", "bcq", "cross_wo",
               "cross_wos", "cross_wob")
_FFN_KEYS = ("ln3_w", "ln3_b", "w1", "s1", "b1", "w2", "fc2_s", "fc2_b")


def _check_tensor(name: str, t: torch.Tensor, device, dtype, shape) -> None:
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want "
                         f"{tuple(shape)}")


def check_blk(blk: dict) -> None:
    """Raise unless ``blk`` has the layout the kernels read: per sub-block
    LayerNorm [L, 1, D] f32, an int8 [L, D, N] input linear with f32
    [L, 1, N] scale and bias, and an int8 [L, K, D] output linear with
    f32 [L, 1, D] scale and bias (N = 3D, D, 4D; K = D, D, 4D), all
    contiguous on one device. ``prepare_qdecode`` runs it once; the
    kernel wrappers trust a ``blk`` from there and check only the
    operands that change per call."""
    L, D, _ = blk["wqkv"].shape
    H4 = blk["w1"].shape[2]
    dev = blk["wqkv"].device
    f32, i8 = torch.float32, torch.int8
    for keys, N, K in ((_SELF_KEYS, 3 * D, D), (_CROSS_KEYS, D, D),
                       (_FFN_KEYS, H4, H4)):
        shapes = ((L, 1, D), (L, 1, D), (L, D, N), (L, 1, N), (L, 1, N),
                  (L, K, D), (L, 1, D), (L, 1, D))
        dtypes = (f32, f32, i8, f32, f32, i8, f32, f32)
        for k, dt, shp in zip(keys, dtypes, shapes):
            _check_tensor(f"blk[{k!r}]", blk[k], dev, dt, shp)


def check_cache(kq: torch.Tensor, ks: Optional[torch.Tensor],
                vq: torch.Tensor, vs: Optional[torch.Tensor]) -> None:
    """Raise unless k/v rows [L, B, T, D] are one kernel-readable dtype
    (f32, bf16, fp8 e4m3, or int8 with f32 row scales [L, B, T, 1]),
    contiguous on one device. ``quantize_cache`` runs it once per cache;
    the decode step writes rows in place, so the layout holds."""
    if kq.dtype not in _build.DTYPE_CODES or kq.dim() != 4:
        raise TypeError(f"cache rows must be [L, B, T, D] of one of "
                        f"{list(_build.DTYPE_CODES)}, got {kq.dtype} "
                        f"{tuple(kq.shape)}")
    if (ks is None) != (vs is None) \
            or (ks is not None) != (kq.dtype == torch.int8):
        raise TypeError("int8 caches need f32 row scales; others none")
    _check_tensor("kq", kq, kq.device, kq.dtype, kq.shape)
    _check_tensor("vq", vq, kq.device, kq.dtype, kq.shape)
    if ks is not None:
        for name, s in (("ks", ks), ("vs", vs)):
            _check_tensor(name, s, kq.device, torch.float32,
                          (*kq.shape[:3], 1))


def _check_call(x: torch.Tensor, w: torch.Tensor, layer: int,
                kq: Optional[torch.Tensor] = None,
                batched: bool = False) -> int:
    """Per-call checks before a launch: x [B, D] f32/bf16 beside the
    [L, D, N] input weight ``w`` of a checked ``blk`` (B = 1 for K1-K3,
    any B >= 1 for the batched kernels), the layer, and a
    checked cache of the same L, B, D. Returns B. The C entries check the
    rest (head dim 64, widths, enc_len inside the cache)."""
    L, D = w.shape[0], w.shape[1]
    if x.dtype not in _X_DTYPES:
        raise TypeError(f"activations must be f32 or bf16, got {x.dtype}")
    B = x.shape[0] if x.dim() == 2 else 0
    ok_b = B >= 1 if batched else B == 1
    if not (x.dim() == 2 and ok_b and x.shape[1] == D) \
            or x.device != w.device or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [B, {D}] tensor on "
                         f"{w.device} with B {'>=' if batched else '=='} 1, "
                         f"got {tuple(x.shape)} on {x.device}")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside the {L}-layer stacks")
    if kq is not None and (kq.device != x.device or kq.shape[0] != L
                           or kq.shape[1] != B or kq.shape[3] != D):
        raise ValueError(f"cache {tuple(kq.shape)} on {kq.device} does not "
                         f"match [{L}, {B}, T, {D}] on {x.device}")
    return B


def _self_block_cuda(x, blk, kq, ks, vq, vs, pos: int, l: int,
                     n_heads: int):
    _check_call(x, blk["wqkv"], l, kq)
    D, T = x.shape[1], kq.shape[2]
    dev, st = x.device, _build.stream()
    x_out = torch.empty_like(x)
    k_row = torch.empty((1, D), dtype=kq.dtype, device=dev)
    v_row = torch.empty((1, D), dtype=kq.dtype, device=dev)
    k_scale = torch.empty(1, dtype=torch.float32, device=dev)
    v_scale = torch.empty(1, dtype=torch.float32, device=dev)
    plan = cross_plan(n_heads, D, int(pos), kq.element_size())
    W = _build.workspace
    P = _build.ptr
    rc = _build.library().wa_self_block(
        P(x), _build.DTYPE_CODES[x.dtype], D, n_heads,
        P(blk["ln1_w"], l * D), P(blk["ln1_b"], l * D),
        P(blk["wqkv"], l * D * 3 * D), P(blk["sqkv"], l * 3 * D),
        P(blk["bqkv"], l * 3 * D),
        P(kq, l * T * D), P(ks, l * T), P(vq, l * T * D), P(vs, l * T),
        _build.DTYPE_CODES[kq.dtype], T, int(pos),
        P(blk["self_wo"], l * D * D), P(blk["self_wos"], l * D),
        P(blk["self_wob"], l * D),
        P(x_out), P(k_row), P(k_scale), P(v_row), P(v_scale), *plan,
        W(st, dev, "self_y", max(1, n_heads) * D),
        W(st, dev, "self_tickets", CROSS_MAX_CLUSTER, torch.int32,
          zero=True),
        # int8 rows: the projection between the kernel's two launches
        W(st, dev, "self_qkv", 3 * D) if ks is not None else None, st)
    _build.check(rc, "self_block")
    LAUNCHES["self_block"] += 1
    return x_out, k_row, k_scale, v_row, v_scale


# K1's and K2's launch (csrc head_block_kernel): one thread block cluster
# per head; the plan spreads the head's cache rows over the cluster's
# blocks (the kernel cuts Wq's rows and Wo's columns over them itself)
CROSS_BLOCKS = 160            # blocks aimed for over all heads
CROSS_MAX_CLUSTER = 16        # blocks of one cluster (csrc CB_MAX_CLUSTER)
CROSS_GROUPS = 64             # rows a chunk holds come in multiples of
CROSS_MAX_CHUNK = 256         # this, up to this many (a row a thread)
CROSS_STAGE_BYTES = 48 * 1024  # staged K/V rows (and row scales), a chunk


class CrossPlan(NamedTuple):
    """``cluster`` blocks per head; block r attends over the cache rows
    [r rows, (r + 1) rows) below n_loop, staged ``chunk`` at a time."""
    cluster: int
    rows: int
    chunk: int


def cross_plan(n_heads: int, D: int, n_loop: int, cache_size: int,
               max_cluster: int = CROSS_MAX_CLUSTER) -> CrossPlan:
    """K1's and K2's launch for ``n_loop`` cache rows of ``cache_size``
    bytes an element (K1: the ``pos`` history rows): about
    ``CROSS_BLOCKS`` blocks, ``max_cluster`` at most a head; the
    rows cut evenly over the cluster (the last blocks may hold fewer, or
    none); each block stages its rows in chunks of a multiple of
    ``CROSS_GROUPS`` rows whose K and V (and row scales) fit in
    ``CROSS_STAGE_BYTES``."""
    cluster = max(1, min(max_cluster, CROSS_BLOCKS // max(1, n_heads)))
    rows = max(1, math.ceil(n_loop / cluster))
    per_row = 2 * (HEAD_DIM * cache_size + 4)
    fit = min(CROSS_MAX_CHUNK, CROSS_STAGE_BYTES // per_row
              // CROSS_GROUPS * CROSS_GROUPS)
    return CrossPlan(cluster, rows,
                     min(fit, CROSS_GROUPS * math.ceil(rows / CROSS_GROUPS)))


def _cross_block_cuda(x, blk, kq, ks, vq, vs, enc_len: int, l: int,
                      n_heads: int):
    _check_call(x, blk["wcq"], l, kq)
    D, T = x.shape[1], kq.shape[2]
    dev, st = x.device, _build.stream()
    x_out = torch.empty_like(x)
    plan = cross_plan(n_heads, D, int(enc_len) if enc_len > 0 else T,
                      kq.element_size())
    W = _build.workspace
    P = _build.ptr
    rc = _build.library().wa_cross_block(
        P(x), _build.DTYPE_CODES[x.dtype], D, n_heads,
        P(blk["ln2_w"], l * D), P(blk["ln2_b"], l * D),
        P(blk["wcq"], l * D * D), P(blk["scq"], l * D), P(blk["bcq"], l * D),
        P(kq, l * T * D), P(ks, l * T), P(vq, l * T * D), P(vs, l * T),
        _build.DTYPE_CODES[kq.dtype], T, int(enc_len),
        P(blk["cross_wo"], l * D * D), P(blk["cross_wos"], l * D),
        P(blk["cross_wob"], l * D), P(x_out), *plan,
        W(st, dev, "cross_y", max(1, n_heads) * D),
        W(st, dev, "cross_tickets", CROSS_MAX_CLUSTER, torch.int32,
          zero=True), st)
    _build.check(rc, "cross_block")
    LAUNCHES["cross_block"] += 1
    return x_out


def _ffn_block_cuda(x, blk, l: int):
    _check_call(x, blk["w1"], l)
    D, H = blk["w1"].shape[1], blk["w1"].shape[2]
    dev, st = x.device, _build.stream()
    x_out = torch.empty_like(x)
    lib = _build.library()
    W = _build.workspace
    P = _build.ptr
    # the kernel cuts the hidden layer over clusters of blocks itself and
    # says how much scratch its cluster sums take
    rc = lib.wa_ffn_block(
        P(x), _build.DTYPE_CODES[x.dtype], D, H,
        P(blk["ln3_w"], l * D), P(blk["ln3_b"], l * D),
        P(blk["w1"], l * D * H), P(blk["s1"], l * H), P(blk["b1"], l * H),
        P(blk["w2"], l * H * D), P(blk["fc2_s"], l * D),
        P(blk["fc2_b"], l * D), P(x_out),
        W(st, dev, "ffn_y", max(1, lib.wa_ffn_scratch(D, H))),
        W(st, dev, "ffn_tickets", CROSS_MAX_CLUSTER, torch.int32, zero=True),
        st)
    _build.check(rc, "ffn_block")
    LAUNCHES["ffn_block"] += 1
    return x_out


# K7's and K9's launch (csrc/ffn_batched.cu ffn_mma_kernel): grid (C, G,
# T) with clusters of C blocks; a block owns U hidden units (its slab of
# w1) and D / C output columns (its slab of w2 over the cluster's C U
# units), T = ceil(rows / S) tiles of S slots. ``ffn_smem`` mirrors the
# kernel's shared-memory layout (csrc ff_layout)
FFN_WARPS = 8                  # warps of a block (256 threads) ...
FFN_CONSUMERS = 6              # ... of which these do LN3 and fc1 (the
                               # others issue the weight copies)
FFN_W1_CHUNKS = 4              # w1's slab lands in this many parts
FFN_MAX_CLUSTER = 16           # blocks of a cluster
FFN_MAX_UNIT_BLOCKS = 192      # U = 16 while H / 16 blocks are at most
                               # this many, else 32
FFN_SMS = 132                  # SMs of an H100 SXM
FFN_BLOCKS_PER_SM = 2          # the kernel's launch bounds (<= 128
                               # registers a thread)
FFN_SM_BYTES = 233472          # shared memory of an SM (228 KB) ...
FFN_BLOCK_RESERVED = 1024      # ... of which each block reserves 1 KB
FFN_MAX_SMEM = 227 * 1024      # a block's dynamic shared memory, at most
FFN_TICKETS = _build.MAX_ROWS * FFN_MAX_CLUSTER  # one a (tile, block rank)
FFN_MAX_SPLITS = 4             # unit splits of an fc2 column vector ...
FFN_SPLIT_BYTES = 32768        # ... whose sums take at most this
FFN_XPAD = 8                   # padding of x's staged rows, elements


class FfnPlan(NamedTuple):
    """``units`` hidden units a block, ``cluster`` blocks a cluster,
    ``slots`` slots a tile of the launch's rows."""
    units: int
    cluster: int
    slots: int


def ffn_splits(nv: int, n_us: int, slots: int, cols: int) -> int:
    """fc2's unit splits of a block's ``nv`` 16-column vectors over
    ``n_us`` 16-unit steps: the fewest steps for the busiest of the
    ``FFN_WARPS`` warps (ties: fewer splits), up to ``FFN_MAX_SPLITS``,
    their sums within ``FFN_SPLIT_BYTES`` (csrc ff_splits)."""
    best, cost = 1, None
    for k in range(1, FFN_MAX_SPLITS + 1):
        if k > 1 and k * slots * cols * 4 > FFN_SPLIT_BYTES:
            break
        c = math.ceil(nv * k / FFN_WARPS) * math.ceil(n_us / k)
        if cost is None or c < cost:
            best, cost = k, c
    return best


def ffn_smem(D: int, units: int, cluster: int, slots: int,
             x_size: int) -> int:
    """Shared memory in bytes of one block of K7's and K9's kernel, for x
    of ``x_size`` bytes an element (csrc ff_layout)."""
    U, C, S = units, cluster, slots
    cols = D // C
    ks = ffn_splits(cols // 16, C * U // 16, S, cols)
    region_a = max(D * U, FFN_CONSUMERS * S * (U + 4) * 4,
                   C * S * (U + 8) * x_size)
    region_f = max(16 * (D + FFN_XPAD) + 8 * D,
                   ks * S * cols * 4 + S * U * x_size)
    barriers = 8 * (FFN_W1_CHUNKS + 4)
    return region_a + U * D + region_f + 2 * 32 * 4 + barriers


def ffn_blocks_per_sm(smem: int) -> int:
    """Blocks of the kernel an SM holds at once: its launch bounds, or
    fewer where their shared memory does not fit."""
    return min(FFN_BLOCKS_PER_SM,
               FFN_SM_BYTES // (smem + FFN_BLOCK_RESERVED))


def ffn_plan(D: int, Hd: int, M: int, x_size: int = 2) -> FfnPlan:
    """K7's and K9's launch for M <= 32 rows of width D, a hidden layer
    of Hd and x of ``x_size`` bytes an element. Units: 16 a block where
    that makes at most ``FFN_MAX_UNIT_BLOCKS`` blocks (whisper-tiny 96,
    base 128, small 192), else 32 (medium 128, large-v3 160): one wave at
    two blocks an SM. Cluster: the largest size up to ``FFN_MAX_CLUSTER``
    that divides both D / 16 (whole 16-byte column vectors a block) and
    the Hd / U blocks, whose shared memory still lets two blocks share an
    SM: the fewer clusters, the fewer partial sums the last block of a
    column range adds. Slots: all M rows in one tile, or (were nothing
    to fit, which no Whisper width meets) tiles of half as many."""
    U = 16 if Hd // 16 <= FFN_MAX_UNIT_BLOCKS else 32
    sizes = [c for c in range(FFN_MAX_CLUSTER, 0, -1)
             if (D // 16) % c == 0 and (Hd // U) % c == 0]
    S = max(1, min(M, _build.MAX_ROWS))
    while True:
        for C in sizes:
            smem = ffn_smem(D, U, C, S, x_size)
            if ffn_blocks_per_sm(smem) == FFN_BLOCKS_PER_SM:
                return FfnPlan(U, C, S)
        if S == 1:
            raise ValueError(f"no K7/K9 launch plan for D {D}, H {Hd}")
        S = math.ceil(S / 2)


def ffn_blocks(plan: FfnPlan, D: int, Hd: int, M: int) -> list:
    """What each block of K7's and K9's grid owns: its hidden units
    [u0, u1), its output columns [c0, c1), its slots [s0, s1), and the
    cluster's units [j0, j1) its w2 slab spans. Pure Python; csrc
    ffn_mma_kernel's indexing."""
    U, C, S = plan
    out = []
    for tile in range(math.ceil(M / S)):
        for cl in range(Hd // (U * C)):
            for r in range(C):
                u0 = (cl * C + r) * U
                out.append({"units": (u0, u0 + U),
                            "cols": (r * D // C, (r + 1) * D // C),
                            "slots": (tile * S, min(M, (tile + 1) * S)),
                            "cluster_units": (cl * C * U, (cl + 1) * C * U)})
    return out


def ffn_launch(x, Hd: int, launch) -> None:
    """K7's and K9's chunked launch over x [B, D]'s rows: ``launch(rows,
    plan, ypart, tickets)`` once per chunk of at most 32 rows, with the
    chunk's plan, the clusters' partial sums [G, rows, D] (f32 scratch)
    and the zeroed tickets."""
    D = x.shape[1]
    dev, st = x.device, _build.stream()
    tickets = _build.workspace(st, dev, "ffn_b_tickets", FFN_TICKETS,
                               torch.int32, zero=True)

    def chunk(rows):
        m = rows.stop - rows.start
        plan = ffn_plan(D, Hd, m, x.element_size())
        G = Hd // (plan.units * plan.cluster)
        ypart = _build.workspace(st, dev, "ffn_b_y", G * m * D)
        launch(rows, plan, ypart, tickets)

    _build.in_row_chunks(x.shape[0], chunk)


def _slot_positions(pos, B: int, device) -> torch.Tensor:
    """pos as the kernel reads it: a contiguous int32 [B] on ``device``
    (an int is broadcast; a tensor elsewhere is refused, not copied)."""
    if not isinstance(pos, torch.Tensor):
        return torch.full((B,), int(pos), dtype=torch.int32, device=device)
    if pos.dtype != torch.int32 or tuple(pos.shape) != (B,) \
            or pos.device != device or not pos.is_contiguous():
        raise ValueError(f"pos must be a contiguous int32 [{B}] tensor on "
                         f"{device}, got {pos.dtype} {tuple(pos.shape)} on "
                         f"{pos.device}")
    return pos


# K5's and K6's launch (csrc batched_block_kernel): one thread block
# cluster per (head, tile of slots); the plan picks the cluster size, the
# slots of a tile and the rows staged at a time (the kernel cuts Wq's rows,
# Wo's columns and the tile's cache rows over the cluster's blocks itself:
# ``batched_blocks`` mirrors that cut). The constants come from sweeps of
# the plan on an H100 (PERF.md, PR 13): the kernel's time is set by its
# slowest blocks, so small clusters and short serial chains win
BATCHED_MIN_CLUSTER = 4        # blocks of a cluster, at least
BATCHED_WQ_BYTES = 30 * 1024   # a block's share of a head's Wq, at most
BATCHED_CROSS_BLOCKS = 240     # K6: blocks aimed for over all tiles
BATCHED_CROSS_SLOTS = 3        # K6: slots of a tile, at most
BATCHED_SELF_SLOTS = 4         # K5: slots of a tile
BATCHED_WIDE_ROWS = 512        # K6: a block's rows up to which chunks take
                               # three row groups, else two
BATCHED_STAGE_BYTES = 26 * 1024  # staged K/V rows (and row scales), a chunk
BATCHED_SHARE_BYTES = 24 * 1024  # every block's projection shares, a block
BATCHED_TICKETS = _build.MAX_ROWS * CROSS_MAX_CLUSTER   # csrc: one a
                                                        # (tile, block)


class BatchedPlan(NamedTuple):
    """``cluster`` blocks per (head, tile); ``slots`` slots a tile (the
    grid's tiles: ceil(B / slots)); rows staged ``chunk`` at a time."""
    cluster: int
    slots: int
    chunk: int


def batched_plan(n_heads: int, D: int, B: int, n_loop: int,
                 cache_size: int, width: int = HEAD_DIM) -> BatchedPlan:
    """K5's and K6's launch for B slots of at most ``n_loop`` cache rows
    of ``cache_size`` bytes an element (K6: the rows below enc_len, or
    all of them; K5: the cache's length, the slots' positions being on
    the device) and ``width`` projected columns a head (K6 64, K5 192).

    Clusters of ``BATCHED_MIN_CLUSTER`` blocks, doubled (up to
    ``CROSS_MAX_CLUSTER``) while a block's share of a head's Wq exceeds
    ``BATCHED_WQ_BYTES``. K6 streams B x n_loop rows: tiles of up to
    ``BATCHED_CROSS_SLOTS`` slots, as few as bring the grid to about
    ``BATCHED_CROSS_BLOCKS`` blocks (each tile reads the weights once
    more, from the L2 cache), chunks of three 64-row groups where a block
    holds at most ``BATCHED_WIDE_ROWS`` rows, else two. K5 attends over
    few rows a slot at a decode position: tiles of ``BATCHED_SELF_SLOTS``
    slots and chunks of one group, the smallest shared memory. Chunks fit
    ``BATCHED_STAGE_BYTES`` (one group at least) and every block's
    projection shares fit ``BATCHED_SHARE_BYTES``."""
    H, B = max(1, n_heads), max(1, B)
    cluster = BATCHED_MIN_CLUSTER
    while cluster < CROSS_MAX_CLUSTER \
            and D * width > cluster * BATCHED_WQ_BYTES:
        cluster *= 2
    fit_shares = max(1, BATCHED_SHARE_BYTES // (4 * width * cluster))
    if width > HEAD_DIM:
        slots = min(B, BATCHED_SELF_SLOTS, fit_shares)
        groups = 1
    else:
        slots = max(1, min(B, BATCHED_CROSS_SLOTS, fit_shares,
                           math.ceil(B * cluster * H / BATCHED_CROSS_BLOCKS)))
        rows = math.ceil(slots * max(1, n_loop) / cluster)
        groups = 3 if rows <= BATCHED_WIDE_ROWS else 2
    per_row = 2 * (HEAD_DIM * cache_size + 4)
    fit = BATCHED_STAGE_BYTES // per_row // CROSS_GROUPS
    return BatchedPlan(cluster, slots,
                       CROSS_GROUPS * max(1, min(groups, fit)))


def batched_blocks(plan: BatchedPlan, D: int, lens) -> list:
    """How the kernel cuts a tile's work over the blocks of its cluster,
    for the tile's slots' row counts ``lens`` (K5: pos[b], K6: n_loop for
    every slot): for block r, its Wq rows [k0, k1), its Wo columns
    [c0, c1) and its cache rows as (slot, t0, t1) runs (the tile's rows
    slot after slot, cut into ``cluster`` equal runs; each run walked a
    slot at a time). Pure Python; csrc batched_block_kernel's steps 1, 3
    and 6."""
    C, U = plan.cluster, D // 16
    pre = [sum(lens[:s]) for s in range(len(lens))]
    total = sum(lens)
    run = math.ceil(total / C)
    out = []
    for r in range(C):
        f0 = min(total, r * run)
        f1 = min(total, f0 + run)
        rows = [(s, max(f0, p) - p, min(f1, p + n) - p)
                for s, (p, n) in enumerate(zip(pre, lens))
                if n > 0 and p < f1 and p + n > f0]
        out.append({"wq_rows": (r * D // C, (r + 1) * D // C),
                    "wo_cols": (16 * (r * U // C), 16 * ((r + 1) * U // C)),
                    "rows": rows})
    return out


def _batched_scratch(st, dev, n_heads: int, D: int, B: int):
    """The o-proj's per-head partials [H, B, D] (B of one launch) and the
    zeroed tickets of K5's and K6's launches."""
    n = min(B, _build.MAX_ROWS)
    return (_build.workspace(st, dev, "batched_y", n_heads * n * D),
            _build.workspace(st, dev, "batched_tickets", BATCHED_TICKETS,
                             torch.int32, zero=True))


def _self_block_batched_cuda(x, blk, kq, ks, vq, vs, pos, l: int,
                             n_heads: int):
    B = _check_call(x, blk["wqkv"], l, kq, batched=True)
    D, T = x.shape[1], kq.shape[2]
    dev, st = x.device, _build.stream()
    pos = _slot_positions(pos, B, dev)
    x_out = torch.empty_like(x)
    k_row = torch.empty((B, D), dtype=kq.dtype, device=dev)
    v_row = torch.empty((B, D), dtype=kq.dtype, device=dev)
    k_scale = torch.empty(B, dtype=torch.float32, device=dev)
    v_scale = torch.empty(B, dtype=torch.float32, device=dev)
    W = _build.workspace
    P = _build.ptr
    n = min(B, _build.MAX_ROWS)
    scratch = _batched_scratch(st, dev, n_heads, D, B)
    # int8 rows: the projection and each head's largest |k|, |v| between
    # the kernel's two launches
    between = ((W(st, dev, "batched_qkv", n * 3 * D),
                W(st, dev, "batched_hmax", n * n_heads * 2))
               if ks is not None else (None, None))
    c0, s0 = l * B * T * D, l * B * T      # the layer's cache block

    def launch(rows):
        r = rows.start                     # chunk = pointer offsets
        plan = batched_plan(n_heads, D, rows.stop - r, T, kq.element_size(),
                            3 * HEAD_DIM)
        rc = _build.library().wa_self_block_batched(
            P(x, r * D), _build.DTYPE_CODES[x.dtype], rows.stop - r, D,
            n_heads, P(blk["ln1_w"], l * D), P(blk["ln1_b"], l * D),
            P(blk["wqkv"], l * D * 3 * D), P(blk["sqkv"], l * 3 * D),
            P(blk["bqkv"], l * 3 * D),
            P(kq, c0 + r * T * D), P(ks, s0 + r * T), P(vq, c0 + r * T * D),
            P(vs, s0 + r * T), _build.DTYPE_CODES[kq.dtype], T, P(pos, r),
            P(blk["self_wo"], l * D * D), P(blk["self_wos"], l * D),
            P(blk["self_wob"], l * D),
            P(x_out, r * D), P(k_row, r * D), P(k_scale, r), P(v_row, r * D),
            P(v_scale, r), *plan, *scratch, *between, st)
        _build.check(rc, "self_block_batched")
        LAUNCHES["self_block_batched"] += 1

    _build.in_row_chunks(B, launch)
    return x_out, k_row, k_scale, v_row, v_scale


def _cross_block_batched_cuda(x, blk, kq, ks, vq, vs, enc_len: int, l: int,
                              n_heads: int):
    B = _check_call(x, blk["wcq"], l, kq, batched=True)
    D, T = x.shape[1], kq.shape[2]
    dev, st = x.device, _build.stream()
    x_out = torch.empty_like(x)
    P = _build.ptr
    scratch = _batched_scratch(st, dev, n_heads, D, B)
    c0, s0 = l * B * T * D, l * B * T      # the layer's cache block

    def launch(rows):
        r = rows.start                     # chunk = pointer offsets
        plan = batched_plan(n_heads, D, rows.stop - r,
                            int(enc_len) if enc_len > 0 else T,
                            kq.element_size())
        rc = _build.library().wa_cross_block_batched(
            P(x, r * D), _build.DTYPE_CODES[x.dtype], rows.stop - r, D,
            n_heads, P(blk["ln2_w"], l * D), P(blk["ln2_b"], l * D),
            P(blk["wcq"], l * D * D), P(blk["scq"], l * D),
            P(blk["bcq"], l * D),
            P(kq, c0 + r * T * D), P(ks, s0 + r * T), P(vq, c0 + r * T * D),
            P(vs, s0 + r * T), _build.DTYPE_CODES[kq.dtype], T,
            int(enc_len),
            P(blk["cross_wo"], l * D * D), P(blk["cross_wos"], l * D),
            P(blk["cross_wob"], l * D), P(x_out, r * D), *plan, *scratch,
            st)
        _build.check(rc, "cross_block_batched")
        LAUNCHES["cross_block_batched"] += 1

    _build.in_row_chunks(B, launch)
    return x_out


def _ffn_block_batched_cuda(x, blk, l: int):
    _check_call(x, blk["w1"], l, batched=True)
    D, H = blk["w1"].shape[1], blk["w1"].shape[2]
    x_out = torch.empty_like(x)
    P = _build.ptr

    def launch(rows, plan, ypart, tickets):
        r = rows.start                     # chunk = pointer offsets
        rc = _build.library().wa_ffn_block_batched(
            P(x, r * D), _build.DTYPE_CODES[x.dtype], rows.stop - r, D, H,
            P(blk["ln3_w"], l * D), P(blk["ln3_b"], l * D),
            P(blk["w1"], l * D * H), P(blk["s1"], l * H),
            P(blk["b1"], l * H), P(blk["w2"], l * H * D),
            P(blk["fc2_s"], l * D), P(blk["fc2_b"], l * D), P(x_out, r * D),
            *plan, ypart, tickets, _build.stream())
        _build.check(rc, "ffn_block_batched")
        LAUNCHES["ffn_block_batched"] += 1

    ffn_launch(x, H, launch)
    return x_out


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _dispatch(x: torch.Tensor, plain, cuda, *args):
    if x.device.type == "cpu":
        return plain(x, *args)
    if x.device.type == "cuda":
        return cuda(x, *args)
    raise ValueError(f"no kernel for device {x.device}")


def self_block(x: torch.Tensor, blk: dict, kq: torch.Tensor,
               ks: Optional[torch.Tensor], vq: torch.Tensor,
               vs: Optional[torch.Tensor], pos: int, layer: int,
               n_heads: int):
    """Whole self-attention sub-block for one decode token (K1).

    x [1, D] (f32 or bf16); blk from ``prepare_qdecode`` (or passed by
    ``check_blk``); kq/vq [L, 1, T, D] cache stacks from
    ``quantize_cache`` (or passed by ``check_cache``): compute dtype,
    int8 with f32 row scales ks/vs [L, 1, T, 1], or float8_e4m3fn; rows
    < pos are the history (the current token's k/v are computed here and
    NOT yet in the cache).

    Returns (x_out [1, D], k_row [1, D], k_scale [1], v_row [1, D],
    v_scale [1]); the caller writes the rows into the cache at ``pos``.
    """
    return _dispatch(x, self_block_plain, _self_block_cuda, blk, kq, ks, vq,
                     vs, int(pos), int(layer), n_heads)


def cross_block(x: torch.Tensor, blk: dict, kq: torch.Tensor,
                ks: Optional[torch.Tensor], vq: torch.Tensor,
                vs: Optional[torch.Tensor], enc_len: int, layer: int,
                n_heads: int) -> torch.Tensor:
    """Whole cross-attention sub-block (K2): x [1, D] -> x_out [1, D];
    rows of the (padded) cross cache < enc_len take part."""
    return _dispatch(x, cross_block_plain, _cross_block_cuda, blk, kq, ks,
                     vq, vs, int(enc_len), int(layer), n_heads)


def ffn_block(x: torch.Tensor, blk: dict, layer: int) -> torch.Tensor:
    """Whole FFN sub-block (K3): x + fc2(gelu(fc1(LN3(x)))) with the fc2
    per-channel scale and bias. x [1, D] -> [1, D]."""
    return _dispatch(x, ffn_block_plain, _ffn_block_cuda, blk, int(layer))


def self_block_batched(x: torch.Tensor, blk: dict, kq: torch.Tensor,
                       ks: Optional[torch.Tensor], vq: torch.Tensor,
                       vs: Optional[torch.Tensor], pos, layer: int,
                       n_heads: int):
    """K5: ``self_block`` for B slots at their own positions.

    x [B, D]; kq/vq [L, B, T, D] (ks/vs [L, B, T, 1]); ``pos`` the slots'
    positions, an int32 [B] tensor on x's device (or an int for all):
    rows < pos[b] are slot b's history. Returns (x_out [B, D], k_row
    [B, D], k_scale [B], v_row [B, D], v_scale [B]); the caller writes
    slot b's rows at pos[b].
    """
    return _dispatch(x, self_block_plain, _self_block_batched_cuda, blk, kq,
                     ks, vq, vs, pos, int(layer), n_heads)


def cross_block_batched(x: torch.Tensor, blk: dict, kq: torch.Tensor,
                        ks: Optional[torch.Tensor], vq: torch.Tensor,
                        vs: Optional[torch.Tensor], enc_len: int, layer: int,
                        n_heads: int) -> torch.Tensor:
    """K6: ``cross_block`` for B slots, x [B, D] over cross caches
    [L, B, S, D]; rows < enc_len of every slot take part."""
    return _dispatch(x, cross_block_plain, _cross_block_batched_cuda, blk,
                     kq, ks, vq, vs, int(enc_len), int(layer), n_heads)


def ffn_block_batched(x: torch.Tensor, blk: dict,
                      layer: int) -> torch.Tensor:
    """K7: ``ffn_block`` for x [B, D], each weight read once for all
    rows."""
    return _dispatch(x, ffn_block_plain, _ffn_block_batched_cuda, blk,
                     int(layer))
