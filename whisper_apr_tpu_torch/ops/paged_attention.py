"""Decode attention over a paged KV pool (K15): port of
``whisper_apr_tpu/ops/paged_attention.py``.

One query row per slot attends to that slot's history, held in 16-row
pages of a pool shared by every slot and found through the slot's page
table (the vLLM layout of ``model/kv_variants.PagedKVCache``). For slot b
and head h: scores ``k . (q * hd**-0.5)`` in f32 over the rows
``t < min(lengths[b], 16 * P)``, row t in page ``tables[b, t // 16]`` at
offset ``t % 16`` of ``pool[layer]``; softmax in f32 (sum clamped to
1e-30); the output in q's dtype. A slot with no valid row scores all of
its P pages' rows -0.7 * f32max, as the JAX kernel. Page ids are clamped
into the pool, as the JAX gather clamps them. The kernel reads at most
the table's width in pages whatever ``lengths`` says, and never a row
past the slot's length.

``paged_attention_stacked`` runs the hand-written CUDA kernel
(``csrc/paged_attention.cu``) for CUDA tensors and the plain PyTorch
version below for CPU tensors.
"""

from __future__ import annotations

import torch

from . import _build

_NEG = -0.7 * float(torch.finfo(torch.float32).max)

# launches of the kernel in this process (reset by the caller)
LAUNCHES = {"paged_attention_stacked": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def paged_attention_stacked_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                  v_pool: torch.Tensor, tables: torch.Tensor,
                                  lengths: torch.Tensor, layer: int,
                                  n_heads: int) -> torch.Tensor:
    B, D = q.shape
    _, n_pages, page, _ = k_pool.shape
    P = tables.shape[1]
    hd = D // n_heads
    idx = tables.long().clamp(0, n_pages - 1)                  # [B, P]
    k = k_pool[layer][idx].reshape(B, P * page, n_heads, hd).float()
    v = v_pool[layer][idx].reshape(B, P * page, n_heads, hd).float()
    q32 = (q.float() * hd ** -0.5).reshape(B, 1, n_heads, hd)
    s = (k * q32).sum(-1)                                      # [B, T, H]
    n_valid = lengths.long().clamp(0, P * page)
    rows = torch.arange(P * page, device=q.device)[None, :]
    valid = (rows < n_valid[:, None])[:, :, None]              # [B, T, 1]
    # rows past the length take no part (score NEG, value 0); a slot with
    # no valid row takes all of its rows at NEG, as the JAX kernel
    take = valid | (n_valid == 0)[:, None, None]
    s = torch.where(valid, s, _NEG)
    p = torch.exp(s - s.amax(1, keepdim=True))
    out = torch.einsum("bth,bthd->bhd", p,
                       torch.where(take[..., None], v, 0.0))
    out = out / p.sum(1).clamp_min(1e-30)[..., None]
    return out.reshape(B, D).to(q.dtype)


def _paged_cuda(q, k_pool, v_pool, tables, lengths, layer, n_heads):
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"q and the pools must share one dtype, f32 or "
                        f"bf16: {q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("tables and lengths must be int32")
    B, D = q.shape
    L, n_pages, page, D2 = k_pool.shape
    P = tables.shape[1]
    if D2 != D or v_pool.shape != k_pool.shape or page != 16 \
            or tables.shape != (B, P) or lengths.shape != (B,) or P < 1:
        raise ValueError(f"shapes q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}, tables "
                         f"{tuple(tables.shape)}, lengths "
                         f"{tuple(lengths.shape)}: want [B, D], "
                         "[L, n_pages, 16, D], [B, P >= 1], [B]")
    if D != 64 * n_heads:
        raise ValueError(f"head dim {D // n_heads}: the kernel takes 64")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside the {L}-layer pool")
    for name, t in dict(q=q, k_pool=k_pool, v_pool=v_pool, tables=tables,
                        lengths=lengths).items():
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor on "
                             f"{q.device}")
    out = torch.empty_like(q)
    off = layer * n_pages * page * D
    P_ = _build.ptr
    rc = _build.library().wa_paged_attention(
        P_(q), _build.DTYPE_CODES[q.dtype], B, D, n_heads, P_(k_pool, off),
        P_(v_pool, off), n_pages, P_(tables), P, P_(lengths), P_(out),
        _build.stream())
    _build.check(rc, "paged_attention_stacked")
    LAUNCHES["paged_attention_stacked"] += 1
    return out


def paged_attention_stacked(q: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, tables: torch.Tensor,
                            lengths: torch.Tensor, layer: int,
                            n_heads: int) -> torch.Tensor:
    """K15: q [B, D] one token per slot; pools [L, n_pages, 16, D] in q's
    dtype (f32 or bf16), the layer a host int; tables [B, P] int32 page
    ids; lengths [B] int32 valid rows (the current token's included, its
    K/V already in the pool). Returns [B, D] in q's dtype."""
    if q.device.type == "cpu":
        return paged_attention_stacked_plain(q, k_pool, v_pool, tables,
                                             lengths, int(layer), n_heads)
    if q.device.type == "cuda":
        return _paged_cuda(q, k_pool, v_pool, tables, lengths, int(layer),
                           n_heads)
    raise ValueError(f"no kernel for device {q.device}")


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, tables: torch.Tensor,
                    lengths: torch.Tensor, n_heads: int) -> torch.Tensor:
    """One-layer form of K15: pools [n_pages, 16, D]."""
    return paged_attention_stacked(q, k_pool[None], v_pool[None], tables,
                                   lengths, 0, n_heads)
