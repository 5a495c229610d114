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
version below for CPU tensors. The kernel's launch comes from
:func:`paged_plan`, from the host's shapes alone: it never reads
``lengths`` on the host (no sync, and CUDA-graph replay stays valid).
"""

from __future__ import annotations

import math
from typing import NamedTuple

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


# K15's launch (csrc/paged_attention.cu): grid (ceil(P / run), B, G),
# clusters of the ceil(P / run) blocks of one (slot, head group); a block
# takes a run of ``run`` pages of one slot and H / G heads. ``paged_smem``
# mirrors the kernel's shared-memory layout (csrc paged_layout)
PAGE = 16                      # rows a page (kv_variants.PAGE_SIZE)
PAGED_THREADS = 256            # threads a block
PAGED_MAX_RUN = 4              # pages a block, at most (csrc PA_MAX_RUN)
PAGED_MAX_CLUSTER = 16         # runs of a slot, at most (csrc PA_MAX_CLUSTER)
PAGED_MAX_HEADS = 32           # heads, at most (csrc PA_MAX_HEADS)
PAGED_GROUP_BYTES = 512        # a row's head-group columns, at most


class PagedPlan(NamedTuple):
    """``run`` pages of a slot's table a block, ``groups`` head groups."""
    run: int
    groups: int


def _r16(n: int) -> int:
    return -(-n // 16) * 16


def paged_smem(D: int, H: int, elem: int, run: int, groups: int,
               P: int) -> int:
    """Bytes of shared memory of a K15 block (csrc paged_layout): the
    run's rows of K and V in the group's Dg columns, q, the run's scores,
    the weighted-V row groups' sums, acc, m and l, the merge's weights,
    the ranks' (m, l) and column shares received, a barrier."""
    Hg = H // groups
    Dg = 64 * Hg
    R = math.ceil(P / run)
    chunks = Dg * elem // 16
    row_groups = 1 if chunks >= PAGED_THREADS else PAGED_THREADS // chunks
    share = (Dg // 4) // R + 1
    return (2 * run * PAGE * Dg * elem + _r16(Dg * elem)
            + _r16(run * PAGE * Hg * 4) + row_groups * Dg * 4 + Dg * 4
            + 2 * _r16(Hg * 4) + _r16(R * Hg * 4) + _r16(R * 2 * Hg * 4)
            + R * share * 16 + 16)


def paged_plan(B: int, P: int, H: int, D: int, elem: int) -> PagedPlan:
    """K15's launch for B slots of P-page tables (P <= 64), H heads of 64
    over D (elem bytes an element): ``PAGED_MAX_RUN`` pages a block (all
    of a shorter table), and head groups of the most heads, a power of
    two dividing H, whose columns of a row fit ``PAGED_GROUP_BYTES``. On
    the H100 (PERF.md) four pages a block beat two and three at both
    widths, and 2 heads a group (tiny, f32 at large-v3) or 4 (bf16 at
    large-v3) beat the other groupings."""
    Hg = 1
    while H % (2 * Hg) == 0 and 2 * Hg * 64 * elem <= PAGED_GROUP_BYTES:
        Hg *= 2
    return PagedPlan(min(PAGED_MAX_RUN, P), H // Hg)


def paged_blocks(plan: PagedPlan, B: int, P: int, H: int) -> list:
    """(slot, pages, heads) of each block of the grid, in launch order:
    block (r, b, g) the pages [r run, min(P, (r + 1) run)) of slot b and
    the heads [g H / G, (g + 1) H / G)."""
    runs, Hg = math.ceil(P / plan.run), H // plan.groups
    return [(b, range(r * plan.run, min(P, (r + 1) * plan.run)),
             range(g * Hg, (g + 1) * Hg))
            for g in range(plan.groups) for b in range(B)
            for r in range(runs)]


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
    if D != 64 * n_heads or n_heads > PAGED_MAX_HEADS:
        raise ValueError(f"head dim {D // n_heads}, {n_heads} heads: the "
                         f"kernel takes 64, at most {PAGED_MAX_HEADS}")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside the {L}-layer pool")
    for name, t in dict(q=q, k_pool=k_pool, v_pool=v_pool, tables=tables,
                        lengths=lengths).items():
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor on "
                             f"{q.device}")
    out = torch.empty_like(q)
    off = layer * n_pages * page * D
    plan = paged_plan(B, P, n_heads, D, q.element_size())
    if math.ceil(P / plan.run) > PAGED_MAX_CLUSTER:
        raise ValueError(f"a table of {P} pages: the kernel takes at most "
                         f"{PAGED_MAX_RUN * PAGED_MAX_CLUSTER}")
    P_ = _build.ptr
    rc = _build.library().wa_paged_attention(
        P_(q), _build.DTYPE_CODES[q.dtype], B, D, n_heads, P_(k_pool, off),
        P_(v_pool, off), n_pages, P_(tables), P, P_(lengths), P_(out),
        *plan, _build.stream())
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
