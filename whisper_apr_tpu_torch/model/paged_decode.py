"""Batched decode steps over the paged KV pool: port of
``whisper_apr_tpu/model/paged_decode.py``.

The serving scheduler's paged slots (``parallel/serving.BatchScheduler(
paged=True)``) keep their self K/V in 16-token pages of one pool
[L, n_pages, 16, D] that every slot shares; the host allocator
(``kv_variants.PagedKVCache``) hands out the pages, and the step below
scatters each slot's new K/V row into its page and attends THROUGH the
page tables with K15 (``ops/paged_attention.paged_attention_stacked``),
once per layer. Its linears go through ``ops/basic.linear`` over the
engine's params, so with ``int8_matmul.USE_PALLAS_INT8`` on and int8
weights K17 runs in the same step. The pools are updated in place;
``paged_decode_steps`` is the Python-loop twin of the JAX
``paged_decode_steps_jit``. On the CPU the plain versions run.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..ops import paged_attention as pa
from ..ops.basic import gelu, layer_norm, linear, mha
from ..ops.tp import require_unsharded
from .decoder import embed, project_to_vocab
from .kv_variants import PAGE_SIZE
from .params import layer_slice


def _embed_multi(params: dict, token: torch.Tensor, pos: torch.Tensor,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    """Token + positional embedding at per-slot positions [B] ->
    [B, 1, D]."""
    return embed(params, token[:, None], pos, compute_dtype)


def paged_decode_step(params: dict, token: torch.Tensor, pos: torch.Tensor,
                      tables: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, cross_k: torch.Tensor,
                      cross_v: torch.Tensor, config: ModelConfig,
                      compute_dtype: torch.dtype = torch.float32
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One batched decode step over the paged pools.

    token/pos [B] on the device (pos = the token's index in its
    sequence); tables [B, P] int32 page ids; pools [L, n_pages, 16, D]
    (written in place); cross_k/v [L, B, S, D]. Returns (logits [B, V]
    f32, k_pool, v_pool). Each slot's new K/V row goes to page
    ``tables[b, pos // 16]`` at offset ``pos % 16`` before K15 reads the
    pool, with ``lengths = pos + 1``. A slot whose ``pos // 16`` lies past
    the table's width (an inactive slot resting at its last position
    while the width is bucketed to the active ones) takes the table's
    last entry, the garbage page, where the JAX gather clamps the
    index. Several slots may write one (page, offset): inactive slots
    all write into the garbage page, which no active row reads."""
    B = token.shape[0]
    pos = pos.to(device=token.device, dtype=torch.long)
    x = _embed_multi(params, token, pos, compute_dtype)
    rows = torch.arange(B, device=token.device)
    col = torch.clamp(pos // PAGE_SIZE, max=tables.shape[1] - 1)
    pages = tables[rows, col].long()
    offs = pos % PAGE_SIZE
    lengths = (pos + 1).to(torch.int32)
    tables = tables.to(torch.int32).contiguous()
    n_heads = config.n_text_head
    blocks = params["decoder"]["blocks"]
    for l in range(config.n_text_layer):
        blk = layer_slice(blocks, l)
        h = layer_norm(x, blk["ln1"]["w"], blk["ln1"]["b"])
        sa = blk["self_attn"]
        q = linear(h, sa["q_w"], sa["q_b"])
        k_pool[l, pages, offs] = linear(h, sa["k_w"], sa["k_b"])[:, 0].to(
            k_pool.dtype)
        v_pool[l, pages, offs] = linear(h, sa["v_w"], sa["v_b"])[:, 0].to(
            v_pool.dtype)
        attn = pa.paged_attention_stacked(
            q[:, 0].contiguous(), k_pool, v_pool, tables, lengths, l,
            n_heads)[:, None, :]
        x = x + linear(attn.to(x.dtype), sa["o_w"], sa["o_b"])

        h = layer_norm(x, blk["ln2"]["w"], blk["ln2"]["b"])
        ca = blk["cross_attn"]
        q = linear(h, ca["q_w"], ca["q_b"])
        x = x + linear(mha(q, cross_k[l], cross_v[l], n_heads), ca["o_w"],
                       ca["o_b"])

        h = layer_norm(x, blk["ln3"]["w"], blk["ln3"]["b"])
        x = x + linear(gelu(linear(h, blk["fc1"]["w"], blk["fc1"]["b"])),
                       blk["fc2"]["w"], blk["fc2"]["b"])
    dec = params["decoder"]
    x = layer_norm(x, dec["ln_post"]["w"], dec["ln_post"]["b"])
    return project_to_vocab(params, x[:, 0, :]), k_pool, v_pool


def paged_decode_steps(params: dict, token: torch.Tensor, pos: torch.Tensor,
                       suppress_bias: torch.Tensor, tables: torch.Tensor,
                       k_pool: torch.Tensor, v_pool: torch.Tensor,
                       cross_k: torch.Tensor, cross_v: torch.Tensor,
                       config: ModelConfig, n_steps: int = 1,
                       compute_dtype: torch.dtype = torch.float32
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Advance every slot ``n_steps`` greedy tokens (argmax of logits +
    ``suppress_bias``) over the paged pools. The host must have extended
    each active slot's table to cover ``pos + n_steps`` tokens. Returns
    (tokens [B, n_steps] int32, k_pool, v_pool)."""
    require_unsharded(params, "the paged step (K15)")
    pos = pos.to(device=token.device, dtype=torch.long)
    toks = []
    for _ in range(n_steps):
        logits, k_pool, v_pool = paged_decode_step(
            params, token, pos, tables, k_pool, v_pool, cross_k, cross_v,
            config, compute_dtype)
        token = torch.argmax(logits + suppress_bias[None, :], dim=-1).to(
            torch.int32)
        toks.append(token)
        pos = pos + 1
    return torch.stack(toks, dim=1), k_pool, v_pool


def write_prefills_to_pool(k_pool: torch.Tensor, v_pool: torch.Tensor,
                           self_k: torch.Tensor, self_v: torch.Tensor,
                           pages: torch.Tensor, offs: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter a batch of prefilled K/V [L, n, P, D] into their pages, in
    place; pages/offs [n, P] (page id and in-page offset per position).
    Rows that share a (page, offset) must carry identical values (the
    admission pads repeat the last real slot)."""
    pages, offs = pages.long(), offs.long()
    k_pool[:, pages, offs] = self_k.to(k_pool.dtype)
    v_pool[:, pages, offs] = self_v.to(v_pool.dtype)
    return k_pool, v_pool


def write_prefill_to_pool(k_pool: torch.Tensor, v_pool: torch.Tensor,
                          self_k: torch.Tensor, self_v: torch.Tensor,
                          table: np.ndarray, n_tokens: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter one sequence's prefilled K/V (dense [L, 1, T, D]) into its
    pages, in place; ``table`` its page ids (host array)."""
    positions = np.arange(n_tokens)
    dev = k_pool.device
    pages = torch.from_numpy(np.asarray(table)[positions // PAGE_SIZE]
                             .astype(np.int64)).to(dev)
    offs = torch.from_numpy(positions % PAGE_SIZE).to(dev)
    k_pool[:, pages, offs] = self_k[:, 0, :n_tokens].to(k_pool.dtype)
    v_pool[:, pages, offs] = self_v[:, 0, :n_tokens].to(v_pool.dtype)
    return k_pool, v_pool
