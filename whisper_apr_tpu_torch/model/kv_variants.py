"""KV-cache variants: port of ``whisper_apr_tpu/model/kv_variants.py``.

``decode_step_multi`` is the plain-torch step with a PER-SLOT position
vector (each serving slot at its own depth) over a dense ``KVCache``: the
step of engines without int8 weights. ``decode_steps_multi`` advances
every slot of a serving batch by ``n_steps`` greedy tokens; the cache
type and ``qd`` pick its step, as in the JAX tick: a ``QKVCache`` runs
``qdecode.decode_step_qf`` with per-slot positions and the logits tail
(K5-K7 per layer, then K8); a dense cache with ``qd`` runs the scan step
``qdecode.decode_step_q`` (K8 and K9); a dense cache without ``qd``
``decode_step_multi``.

``SlidingKVCache`` keeps a ring buffer of ``window`` self rows (token t
in row ``t % window``, attention masked to the rows written), with
``warm_up`` carrying the last ``context_overlap`` tokens of a previous
chunk. ``PagedKVCache`` is the host allocator over device page pools
``[L, n_pages, 16, D]`` (the serving scheduler's paged slots, whose
batched step is ``model/paged_decode``); ``paged_decode_step`` and
``generate_paged`` decode one sequence over it by gathering its pages
(no kernel).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..errors import InferenceError
from ..ops.basic import gelu, layer_norm, linear, mha
from ..ops.dispatch import resolve_device
from ..ops.tp import local_config
from .decoder import (KVCache, block_step, embed, init_cache,
                      precompute_cross_kv, project_to_vocab)
from .params import layer_slice
from .qdecode import QKVCache, decode_step_q, decode_step_qf


def decode_step_multi(params: dict, token: torch.Tensor, pos: torch.Tensor,
                      cache: KVCache, config: ModelConfig,
                      compute_dtype: torch.dtype = torch.float32
                      ) -> Tuple[torch.Tensor, KVCache]:
    """One plain-torch decode step with PER-SLOT positions: token [B]
    int32, pos [B] (each slot's current row) -> (logits [B, V] f32,
    cache), slot b's self rows at pos[b] written in place."""
    config = local_config(params, config)
    B = token.shape[0]
    T = cache.self_k.shape[2]
    pos_d = pos.to(device=token.device, dtype=torch.long).reshape(B)
    if pos.device.type == "cpu" and (bool((pos < 0).any())
                                     or bool((pos >= T).any())):
        raise ValueError(f"positions {pos.tolist()} outside the self cache "
                         f"({T} rows)")
    x = embed(params, token[:, None], pos_d, compute_dtype)     # [B, 1, D]
    valid = (torch.arange(T, device=token.device)[None, :]
             <= pos_d[:, None])[:, None, None, :]
    at = (torch.arange(B, device=token.device), pos_d)
    blocks = params["decoder"]["blocks"]
    for l in range(config.n_text_layer):
        x = block_step(x, layer_slice(blocks, l), cache.self_k[l],
                       cache.self_v[l], cache.cross_k[l], cache.cross_v[l],
                       at, valid, config.n_text_head)
    dec = params["decoder"]
    x = layer_norm(x, dec["ln_post"]["w"], dec["ln_post"]["b"])
    return project_to_vocab(params, x[:, 0, :]), cache


def decode_steps_multi(params: dict, token: torch.Tensor, pos,
                       suppress_bias: torch.Tensor, cache, config: ModelConfig,
                       n_steps: int,
                       compute_dtype: torch.dtype = torch.float32,
                       qd: Optional[dict] = None):
    """Advance every slot by ``n_steps`` greedy tokens.

    token [B] int32 on the device; pos [B] the slots' current positions
    (host ints); suppress_bias [V] f32. Positions are clamped to the last
    cache row, as the JAX tick does. Returns (tokens [B, n_steps] int32,
    cache) with the cache rows written in place. Slots that hit EOT keep
    stepping; the caller cuts each slot's stream at its own EOT.
    """
    if isinstance(cache, QKVCache):
        if qd is None:
            raise ValueError("a QKVCache tick needs the qd it was built for")
        T_max = cache.self_kq.shape[2]

        def step(tok, p):
            return decode_step_qf(params, qd, tok, p, cache, config,
                                  compute_dtype=compute_dtype)
    else:
        T_max = cache.self_k.shape[2]

        def step(tok, p):
            if qd is None:
                return decode_step_multi(params, tok, p, cache, config,
                                         compute_dtype=compute_dtype)
            return decode_step_q(params, qd, tok, p, cache, config,
                                 compute_dtype=compute_dtype)
    p = np.asarray(pos, dtype=np.int64).reshape(-1)
    tok, toks = token, []
    for _ in range(n_steps):
        logits, _ = step(tok, torch.from_numpy(np.minimum(p, T_max - 1)))
        tok = torch.argmax(logits + suppress_bias[None, :], dim=-1).to(
            torch.int32)
        toks.append(tok)
        p = p + 1
    return torch.stack(toks, dim=1), cache


# ---------------------------------------------------------------------------
# Sliding-window KV (JAX kv_variants.py:175-330)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SlidingConfig:
    window_size: int = 448
    context_overlap: int = 64

    @staticmethod
    def standard() -> "SlidingConfig":
        return SlidingConfig(448, 64)

    @staticmethod
    def low_latency() -> "SlidingConfig":
        return SlidingConfig(64, 16)

    @staticmethod
    def ultra_low_latency() -> "SlidingConfig":
        return SlidingConfig(32, 8)


@dataclasses.dataclass
class SlidingCacheStats:
    window_size: int
    tokens_seen: int
    slides: int

    @property
    def utilization(self) -> float:
        return min(self.tokens_seen, self.window_size) / self.window_size


class SlidingKVCache:
    """Ring-buffer self-attention cache: token t lives in row
    ``t % window`` and attention sees the rows written so far (at most
    the last ``window`` tokens). Sliding is modular indexing, never a
    copy. The cache lives on ``enc_out``'s device."""

    def __init__(self, params: dict, enc_out: torch.Tensor,
                 config: ModelConfig,
                 sliding: Optional[SlidingConfig] = None,
                 compute_dtype: torch.dtype = torch.float32) -> None:
        self.sliding = sliding or SlidingConfig.standard()
        self.config = config
        self.compute_dtype = compute_dtype
        self.cache = init_cache(params, enc_out, config,
                                max_len=self.sliding.window_size,
                                compute_dtype=compute_dtype)
        self.tokens_seen = 0

    def step(self, params: dict, token: torch.Tensor) -> torch.Tensor:
        """Advance one token for every sequence; returns logits [B, V]."""
        W = self.sliding.window_size
        t = self.tokens_seen
        slot = torch.full((token.shape[0],), t % W, dtype=torch.long,
                          device=token.device)
        logits = _sliding_step(params, token, slot, t, self.cache,
                               self.config, W, self.compute_dtype)
        self.tokens_seen += 1
        return logits

    def warm_up(self, other: "SlidingKVCache") -> None:
        """Seed this cache with the last ``context_overlap`` tokens of a
        previous chunk's cache, in rows [0, ov)."""
        W = self.sliding.window_size
        ov = min(self.sliding.context_overlap, other.tokens_seen, W)
        if ov <= 0:
            return
        idx = torch.tensor([(other.tokens_seen - ov + i) % W
                            for i in range(ov)],
                           device=self.cache.self_k.device)
        self.cache.self_k[:, :, :ov] = other.cache.self_k[:, :, idx]
        self.cache.self_v[:, :, :ov] = other.cache.self_v[:, :, idx]
        self.tokens_seen = ov

    def stats(self) -> SlidingCacheStats:
        return SlidingCacheStats(
            self.sliding.window_size, self.tokens_seen,
            max(0, self.tokens_seen - self.sliding.window_size))


def _window_mask(window: int, slot: torch.Tensor, t: int) -> torch.Tensor:
    """Which ring rows hold one of the last ``window`` tokens at time t:
    [B, window] bool."""
    written = torch.arange(window, device=slot.device)[None, :] \
        <= min(t, window - 1)
    return written.expand(slot.shape[0], window)


def _sliding_step(params: dict, token: torch.Tensor, slot: torch.Tensor,
                  t: int, cache: KVCache, config: ModelConfig, window: int,
                  compute_dtype: torch.dtype) -> torch.Tensor:
    """One ring-buffer decode step (rows at ``slot`` written in place);
    the positional embedding saturates at the context's last row."""
    pos_idx = min(t, config.n_text_ctx - 1)
    x = embed(params, token[:, None], pos_idx, compute_dtype)  # [B, 1, D]
    valid = _window_mask(window, slot, t)[:, None, None, :]
    at = (torch.arange(token.shape[0], device=token.device), slot)
    blocks = params["decoder"]["blocks"]
    for l in range(config.n_text_layer):
        x = block_step(x, layer_slice(blocks, l), cache.self_k[l],
                       cache.self_v[l], cache.cross_k[l], cache.cross_v[l],
                       at, valid, config.n_text_head)
    dec = params["decoder"]
    x = layer_norm(x, dec["ln_post"]["w"], dec["ln_post"]["b"])
    return project_to_vocab(params, x[:, 0, :])


# ---------------------------------------------------------------------------
# Paged KV (JAX kv_variants.py:331-541)
# ---------------------------------------------------------------------------

PAGE_SIZE = 16  # tokens per page


class PagedKVCache:
    """vLLM-style paged cache: device page pools ``k_pool``/``v_pool``
    [L, n_pages, 16, D] and host page tables. Each sequence owns an
    ordered page list; ``alloc``/``extend``/``free`` hand pages out from
    the end of the free list and give them back to it, in the JAX
    allocator's order (so one request stream gives both packages the same
    page ids), and roll back on exhaustion (``InferenceError("out of KV
    pages")``, nothing mutated)."""

    def __init__(self, config: ModelConfig, n_pages: int,
                 compute_dtype: torch.dtype = torch.float32,
                 device: "torch.device | str" = "cuda") -> None:
        device = resolve_device(device, "PagedKVCache")
        L, D = config.n_text_layer, config.n_text_state
        self.config = config
        self.n_pages = n_pages
        self.k_pool = torch.zeros((L, n_pages, PAGE_SIZE, D),
                                  dtype=compute_dtype, device=device)
        self.v_pool = torch.zeros_like(self.k_pool)
        self._free: List[int] = list(range(n_pages))
        self._tables: Dict[int, List[int]] = {}
        self._lengths: Dict[int, int] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, seq_id: int, n_tokens: int = 0) -> None:
        if seq_id in self._tables:
            raise InferenceError(f"sequence {seq_id} already allocated")
        need = max(1, -(-n_tokens // PAGE_SIZE))
        if need > len(self._free):
            raise InferenceError("out of KV pages")
        self._tables[seq_id] = [self._free.pop() for _ in range(need)]
        self._lengths[seq_id] = n_tokens

    def extend(self, seq_id: int, n_tokens: int = 1) -> None:
        """Grow a sequence by ``n_tokens``, allocating pages on demand."""
        if seq_id not in self._tables:
            raise InferenceError(f"unknown sequence {seq_id}")
        new_len = self._lengths[seq_id] + n_tokens
        need = -(-new_len // PAGE_SIZE) - len(self._tables[seq_id])
        if need > len(self._free):
            raise InferenceError("out of KV pages")   # nothing mutated
        for _ in range(need):
            self._tables[seq_id].append(self._free.pop())
        self._lengths[seq_id] = new_len

    def free(self, seq_id: int) -> None:
        self._free.extend(self._tables.pop(seq_id, []))
        self._lengths.pop(seq_id, None)

    def seq_len(self, seq_id: int) -> int:
        return self._lengths.get(seq_id, 0)

    def page_table(self, seq_id: int, max_pages: int) -> np.ndarray:
        """Padded page table for the device step."""
        pages = self._tables.get(seq_id, [])
        out = np.zeros(max_pages, dtype=np.int32)
        out[: len(pages)] = pages[:max_pages]
        return out

    def write_token(self, seq_id: int, layer_k: torch.Tensor,
                    layer_v: torch.Tensor, pos: int) -> None:
        """Write K/V [L, D] of one token at ``pos`` into the pools."""
        page = self._tables[seq_id][pos // PAGE_SIZE]
        off = pos % PAGE_SIZE
        self.k_pool[:, page, off] = layer_k.to(self.k_pool.dtype)
        self.v_pool[:, page, off] = layer_v.to(self.v_pool.dtype)

    def gather_layer(self, seq_id: int, layer: int,
                     upto: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One layer's K/V [n, D] of a sequence (its first ``upto``
        tokens)."""
        pages = self._tables.get(seq_id)
        if pages is None:
            raise InferenceError(f"unknown sequence {seq_id}")
        n = self._lengths[seq_id] if upto is None else min(
            upto, self._lengths[seq_id])
        D = self.k_pool.shape[-1]
        idx = torch.tensor(pages, device=self.k_pool.device)
        k = self.k_pool[layer, idx].reshape(-1, D)[:n]
        v = self.v_pool[layer, idx].reshape(-1, D)[:n]
        return k, v

    def gather(self, seq_id: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """A sequence's K/V [L, len, D] from its pages."""
        pages = self._tables.get(seq_id)
        if not pages:
            raise InferenceError(f"unknown sequence {seq_id}")
        n = self._lengths[seq_id]
        L, D = self.k_pool.shape[0], self.k_pool.shape[-1]
        idx = torch.tensor(pages, device=self.k_pool.device)
        return (self.k_pool[:, idx].reshape(L, -1, D)[:, :n],
                self.v_pool[:, idx].reshape(L, -1, D)[:, :n])


def paged_decode_step(params: dict, token: int, pos: int,
                      paged: PagedKVCache, seq_id: int,
                      cross_k: torch.Tensor, cross_v: torch.Tensor,
                      config: ModelConfig,
                      compute_dtype: torch.dtype = torch.float32
                      ) -> torch.Tensor:
    """One decode step of one sequence over the paged pools: per layer
    the new token's K/V, attention over the sequence's gathered rows and
    the new one, then the new K/V written to its page after the last
    layer. cross_k/v [L, S, D]. Returns logits [1, V] f32."""
    dev = paged.k_pool.device
    x = embed(params, torch.tensor([[token]], device=dev), pos,
              compute_dtype)                                    # [1, 1, D]
    paged.extend(seq_id, 1)
    n_heads = config.n_text_head
    k_all, v_all = [], []
    blocks = params["decoder"]["blocks"]
    for li in range(config.n_text_layer):
        blk = layer_slice(blocks, li)
        h = layer_norm(x, blk["ln1"]["w"], blk["ln1"]["b"])
        sa = blk["self_attn"]
        q = linear(h, sa["q_w"], sa["q_b"])
        k_new = linear(h, sa["k_w"], sa["k_b"])[0, 0]
        v_new = linear(h, sa["v_w"], sa["v_b"])[0, 0]
        k_all.append(k_new)
        v_all.append(v_new)
        k_hist, v_hist = paged.gather_layer(seq_id, li, upto=pos)
        k_seq = torch.cat([k_hist.to(compute_dtype), k_new[None]])[None]
        v_seq = torch.cat([v_hist.to(compute_dtype), v_new[None]])[None]
        x = x + linear(mha(q, k_seq, v_seq, n_heads), sa["o_w"], sa["o_b"])

        h = layer_norm(x, blk["ln2"]["w"], blk["ln2"]["b"])
        ca = blk["cross_attn"]
        q = linear(h, ca["q_w"], ca["q_b"])
        x = x + linear(mha(q, cross_k[li][None], cross_v[li][None],
                           n_heads), ca["o_w"], ca["o_b"])

        h = layer_norm(x, blk["ln3"]["w"], blk["ln3"]["b"])
        x = x + linear(gelu(linear(h, blk["fc1"]["w"], blk["fc1"]["b"])),
                       blk["fc2"]["w"], blk["fc2"]["b"])
    paged.write_token(seq_id, torch.stack(k_all), torch.stack(v_all), pos)
    dec = params["decoder"]
    x = layer_norm(x, dec["ln_post"]["w"], dec["ln_post"]["b"])
    return project_to_vocab(params, x[:, 0, :])


def generate_paged(params: dict, enc_out: torch.Tensor, prompt,
                   paged: PagedKVCache, seq_id: int, eot: int,
                   config: ModelConfig, max_tokens: int = 448,
                   suppress_bias: Optional[torch.Tensor] = None,
                   compute_dtype: torch.dtype = torch.float32) -> List[int]:
    """Greedy decode of one sequence over the paged pools: the prompt
    token by token, then argmax (plus ``suppress_bias``) until EOT or
    ``max_tokens`` tokens; the sequence's pages are freed at the end."""
    cross_k, cross_v = precompute_cross_kv(params, enc_out.to(compute_dtype))
    cross_k, cross_v = cross_k[:, 0], cross_v[:, 0]
    paged.alloc(seq_id, n_tokens=0)
    tokens = [int(t) for t in prompt]
    try:
        for pos, t in enumerate(tokens):
            logits = paged_decode_step(params, t, pos, paged, seq_id,
                                       cross_k, cross_v, config,
                                       compute_dtype)
        while len(tokens) < max_tokens:
            biased = logits[0]
            if suppress_bias is not None:
                biased = biased + suppress_bias
            nxt = int(torch.argmax(biased))
            tokens.append(nxt)
            if nxt == eot:
                break
            logits = paged_decode_step(params, nxt, len(tokens) - 1, paged,
                                       seq_id, cross_k, cross_v, config,
                                       compute_dtype)
    finally:
        paged.free(seq_id)
    return tokens
