"""Whisper text decoder: port of ``whisper_apr_tpu/model/decoder.py``.

- KV caches are pre-allocated ``[L, B, T_max, D]`` tensors; the cross K/V
  are computed once from the encoder output.
- ``prefill`` runs the whole prompt in one plain-PyTorch forward and fills
  the self cache rows ``[0, T)``; ``decode_step`` is the plain f32 /
  unquantized single-token step (rows written in place) and
  ``decoder_forward`` the teacher-forced forward over every position.
- ``greedy_generate_body`` is a Python loop over steps for B sequences
  at one aligned position, with one host sync per step. Its step is, as
  in the JAX body: ``qdecode.decode_step_qf`` with the fused greedy head
  K4 (int8 weights and a ``quantize_cache`` mode, no timestamp rules);
  ``decode_step_qf`` with the logits tail K8 and the timestamp rules;
  ``qdecode.decode_step_q`` (kv_mode "scan": K8 and K9); or
  ``decode_step`` (no qd: f32 weights). On a CUDA device the kernels run,
  on the CPU their plain versions. Its outputs equal the JAX body's:
  EOT-padded tokens with the EOT appended (a finished row is held at EOT
  and adds 0 to its log-prob), lengths up to and including the first EOT
  after the prompt, the summed log-prob of the generated tokens, and the
  no-speech probability at SOT.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..config import ModelConfig
from ..errors import InferenceError
from ..ops.basic import causal_mask, gelu, layer_norm, linear, mha
from ..ops.quant import dequant, is_quantized
from ..ops.tp import is_shard, local_config, vocab_logits, vocab_lookup
from ..utils.trace import trace_span
from .params import layer_slice


class KVCache(NamedTuple):
    """self_k/self_v: [L, B, T_max, D]; cross_k/cross_v: [L, B, S, D]."""

    self_k: torch.Tensor
    self_v: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor


def precompute_cross_kv(params: dict, enc_out: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encoder K/V for every decoder layer: enc_out [B, S, D] ->
    (cross_k, cross_v) [L, B, S, D]."""
    ca = params["decoder"]["blocks"]["cross_attn"]
    L = ca["k_b"].shape[0]
    ks, vs = [], []
    for l in range(L):
        a = layer_slice(ca, l)
        ks.append(linear(enc_out, a["k_w"], a["k_b"]))
        vs.append(linear(enc_out, a["v_w"], a["v_b"]))
    return torch.stack(ks), torch.stack(vs)


def init_cache(params: dict, enc_out: torch.Tensor, config: ModelConfig,
               max_len: Optional[int] = None,
               compute_dtype: torch.dtype = torch.float32) -> KVCache:
    """Allocate the fixed-shape decode cache and fill the cross K/V (a tp
    rank's cache is its own width, ``D / tp``)."""
    config = local_config(params, config)
    max_len = max_len or config.n_text_ctx
    L, B = config.n_text_layer, enc_out.shape[0]
    D = config.n_text_state
    with trace_span("cross_kv"):
        ck, cv = precompute_cross_kv(params, enc_out.to(compute_dtype))
    z = dict(dtype=compute_dtype, device=enc_out.device)
    return KVCache(torch.zeros((L, B, max_len, D), **z),
                   torch.zeros((L, B, max_len, D), **z), ck, cv)


def check_tokens(tokens: torch.Tensor, n_vocab: int) -> None:
    """Token ids must index the embedding: torch raises (or, on a GPU,
    faults the context) on an out-of-range gather where XLA clamps, so
    ids are checked on the host first."""
    with trace_span("sync"):
        lo, hi = int(tokens.min()), int(tokens.max())
    if lo < 0 or hi >= n_vocab:
        raise InferenceError(
            f"token ids [{lo}, {hi}] out of range for n_vocab={n_vocab}")


def embed(params: dict, tokens: torch.Tensor, pos_start,
          compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Token + learned positional embedding: tokens [B, T] -> [B, T, D].
    ``pos_start`` is one int for every row, or per-row starts [B] (a
    tensor on the tokens' device). Callers validate the ids
    (:func:`check_tokens`). A vocab-split table looks its rows up over the
    tp group (``tp.vocab_lookup``)."""
    dec = params["decoder"]
    T = tokens.shape[-1]
    emb = dec["token_emb"]
    if is_shard(emb):
        tok = vocab_lookup(emb, tokens)
    elif is_quantized(emb):
        rows = emb.q[tokens]
        scale = emb.scale.to(compute_dtype)
        while scale.ndim > 1:
            scale = scale[0]
        tok = rows.to(compute_dtype) * scale
    else:
        tok = emb[tokens]
    if isinstance(pos_start, torch.Tensor):
        pos = dec["pos_emb"][pos_start.long()[:, None] + torch.arange(
            T, device=pos_start.device)]                        # [B, T, D]
    else:
        pos = dec["pos_emb"][pos_start: pos_start + T][None]
    return tok.to(compute_dtype) + pos.to(compute_dtype)


def project_to_vocab(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Weight-tied vocab projection, logits in f32 (a vocab-split table
    gathers every rank's columns: ``tp.vocab_logits``)."""
    if is_shard(params["decoder"]["token_emb"]):
        return vocab_logits(x, params["decoder"]["token_emb"])
    emb = dequant(params["decoder"]["token_emb"], x.dtype)
    return torch.matmul(x, emb.T).float()


def prefill(params: dict, tokens: torch.Tensor, enc_out: torch.Tensor,
            cache: KVCache, config: ModelConfig,
            compute_dtype: torch.dtype = torch.float32,
            all_logits: bool = False) -> Tuple[torch.Tensor, KVCache]:
    """Run the whole prompt in one forward, filling the self cache rows
    [0, T) in place. Returns (last-position logits [B, V], cache), or the
    logits of every prompt position [B, T, V] with ``all_logits``."""
    with trace_span("prefill"):
        return _prefill(params, tokens, enc_out, cache, config,
                        compute_dtype, all_logits)


def _prefill(params: dict, tokens: torch.Tensor, enc_out: torch.Tensor,
             cache: KVCache, config: ModelConfig, compute_dtype: torch.dtype,
             all_logits: bool) -> Tuple[torch.Tensor, KVCache]:
    check_tokens(tokens, config.n_vocab)
    config = local_config(params, config)
    B, T = tokens.shape
    x = embed(params, tokens, 0, compute_dtype)
    n_heads = config.n_text_head
    causal = causal_mask(T, device=x.device)
    blocks = params["decoder"]["blocks"]
    for l in range(config.n_text_layer):
        b = layer_slice(blocks, l)
        h = layer_norm(x, b["ln1"]["w"], b["ln1"]["b"])
        sa = b["self_attn"]
        q = linear(h, sa["q_w"], sa["q_b"])
        k = linear(h, sa["k_w"], sa["k_b"])
        v = linear(h, sa["v_w"], sa["v_b"])
        cache.self_k[l, :, :T] = k.to(cache.self_k.dtype)
        cache.self_v[l, :, :T] = v.to(cache.self_v.dtype)
        x = x + linear(mha(q, k, v, n_heads, mask=causal),
                       sa["o_w"], sa["o_b"])

        h = layer_norm(x, b["ln2"]["w"], b["ln2"]["b"])
        ca = b["cross_attn"]
        q = linear(h, ca["q_w"], ca["q_b"])
        x = x + linear(mha(q, cache.cross_k[l], cache.cross_v[l], n_heads),
                       ca["o_w"], ca["o_b"])

        h = layer_norm(x, b["ln3"]["w"], b["ln3"]["b"])
        h = linear(gelu(linear(h, b["fc1"]["w"], b["fc1"]["b"])),
                   b["fc2"]["w"], b["fc2"]["b"])
        x = x + h
    dec = params["decoder"]
    x = layer_norm(x, dec["ln_post"]["w"], dec["ln_post"]["b"])
    logits = project_to_vocab(params, x if all_logits else x[:, -1, :])
    return logits, cache


def block_step(x: torch.Tensor, b: dict, k_c: torch.Tensor,
               v_c: torch.Tensor, c_k: torch.Tensor, c_v: torch.Tensor,
               at, valid: torch.Tensor, n_heads: int) -> torch.Tensor:
    """One decoder block for ONE new token (the JAX ``_block_step`` and
    ``decode_step_multi`` body): x [B, 1, D]; ``b`` one layer's params;
    k_c/v_c that layer's self cache [B, T, D], whose rows at ``at`` (an
    index of (row, position)) take the new k/v in place before the
    attention over the rows ``valid`` [B or 1, 1, 1, T] marks; c_k/c_v the
    cross K/V [B, S, D]."""
    h = layer_norm(x, b["ln1"]["w"], b["ln1"]["b"])
    sa = b["self_attn"]
    q = linear(h, sa["q_w"], sa["q_b"])
    k_c[at] = linear(h, sa["k_w"], sa["k_b"])[:, 0].to(k_c.dtype)
    v_c[at] = linear(h, sa["v_w"], sa["v_b"])[:, 0].to(v_c.dtype)
    x = x + linear(mha(q, k_c, v_c, n_heads, mask=valid), sa["o_w"],
                   sa["o_b"])

    h = layer_norm(x, b["ln2"]["w"], b["ln2"]["b"])
    ca = b["cross_attn"]
    q = linear(h, ca["q_w"], ca["q_b"])
    x = x + linear(mha(q, c_k, c_v, n_heads), ca["o_w"], ca["o_b"])

    h = layer_norm(x, b["ln3"]["w"], b["ln3"]["b"])
    h = linear(gelu(linear(h, b["fc1"]["w"], b["fc1"]["b"])),
               b["fc2"]["w"], b["fc2"]["b"])
    return x + h


def decode_step(params: dict, token: torch.Tensor, pos: int,
                cache: KVCache, config: ModelConfig,
                compute_dtype: torch.dtype = torch.float32
                ) -> Tuple[torch.Tensor, KVCache]:
    """Single-token forward in plain torch (the f32 / unquantized step):
    token [B] at the host position ``pos`` -> (logits [B, V] f32, cache),
    the self rows at ``pos`` written in place. Callers validate the ids
    (:func:`check_tokens`)."""
    pos = int(pos)
    config = local_config(params, config)
    T = cache.self_k.shape[2]
    if not 0 <= pos < min(T, params["decoder"]["pos_emb"].shape[0]):
        raise ValueError(f"pos {pos} outside the self cache ({T} rows)")
    x = embed(params, token[:, None], pos, compute_dtype)       # [B, 1, D]
    valid = (torch.arange(T, device=x.device) <= pos)[None, None, None, :]
    blocks = params["decoder"]["blocks"]
    for l in range(config.n_text_layer):
        x = block_step(x, layer_slice(blocks, l), cache.self_k[l],
                       cache.self_v[l], cache.cross_k[l], cache.cross_v[l],
                       (slice(None), pos), valid, config.n_text_head)
    dec = params["decoder"]
    x = layer_norm(x, dec["ln_post"]["w"], dec["ln_post"]["b"])
    return project_to_vocab(params, x[:, 0, :]), cache


def decoder_forward(params: dict, tokens: torch.Tensor,
                    enc_out: torch.Tensor, config: ModelConfig,
                    compute_dtype: torch.dtype = torch.float32
                    ) -> torch.Tensor:
    """Teacher-forced forward over every position: tokens [B, T] ->
    logits [B, T, V] (the oracle of KV-cache correctness)."""
    check_tokens(tokens, config.n_vocab)
    config = local_config(params, config)
    T = tokens.shape[1]
    x = embed(params, tokens, 0, compute_dtype)
    enc_out = enc_out.to(compute_dtype)
    n_heads = config.n_text_head
    causal = causal_mask(T, device=x.device)
    blocks = params["decoder"]["blocks"]
    for l in range(config.n_text_layer):
        b = layer_slice(blocks, l)
        h = layer_norm(x, b["ln1"]["w"], b["ln1"]["b"])
        sa = b["self_attn"]
        q = linear(h, sa["q_w"], sa["q_b"])
        k = linear(h, sa["k_w"], sa["k_b"])
        v = linear(h, sa["v_w"], sa["v_b"])
        x = x + linear(mha(q, k, v, n_heads, mask=causal), sa["o_w"],
                       sa["o_b"])
        h = layer_norm(x, b["ln2"]["w"], b["ln2"]["b"])
        ca = b["cross_attn"]
        q = linear(h, ca["q_w"], ca["q_b"])
        k = linear(enc_out, ca["k_w"], ca["k_b"])
        v = linear(enc_out, ca["v_w"], ca["v_b"])
        x = x + linear(mha(q, k, v, n_heads), ca["o_w"], ca["o_b"])
        h = layer_norm(x, b["ln3"]["w"], b["ln3"]["b"])
        x = x + linear(gelu(linear(h, b["fc1"]["w"], b["fc1"]["b"])),
                       b["fc2"]["w"], b["fc2"]["b"])
    dec = params["decoder"]
    x = layer_norm(x, dec["ln_post"]["w"], dec["ln_post"]["b"])
    return project_to_vocab(params, x)


# ---------------------------------------------------------------------------
# Greedy generation
# ---------------------------------------------------------------------------

class DecodeResult(NamedTuple):
    """Decode output + the quality-gate signals.

    sum_logprob covers the generated tokens (EOT included, prompt
    excluded); no_speech_prob is the softmax mass on the NO_SPEECH token at
    the SOT position (zeros when no ``no_speech`` id was supplied).
    """

    tokens: torch.Tensor          # [B, max_len] int32, EOT padded
    lengths: torch.Tensor         # [B] int32, prompt + generated incl. EOT
    sum_logprob: torch.Tensor     # [B] f32
    no_speech_prob: torch.Tensor  # [B] f32


def _no_speech_prob(logits_all: torch.Tensor, no_speech: int
                    ) -> torch.Tensor:
    if no_speech < 0:
        return torch.zeros(logits_all.shape[0], dtype=torch.float32,
                           device=logits_all.device)
    probs = torch.softmax(logits_all[:, 0, :].float(), dim=-1)
    return probs[:, no_speech]


def chosen_logprob(biased_logits: torch.Tensor,
                   token: torch.Tensor) -> torch.Tensor:
    """Log-prob of the chosen token [B] under the distribution decoded
    from (log_softmax of the biased logits in f32)."""
    logp = torch.log_softmax(biased_logits.float(), dim=-1)
    return logp.gather(1, token[:, None].long())[:, 0]


def logits_step(params: dict, qd: Optional[dict], qf_mode: Optional[str],
                batch: int, config: ModelConfig,
                compute_dtype: torch.dtype, enc_len: int
                ) -> Tuple[bool, Callable]:
    """The per-token step of a decoder that reads the logits (greedy with
    timestamp rules or without qd, sampling, beam), picked as the JAX
    bodies pick it: no qd -> ``decode_step``; an int8 qd with a cache mode
    -> ``decode_step_qf`` with the logits tail (the caller quantizes the
    cache); a qd without one -> ``decode_step_q``. Returns (uses the
    fused step, ``step(token, pos, cache) -> (logits [B, V] f32, cache)``)
    with the cache rows written in place."""
    from .qdecode import decode_step_q, decode_step_qf, qf_supported
    if qd is None:
        return False, functools.partial(decode_step, params, config=config,
                                        compute_dtype=compute_dtype)
    if qf_mode and qf_supported(qd, batch):
        return True, functools.partial(decode_step_qf, params, qd,
                                       config=config,
                                       compute_dtype=compute_dtype,
                                       enc_len=enc_len)
    return False, functools.partial(decode_step_q, params, qd, config=config,
                                    compute_dtype=compute_dtype)


def decode_loop(first: torch.Tensor, sum_lp: torch.Tensor,
                prompt: torch.Tensor, eot: int, config: ModelConfig,
                max_len: int, prompt_len: int,
                next_tokens: Callable) -> Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """The host loop of the greedy and sampled decoders. From the first
    generated tokens ``first`` [B] (and their log-probs ``sum_lp``), call
    ``next_tokens(tok, pos, done) -> (nxt [B] int32, lp [B] f32)`` until
    every row has produced EOT or the length reaches ``max_len``;
    ``next_tokens`` holds a done row at EOT with lp 0 (:func:`hold_done`).
    One host sync per step (the new tokens). Returns (tokens [B, max_len]
    EOT-padded, lengths [B], sum_lp [B]) on the device of ``first``."""
    with trace_span("loop"):
        return _decode_loop(first, sum_lp, prompt, eot, config, max_len,
                            prompt_len, next_tokens)


def _decode_loop(first, sum_lp, prompt, eot, config, max_len, prompt_len,
                 next_tokens):
    device = first.device
    with trace_span("sync"):
        rows = [[int(t) for t in r] for r in prompt.tolist()]
        for r, t in zip(rows, first.tolist()):
            r.append(t)
    done = first == eot                                     # [B] device
    done_h = [r[-1] == eot for r in rows]
    tok = first
    pos = prompt_len
    while pos + 1 < max_len and not all(done_h):
        with trace_span("loop.step"):
            nxt, lp = next_tokens(tok, pos, done)
            sum_lp = sum_lp + lp
            done = done | (nxt == eot)
            with trace_span("sync"):
                new = nxt.tolist()        # the loop's one host sync
            bad = [t for t in new if not 0 <= t < config.n_vocab]
            if bad:
                raise InferenceError(f"decode produced tokens {bad} outside "
                                     f"n_vocab={config.n_vocab}")
            for r, t in zip(rows, new):
                r.append(t)
            done_h = [d or t == eot for d, t in zip(done_h, new)]
            tok = nxt
            pos += 1

    out = torch.full((len(rows), max_len), eot, dtype=torch.int32)
    lengths = []
    for i, r in enumerate(rows):
        r = r[:max_len]
        out[i, : len(r)] = torch.tensor(r, dtype=torch.int32)
        # length = first EOT after the prompt + 1, or max_len without one
        gen = r[prompt_len:]
        lengths.append(prompt_len + gen.index(eot) + 1 if eot in gen
                       else max_len)
    return (out.to(device),
            torch.tensor(lengths, dtype=torch.int32, device=device),
            sum_lp.float())


def hold_done(nxt: torch.Tensor, lp: torch.Tensor, done: torch.Tensor,
              eot: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A finished row's next token is EOT and adds 0 to its log-prob."""
    return (torch.where(done, torch.full_like(nxt, eot), nxt),
            torch.where(done, torch.zeros_like(lp), lp))


def greedy_generate_body(params: dict, enc_out: torch.Tensor,
                         prompt: torch.Tensor, suppress_bias: torch.Tensor,
                         eot: int, config: ModelConfig, max_len: int = 448,
                         prompt_len: int = 4,
                         compute_dtype: torch.dtype = torch.float32,
                         timestamp_base: int = -1, no_speech: int = -1,
                         qd: Optional[dict] = None,
                         qf_mode: Optional[str] = None) -> DecodeResult:
    """Greedy decode of B sequences (reference semantics: argmax until
    EOT, EOT appended, total length capped at ``max_len`` including the
    prompt, suppression applied to every step).

    prompt [B, prompt_len] int32; suppress_bias [V] f32 (0 or -inf).
    ``qd`` (``qdecode.prepare_qdecode``) with ``qf_mode`` (a
    ``quantize_cache`` mode) runs the fused per-block step, with the
    fused greedy head unless ``timestamp_base`` >= 0 turns on the
    timestamp rules (``inference/timestamp_rules.py``), which need the
    logits row; ``qd`` without ``qf_mode`` runs the scan step
    ``decode_step_q``; no ``qd`` the plain ``decode_step``.
    """
    from ..inference import timestamp_rules as tsr
    from .qdecode import quantize_cache

    B = enc_out.shape[0]
    device = enc_out.device
    use_ts = timestamp_base >= 0
    use_qf, step = logits_step(params, qd, qf_mode, B, config, compute_dtype,
                               enc_out.shape[1])
    fused_head = use_qf and not use_ts
    cache = init_cache(params, enc_out, config, max_len,
                       compute_dtype=compute_dtype)
    logits_all, cache = prefill(params, prompt, enc_out, cache, config,
                                compute_dtype, all_logits=True)
    if use_qf:
        cache = quantize_cache(cache, mode=qf_mode)
    ns_prob = _no_speech_prob(logits_all, no_speech)
    bias = suppress_bias[None, :].float()
    first_logits = logits_all[:, -1, :] + bias
    ts = None
    if use_ts:
        ts = tsr.init_state(B, device)
        first_logits = tsr.apply_rules(
            first_logits, ts, timestamp_base, eot,
            is_first=torch.ones(B, dtype=torch.bool, device=device))
    first = torch.argmax(first_logits, dim=-1).to(torch.int32)   # [B]
    sum_lp = chosen_logprob(first_logits, first)
    if use_ts:
        ts = tsr.update_state(ts, first, timestamp_base)
    not_first = torch.zeros(B, dtype=torch.bool, device=device)

    if fused_head:
        v_pad = qd["vocab_qT"].shape[2]
        gb = torch.zeros((1, v_pad), dtype=torch.float32, device=device)
        gb[0, : suppress_bias.shape[0]] = suppress_bias.float()

        def next_tokens(tok, pos, done):
            (nxt, mx, lz), _ = step(token=tok, pos=pos, cache=cache,
                                    greedy_bias=gb)
            return hold_done(nxt, mx - lz, done, eot)
    else:
        def next_tokens(tok, pos, done):
            nonlocal ts
            logits, _ = step(token=tok, pos=pos, cache=cache)
            biased = logits + bias
            if use_ts:
                biased = tsr.apply_rules(biased, ts, timestamp_base, eot,
                                         is_first=not_first)
            nxt = torch.argmax(biased, dim=-1).to(torch.int32)
            nxt, lp = hold_done(nxt, chosen_logprob(biased, nxt), done, eot)
            if use_ts:
                ts = tsr.update_state(ts, nxt, timestamp_base)
            return nxt, lp

    tokens, lengths, sum_lp = decode_loop(first, sum_lp, prompt, eot, config,
                                          max_len, prompt_len, next_tokens)
    return DecodeResult(tokens, lengths, sum_lp, ns_prob.float())
