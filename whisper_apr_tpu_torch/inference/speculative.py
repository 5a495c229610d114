"""Speculative (self-drafting) greedy decode, one stream: port of
``whisper_apr_tpu/inference/speculative.py``.

A sequential decode reads every decoder weight once per token. Here a
cheap draft proposes ``k`` tokens, then one full forward over the
``k + 1`` positions verifies them, reading the weights once for all of
them. A draft token is accepted only while it equals the full model's
argmax, and the first mismatch is replaced by the full model's own
choice, so every emitted token is what plain greedy would emit.

The draft is the model's own first ``draft_layers`` decoder layers with
the final LayerNorm and the vocab head (early exit). Its K/V rows at
those layers equal the full model's (same weights, same inputs), so both
share one KV cache; the verify pass writes every layer's rows
``[pos, pos + k + 1)`` in place anyway.

The JAX package runs the rounds in a ``while_loop`` on the device. Here
they are a Python loop with host syncs (one per drafted token and one
per verify pass), like the port's greedy loop, over the plain
``block_step``, ``prefill`` and ``decode_step``: the JAX function runs
no Pallas kernel either. The draft and verify passes take a tp-sharded
tree (``ops/tp``) as the other plain steps do.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import ModelConfig
from ..model.decoder import (KVCache, _no_speech_prob, block_step,
                             check_tokens, chosen_logprob, decode_step, embed,
                             init_cache, prefill, project_to_vocab)
from ..model.params import layer_slice
from ..ops.basic import gelu, layer_norm, linear, mha
from ..ops.tp import local_config


def draft_step(params: dict, token: torch.Tensor, pos: int, cache: KVCache,
               config: ModelConfig, draft_layers: int,
               compute_dtype: torch.dtype = torch.float32):
    """Shallow decode step: the first ``draft_layers`` layers and the
    early-exit head. token [B] at ``pos`` -> (draft logits [B, V] f32,
    cache), the self rows at ``pos`` of those layers written in place
    (valid for the full model too)."""
    pos = int(pos)
    config = local_config(params, config)
    T = cache.self_k.shape[2]
    x = embed(params, token[:, None], pos, compute_dtype)
    valid = (torch.arange(T, device=x.device) <= pos)[None, None, None, :]
    blocks = params["decoder"]["blocks"]
    for l in range(draft_layers):
        x = block_step(x, layer_slice(blocks, l), cache.self_k[l],
                       cache.self_v[l], cache.cross_k[l], cache.cross_v[l],
                       (slice(None), pos), valid, config.n_text_head)
    dec = params["decoder"]
    x = layer_norm(x, dec["ln_post"]["w"], dec["ln_post"]["b"])
    return project_to_vocab(params, x[:, 0, :]), cache


def decode_chunk(params: dict, tokens: torch.Tensor, pos_start: int,
                 cache: KVCache, config: ModelConfig,
                 compute_dtype: torch.dtype = torch.float32):
    """Full forward over T tokens at positions [pos_start, pos_start + T)
    against the KV cache (the verify pass): tokens [B, T] -> (logits
    [B, T, V] f32, cache), every layer's self rows at those positions
    written in place; position pos_start + i attends the cache rows up
    to itself."""
    pos_start = int(pos_start)
    config = local_config(params, config)
    T = tokens.shape[1]
    x = embed(params, tokens, pos_start, compute_dtype)
    T_max = cache.self_k.shape[2]
    dev = x.device
    key_pos = torch.arange(T_max, device=dev)[None, :]
    qry_pos = pos_start + torch.arange(T, device=dev)[:, None]
    mask = (key_pos <= qry_pos)[None, None]                 # [1, 1, T, T_max]
    n_heads = config.n_text_head
    blocks = params["decoder"]["blocks"]
    for l in range(config.n_text_layer):
        b = layer_slice(blocks, l)
        h = layer_norm(x, b["ln1"]["w"], b["ln1"]["b"])
        sa = b["self_attn"]
        q = linear(h, sa["q_w"], sa["q_b"])
        k_c, v_c = cache.self_k[l], cache.self_v[l]
        k_c[:, pos_start: pos_start + T] = linear(
            h, sa["k_w"], sa["k_b"]).to(k_c.dtype)
        v_c[:, pos_start: pos_start + T] = linear(
            h, sa["v_w"], sa["v_b"]).to(v_c.dtype)
        x = x + linear(mha(q, k_c, v_c, n_heads, mask=mask), sa["o_w"],
                       sa["o_b"])
        h = layer_norm(x, b["ln2"]["w"], b["ln2"]["b"])
        ca = b["cross_attn"]
        q = linear(h, ca["q_w"], ca["q_b"])
        x = x + linear(mha(q, cache.cross_k[l], cache.cross_v[l], n_heads),
                       ca["o_w"], ca["o_b"])
        h = layer_norm(x, b["ln3"]["w"], b["ln3"]["b"])
        x = x + linear(gelu(linear(h, b["fc1"]["w"], b["fc1"]["b"])),
                       b["fc2"]["w"], b["fc2"]["b"])
    dec = params["decoder"]
    x = layer_norm(x, dec["ln_post"]["w"], dec["ln_post"]["b"])
    return project_to_vocab(params, x), cache


class SpecResult(NamedTuple):
    tokens: torch.Tensor          # [1, max_len] int32, EOT-padded
    lengths: torch.Tensor         # [1] int32
    n_verify_passes: int          # full-model forwards of the rounds
    n_accepted: int               # draft tokens accepted
    sum_logprob: torch.Tensor     # [1] f32: emitted tokens incl. EOT
    no_speech_prob: torch.Tensor  # [1] f32: at the SOT position


def speculative_greedy_generate(params: dict, enc_out: torch.Tensor,
                                prompt: torch.Tensor,
                                suppress_bias: torch.Tensor, eot: int,
                                config: ModelConfig, max_len: int = 448,
                                prompt_len: int = 4, draft_tokens: int = 4,
                                draft_layers: int = 1,
                                compute_dtype: torch.dtype = torch.float32,
                                no_speech: int = -1) -> SpecResult:
    """Single-stream (B = 1) speculative greedy decode; its tokens are
    ``greedy_generate``'s up to the first EOT. Each round drafts
    ``draft_tokens`` = k tokens, verifies them in one pass and emits
    between 1 and k + 1 (the accepted drafts and the full model's token
    after them), while ``pos + 1 < max_len - (k + 1)``; the rest of the
    window is decoded one token at a time by ``decode_step``. The JAX
    function's outputs: the EOT-padded buffer (a round that emits past an
    EOT writes those tokens, as the JAX one does), lengths up to and
    including the first EOT after the prompt, the rounds and the accepted
    drafts, the summed log-prob of the emitted tokens up to and including
    the first EOT, and the no-speech probability at SOT."""
    if enc_out.shape[0] != 1:
        raise ValueError("speculative decode is the single-stream path "
                         f"(B = 1), got B = {enc_out.shape[0]}")
    check_tokens(prompt, config.n_vocab)
    k = draft_tokens
    dev = enc_out.device
    cache = init_cache(params, enc_out, config, max_len,
                       compute_dtype=compute_dtype)
    logits_all, cache = prefill(params, prompt, enc_out, cache, config,
                                compute_dtype, all_logits=True)
    ns_prob = _no_speech_prob(logits_all, no_speech)
    bias = suppress_bias.float()[None, :]
    biased0 = logits_all[:, -1, :] + bias
    first = torch.argmax(biased0, dim=-1)
    sum_lp = chosen_logprob(biased0, first)[0]
    tokens = [eot] * max_len
    tokens[:prompt_len] = [int(t) for t in prompt[0].tolist()]
    tokens[prompt_len] = int(first)
    done = tokens[prompt_len] == eot

    def argmax1(logits) -> int:
        return int(torch.argmax(logits[0] + bias[0]))

    pos, n_ver, n_acc = prompt_len, 0, 0
    while pos + 1 < max_len - (k + 1) and not done:
        drafts = [tokens[pos]]
        for i in range(k):
            dl, _ = draft_step(params, torch.tensor([drafts[i]], device=dev),
                               pos + i, cache, config, draft_layers,
                               compute_dtype)
            drafts.append(argmax1(dl))
        v_logits, _ = decode_chunk(
            params, torch.tensor([drafts], device=dev), pos, cache, config,
            compute_dtype)
        v = v_logits[0] + bias                               # [k+1, V]
        best = torch.argmax(v, dim=-1)
        am = best.tolist()
        # accepted up to the first mismatch (argmin over match ++ [False])
        m = next((i for i in range(k) if drafts[i + 1] != am[i]), k)
        emit = am[: m + 1]
        tokens[pos + 1: pos + k + 2] = emit + [eot] * (k - m)
        # log-probs of the emitted tokens up to and including the first EOT
        n_lp = emit.index(eot) + 1 if eot in emit else m + 1
        lp = torch.log_softmax(v.float(), dim=-1)
        sum_lp = sum_lp + lp[torch.arange(n_lp, device=dev), best[:n_lp]].sum()
        done = eot in emit
        pos += 1 + m
        n_ver += 1
        n_acc += m

    # the tail: one token at a time to the end of the window
    while pos + 1 < max_len and not done:
        logits, _ = decode_step(params, torch.tensor([tokens[pos]], device=dev),
                                pos, cache, config, compute_dtype)
        biased = logits + bias
        nxt = torch.argmax(biased, dim=-1)
        sum_lp = sum_lp + chosen_logprob(biased, nxt)[0]
        tokens[pos + 1] = int(nxt)
        done = tokens[pos + 1] == eot
        pos += 1

    gen = tokens[prompt_len:]
    length = prompt_len + gen.index(eot) + 1 if eot in gen else max_len
    return SpecResult(
        torch.tensor([tokens], dtype=torch.int32, device=dev),
        torch.tensor([length], dtype=torch.int32, device=dev),
        n_ver, n_acc, sum_lp.float()[None], ns_prob.float())
