"""Beam search: port of ``whisper_apr_tpu/inference/beam.py``.

Beams are a flattened batch dimension ``B*K`` sharing one KV cache; each
step takes the top K of the ``K*V`` joint candidate scores per item, and
reordering the beams is a gather over the beam axis of the self cache
(into a new tensor, then copied back in place: the source rows overlap
the destination). Finished beams continue in place, forced to extend with
EOT at zero log-prob, so their score freezes. The final pick maximizes
the normalized score ``score / len^length_penalty``; a patience rule
stops an item early. The cross cache is not reordered: the beams of one
item share the same cross K/V.

The step is picked as ``decoder.logits_step`` picks it: the fused step
with the logits tail (K1-K3 + K8 at B*K = 1, K5-K7 + K8 above), the scan
step ``decode_step_q`` (K8 + K9), or the plain ``decode_step``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import ModelConfig
from ..model.decoder import (DecodeResult, _no_speech_prob, init_cache,
                             logits_step, prefill)

NEG = -1e30


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top k along the last axis, ties to the lower index
    (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def beam_generate(params: dict, enc_out: torch.Tensor, prompt: torch.Tensor,
                  suppress_bias: torch.Tensor, eot: int, config: ModelConfig,
                  beam_size: int = 5, patience: float = 1.0,
                  max_len: int = 448, prompt_len: int = 4,
                  length_penalty: float = 1.0,
                  compute_dtype: torch.dtype = torch.float32,
                  return_nbest: bool = False, no_speech: int = -1,
                  qd: Optional[dict] = None,
                  qf_mode: Optional[str] = None) -> DecodeResult:
    """Batched beam search. Returns a DecodeResult for the best hypothesis
    per item (sum_logprob = the winning beam's raw cumulative score), or
    per-beam [B, K, ...] results sorted by normalized score with
    ``return_nbest``.

    Patience: an item stops when its best COMPLETED normalized score
    exceeds its worst ACTIVE candidate's normalized score times
    ``patience``. One host sync per step (whether every beam is done).
    """
    from ..model.qdecode import quantize_cache

    B = enc_out.shape[0]
    K = beam_size
    V = config.n_vocab
    device = enc_out.device
    enc_rep = enc_out.repeat_interleave(K, dim=0)            # [B*K, S, D]
    prompt_rep = prompt.repeat_interleave(K, dim=0)
    cache = init_cache(params, enc_rep, config, max_len,
                       compute_dtype=compute_dtype)
    logits_all, cache = prefill(params, prompt_rep, enc_rep, cache, config,
                                compute_dtype, all_logits=True)
    # no-speech probability from beam 0 of each item (all beams alike here)
    ns_prob = _no_speech_prob(
        logits_all.reshape(B, K, prompt_len, -1)[:, 0], no_speech)
    use_qf, step = logits_step(params, qd, qf_mode, B * K, config,
                               compute_dtype, enc_out.shape[1])
    if use_qf:
        cache = quantize_cache(cache, mode=qf_mode)
    self_rows = [c for c in cache[:4 if use_qf else 2] if c is not None]
    bias = suppress_bias[None, :].float()

    logp = torch.log_softmax(logits_all[:, -1, :].float() + bias, dim=-1)
    logp = logp.reshape(B, K, V)
    # all beams are identical after the prefill: keep beam 0 so that the
    # first top-k picks K distinct tokens
    beam_mask = torch.where(torch.arange(K, device=device) == 0, 0.0, NEG)
    top_scores, top_idx = _top_k((logp + beam_mask[None, :, None]).reshape(
        B, K * V), K)
    first_tokens = (top_idx % V).to(torch.int32)              # [B, K]

    tokens = torch.full((B, K, max_len), eot, dtype=torch.int32,
                        device=device)
    tokens[:, :, :prompt_len] = prompt_rep.reshape(B, K, prompt_len).to(
        torch.int32)
    tokens[:, :, prompt_len] = first_tokens
    scores = top_scores                                       # [B, K]
    done = first_tokens == eot
    # total hypothesis length (prompt + generated incl. EOT) at finish
    # time; 0 = still active (resolved to the loop-exit length afterwards)
    fin_len = torch.where(done, prompt_len + 1, 0).to(torch.int32)
    ids = torch.arange(V, device=device)
    eot_onehot = torch.where(ids == eot, 0.0, NEG)[None, None, :]
    item_base = (K * torch.arange(B, device=device))[:, None]

    pos = prompt_len
    while pos + 1 < max_len and not bool(done.all()):
        tok = tokens[:, :, pos].reshape(-1)
        logits, _ = step(token=tok, pos=pos, cache=cache)
        logp = torch.log_softmax(logits.float() + bias,
                                 dim=-1).reshape(B, K, V)
        # finished beams may only emit EOT, at zero cost (score frozen)
        logp = torch.where(done[:, :, None], eot_onehot, logp)
        cand = scores[:, :, None] + logp                      # [B, K, V]
        new_scores, top_idx = _top_k(cand.reshape(B, K * V), K)
        src_beam = top_idx // V                               # [B, K]
        new_tok = (top_idx % V).to(torch.int32)

        # reorder the beam-major state by src_beam
        tokens = tokens.gather(1, src_beam[:, :, None].expand(-1, -1,
                                                              max_len))
        was_done = done.gather(1, src_beam)
        fin_len = fin_len.gather(1, src_beam)
        flat = (item_base + src_beam).reshape(-1)
        for c in self_rows:            # [L, B*K, T, ...]: gather, then copy
            c.copy_(c.index_select(1, flat))

        tokens[:, :, pos + 1] = new_tok
        done = was_done | (new_tok == eot)
        fin_len = torch.where(~was_done & done, pos + 2, fin_len).to(
            torch.int32)

        # patience early stop: forced-stopped active beams keep their
        # current length
        lens_f = torch.where(done, fin_len, pos + 2).float()
        norm = new_scores / torch.pow(lens_f, length_penalty)
        best_completed = torch.where(done, norm, NEG).amax(dim=1)
        worst_active = torch.where(done, -NEG, norm).amin(dim=1)
        stop = (done.any(dim=1) & (~done).any(dim=1)
                & (best_completed > worst_active * patience))
        newly_stopped = stop[:, None] & ~done
        fin_len = torch.where(newly_stopped, pos + 2, fin_len).to(
            torch.int32)
        done = done | stop[:, None]
        scores = new_scores
        pos += 1

    # active beams at loop exit: their current total length (no EOT)
    lengths = torch.where(fin_len > 0, fin_len, pos + 1).to(torch.int32)
    norm = scores / torch.pow(lengths.float(), length_penalty)
    if return_nbest:
        order = torch.argsort(-norm, dim=1, stable=True)
        tokens = tokens.gather(1, order[:, :, None].expand(-1, -1, max_len))
        return DecodeResult(tokens, lengths.gather(1, order),
                            scores.gather(1, order), ns_prob.float())
    best = torch.argmax(norm, dim=1)[:, None]                 # [B, 1]
    tokens = tokens.gather(1, best[:, :, None].expand(-1, -1, max_len))[:, 0]
    return DecodeResult(tokens, lengths.gather(1, best)[:, 0],
                        scores.gather(1, best)[:, 0], ns_prob.float())
