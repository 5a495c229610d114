"""Temperature sampling and the quality gates of temperature fallback:
port of ``whisper_apr_tpu/inference/sampling.py``.

``sample_generate`` is the greedy loop of ``model/decoder.py`` with a
sampled pick: temperature, top-k and top-p over the suppressed logits,
the chosen token's log-prob taken from the UNSCALED biased logits.
Randomness comes from an explicit ``torch.Generator`` on the decode's
device (Gumbel-max over the candidate logits), so a seed gives the same
tokens twice, but not the JAX package's ``jax.random`` draws.

The host gates (``compression_ratio``, ``avg_logprob``,
``token_entropy``, ``needs_fallback``, ``is_silence``) are copied from
the JAX module.
"""

from __future__ import annotations

import zlib
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..model.decoder import (DecodeResult, _no_speech_prob, chosen_logprob,
                             decode_loop, hold_done, init_cache, logits_step,
                             prefill)


def candidates(logits: torch.Tensor, temperature: float,
               top_k: Optional[int], top_p: Optional[float]) -> torch.Tensor:
    """The logits scaled by 1 / temperature with -inf outside the
    top-k / top-p candidate set (temperature > 0)."""
    scaled = logits / temperature
    ninf = float("-inf")
    if top_k is not None and top_k > 0:
        kth = torch.sort(scaled, dim=-1).values[:, -top_k][:, None]
        scaled = torch.where(scaled >= kth, scaled, ninf)
    if top_p is not None and 0.0 < top_p < 1.0:
        sorted_ = torch.sort(scaled, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_, dim=-1), dim=-1)
        # smallest set with cumulative probability >= top_p
        cutoff_idx = torch.argmax((cum >= top_p).to(torch.int32), dim=-1)
        cutoff = sorted_.gather(1, cutoff_idx[:, None])
        scaled = torch.where(scaled >= cutoff, scaled, ninf)
    return scaled


def _pick(logits: torch.Tensor, gen: Optional[torch.Generator],
          temperature: float, top_k: Optional[int], top_p: Optional[float]
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Next token per row of the biased logits [B, V]: (token [B] int32,
    its log-prob [B] under the unscaled biased logits)."""
    if temperature <= 0.0:
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return tok, chosen_logprob(logits, tok)
    scaled = candidates(logits, temperature, top_k, top_p)
    u = torch.rand(scaled.shape, generator=gen, device=scaled.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    tok = torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)
    return tok, chosen_logprob(logits, tok)


def sample_generate(params: dict, enc_out: torch.Tensor,
                    prompt: torch.Tensor, suppress_bias: torch.Tensor,
                    eot: int, generator: Optional[torch.Generator],
                    config: ModelConfig, max_len: int = 448,
                    prompt_len: int = 4, temperature: float = 1.0,
                    top_k: Optional[int] = None,
                    top_p: Optional[float] = None,
                    compute_dtype: torch.dtype = torch.float32,
                    no_speech: int = -1, qd: Optional[dict] = None,
                    qf_mode: Optional[str] = None) -> DecodeResult:
    """Sampled decode of B sequences. Returns a DecodeResult; sum_logprob
    covers the generated tokens (EOT included) and no_speech_prob is read
    at the SOT position. The step is picked as ``decoder.logits_step``
    picks it (the fused step with the logits tail K8 when ``qd`` and
    ``qf_mode`` allow, the scan step for a qd alone, the plain step
    without one). ``generator`` lives on ``enc_out``'s device."""
    from ..model.qdecode import quantize_cache

    B = enc_out.shape[0]
    use_qf, step = logits_step(params, qd, qf_mode, B, config, compute_dtype,
                               enc_out.shape[1])
    cache = init_cache(params, enc_out, config, max_len,
                       compute_dtype=compute_dtype)
    logits_all, cache = prefill(params, prompt, enc_out, cache, config,
                                compute_dtype, all_logits=True)
    if use_qf:
        cache = quantize_cache(cache, mode=qf_mode)
    ns_prob = _no_speech_prob(logits_all, no_speech)
    bias = suppress_bias[None, :].float()
    first, sum_lp = _pick(logits_all[:, -1, :] + bias, generator,
                          temperature, top_k, top_p)

    def next_tokens(tok, pos, done):
        logits, _ = step(token=tok, pos=pos, cache=cache)
        nxt, lp = _pick(logits + bias, generator, temperature, top_k, top_p)
        return hold_done(nxt, lp, done, eot)

    tokens, lengths, sum_lp = decode_loop(first, sum_lp, prompt, eot, config,
                                          max_len, prompt_len, next_tokens)
    return DecodeResult(tokens, lengths, sum_lp, ns_prob.float())


# ---------------------------------------------------------------------------
# Quality gates (whisper.cpp-parity fallback heuristics), host side
# ---------------------------------------------------------------------------

def compression_ratio(text: str) -> float:
    """zlib compression ratio; repetitive hallucinations compress
    extremely well."""
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / max(len(zlib.compress(data)), 1)


def avg_logprob(sum_logprob: float, n_tokens: int) -> float:
    return sum_logprob / max(n_tokens, 1)


def token_entropy(tokens, window: int = 32) -> float:
    """Shannon entropy of the token histogram over the last ``window``
    generated tokens (whisper.cpp's --entropy-thold signal: repetition
    loops collapse the distribution, driving entropy toward 0)."""
    tokens = list(tokens)[-window:]
    if not tokens:
        return 0.0
    counts = {}
    for t in tokens:
        counts[t] = counts.get(t, 0) + 1
    n = len(tokens)
    return -sum((c / n) * np.log(c / n) for c in counts.values())


def needs_fallback(text: str, avg_lp: float, n_tokens: int,
                   logprob_thold: float = -1.0,
                   compression_thold: float = 2.4,
                   entropy_thold: Optional[float] = None,
                   tokens=None,
                   no_speech_prob: float = 0.0,
                   no_speech_thold: Optional[float] = None) -> bool:
    """Retry at a higher temperature? (whisper.cpp's decision rule.)

    Fails on a compression ratio above its threshold (repetitive text),
    an average log-prob below its threshold (low confidence), or a token
    entropy below the entropy threshold (a repetition loop). Silence never
    retries: a no-speech probability above its threshold accepts the
    result as it is (OpenAI decode_with_fallback).
    """
    if no_speech_thold is not None and no_speech_prob > no_speech_thold:
        return False
    if n_tokens == 0:
        return True
    if compression_ratio(text) > compression_thold:
        return True
    if avg_lp < logprob_thold:
        return True
    if (entropy_thold is not None and tokens is not None
            and len(tokens) >= 32
            and token_entropy(tokens) < entropy_thold):
        return True
    return False


def is_silence(no_speech_prob: float, avg_lp: float,
               no_speech_thold: float = 0.6,
               logprob_thold: float = -1.0) -> bool:
    """OpenAI's segment-skip rule: no-speech mass high AND confidence
    low."""
    return no_speech_prob > no_speech_thold and avg_lp < logprob_thold


DEFAULT_TEMPERATURES = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)
