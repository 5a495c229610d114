"""Transcription pipeline: mel -> encoder -> greedy decode, and serving
admission.

Port of ``whisper_apr_tpu/pipeline.py``. The JAX package fuses each of
``fused_transcribe_step`` and ``fused_admit_step`` into one compiled
program; here they are plain functions that run their stages eagerly on
the device of their inputs, with the same arguments and the same results.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .audio.mel import log_mel_body
from .config import HOP_LENGTH, N_FFT, ModelConfig
from .model.decoder import (DecodeResult, KVCache, greedy_generate_body,
                            init_cache, prefill)
from .model.encoder import encode
from .utils.trace import trace_span


def _batch_mel(audio: torch.Tensor, window: torch.Tensor,
               basis: torch.Tensor, filters_t: torch.Tensor,
               config: ModelConfig) -> torch.Tensor:
    """Log-mel per item (per-item normalization), frames padded with -1.0
    (or cut) to 2 * n_audio_ctx: audio [B, n] -> [B, frames, n_mels]."""
    n_frames_target = 2 * config.n_audio_ctx
    mel = torch.stack([log_mel_body(a, window, basis, filters_t, N_FFT,
                                    HOP_LENGTH) for a in audio])
    pad = n_frames_target - mel.shape[1]
    if pad > 0:
        mel = torch.cat([mel, torch.full((mel.shape[0], pad, mel.shape[2]),
                                         -1.0, dtype=mel.dtype,
                                         device=mel.device)], dim=1)
    return mel[:, :n_frames_target]


def fused_transcribe_step(params: dict, audio: torch.Tensor,
                          window: torch.Tensor, basis: torch.Tensor,
                          filters_t: torch.Tensor, prompt: torch.Tensor,
                          suppress_bias: torch.Tensor, eot: int,
                          config: ModelConfig, max_len: int,
                          prompt_len: int,
                          compute_dtype: torch.dtype = torch.float32,
                          timestamp_base: int = -1,
                          no_speech: int = -1,
                          qd: Optional[dict] = None,
                          qf_mode: Optional[str] = None,
                          use_flash: bool = False) -> DecodeResult:
    """audio [B, n_samples] (pre-padded to a full window) -> DecodeResult.

    Log-mel per item (per-item normalization), frames padded to
    2 * n_audio_ctx with -1.0, encoder, then the greedy decode of
    ``decoder.greedy_generate_body``: the fused step with the fused head
    (``qd`` and ``qf_mode``), with the logits tail and the timestamp rules
    (``timestamp_base`` >= 0), the scan step (``qd`` with ``qf_mode``
    None) or the plain step (no ``qd``). The JAX
    step's ``fidelity`` (HIGHEST matmul precision) has no argument here:
    f32 matmuls are full f32 while TF32 is off, PyTorch's default.
    ``use_flash`` runs the encoder's self-attention through K16.
    """
    with trace_span("mel"):
        mel = _batch_mel(audio, window, basis, filters_t, config)
    with trace_span("encode"):
        enc = encode(params, mel, config, compute_dtype, use_flash)
    return greedy_generate_body(
        params, enc, prompt, suppress_bias, eot, config, max_len=max_len,
        prompt_len=prompt_len, compute_dtype=compute_dtype,
        timestamp_base=timestamp_base, no_speech=no_speech, qd=qd,
        qf_mode=qf_mode)


def pad_audio_batch(audios, n_samples: int) -> np.ndarray:
    """Host-side: pad/truncate each clip to ``n_samples`` and stack [B, N]."""
    out = np.zeros((len(audios), n_samples), dtype=np.float32)
    for i, a in enumerate(audios):
        a = np.asarray(a, dtype=np.float32)
        n = min(len(a), n_samples)
        out[i, :n] = a[:n]
    return out


def fused_admit_step(params: dict, audio: torch.Tensor, window: torch.Tensor,
                     basis: torch.Tensor, filters_t: torch.Tensor,
                     prompt: torch.Tensor, suppress_bias: torch.Tensor,
                     config: ModelConfig,
                     compute_dtype: torch.dtype = torch.float32,
                     use_flash: bool = False
                     ) -> Tuple[torch.Tensor, KVCache]:
    """Batched serving admission: log-mel -> encoder -> cross K/V ->
    prompt prefill -> suppressed first-token argmax, in plain torch.

    audio [n, n_samples] pre-padded; prompt [n, P] (equal lengths).
    Returns (first_token [n] int32, KVCache with self K/V [L, n, P, D]
    holding exactly the prompt rows and cross K/V [L, n, S, D]).
    ``use_flash`` runs the encoder's self-attention through K16.
    """
    with trace_span("mel"):
        mel = _batch_mel(audio, window, basis, filters_t, config)
    with trace_span("encode"):
        enc = encode(params, mel, config, compute_dtype, use_flash)
    cache = init_cache(params, enc, config, max_len=prompt.shape[1],
                       compute_dtype=compute_dtype)
    logits, cache = prefill(params, prompt, enc, cache, config,
                            compute_dtype=compute_dtype)
    first = torch.argmax(logits + suppress_bias[None, :], dim=-1)
    return first.to(torch.int32), cache
