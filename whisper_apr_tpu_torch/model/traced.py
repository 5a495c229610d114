"""Debug/introspection forwards: per-stage norms + attention-weight output.

Port of ``whisper_apr_tpu/model/traced.py`` (reference: Decoder::
forward_traced at src/model/decoder.rs:1655 — L2 norms per stage — and the
attention-weight output mode the word-timestamp aligner needs,
src/timestamps/alignment.rs:223).

Plain PyTorch over ``ops/basic`` and ``params.layer_slice``, a Python loop
over the layers so that per-layer tensors can be returned: a debug path,
as in the JAX package, not the decode path, and no kernel runs in it.
Mixed dtypes promote as they do in JAX (an f32 query over bf16 encoder
K/V scores in f32).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ..config import ModelConfig
from ..ops.basic import gelu, layer_norm, linear, softmax
from .decoder import check_tokens, embed, project_to_vocab
from .params import layer_slice

_F32_MIN = torch.finfo(torch.float32).min


def _mha_with_weights(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      n_heads: int, mask=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ops.basic.mha`` that also returns the attention weights
    [B, H, Tq, Tk] (in the scores' dtype)."""
    B, Tq, D = q.shape
    Tk = k.shape[1]
    hd = D // n_heads
    dt = torch.promote_types(q.dtype, k.dtype)
    qh = q.to(dt).reshape(B, Tq, n_heads, hd) * (hd ** -0.5)
    kh = k.to(dt).reshape(B, Tk, n_heads, hd)
    vh = v.reshape(B, Tk, n_heads, hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", qh, kh)
    if mask is not None:
        scores = torch.where(mask, scores, _F32_MIN)
    weights = softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.to(vh.dtype), vh)
    return out.reshape(B, Tq, D), weights


def _l2(t: torch.Tensor) -> float:
    return float(torch.sqrt(torch.sum(t.float() ** 2)))


def decoder_forward_traced(params: dict, tokens: torch.Tensor,
                           enc_out: torch.Tensor, config: ModelConfig
                           ) -> Tuple[torch.Tensor, Dict[str, List[float]],
                                      torch.Tensor]:
    """Teacher-forced forward returning (logits [B, T, V], per-stage L2
    norms, cross-attention weights [L, B, H, T_text, T_audio]).

    tokens [B, T] (ids checked on the host), enc_out [B, S, D] on the
    same device. The weights of every layer are kept: L·B·H·T·S floats.
    """
    check_tokens(tokens, config.n_vocab)
    T = tokens.shape[1]
    x = embed(params, tokens, 0)
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                   device=x.device))[None, None]
    n_heads = config.n_text_head
    blocks = params["decoder"]["blocks"]

    norms: Dict[str, List[float]] = {"self_attn": [], "cross_attn": [],
                                     "ffn": []}
    cross_weights = []
    for i in range(config.n_text_layer):
        blk = layer_slice(blocks, i)
        h = layer_norm(x, blk["ln1"]["w"], blk["ln1"]["b"])
        sa = blk["self_attn"]
        attn, _ = _mha_with_weights(
            linear(h, sa["q_w"], sa["q_b"]), linear(h, sa["k_w"], sa["k_b"]),
            linear(h, sa["v_w"], sa["v_b"]), n_heads, causal)
        x = x + linear(attn, sa["o_w"], sa["o_b"])
        norms["self_attn"].append(_l2(x))

        h = layer_norm(x, blk["ln2"]["w"], blk["ln2"]["b"])
        ca = blk["cross_attn"]
        attn, w = _mha_with_weights(
            linear(h, ca["q_w"], ca["q_b"]),
            linear(enc_out, ca["k_w"], ca["k_b"]),
            linear(enc_out, ca["v_w"], ca["v_b"]), n_heads)
        cross_weights.append(w)
        x = x + linear(attn, ca["o_w"], ca["o_b"])
        norms["cross_attn"].append(_l2(x))

        h = layer_norm(x, blk["ln3"]["w"], blk["ln3"]["b"])
        h = linear(gelu(linear(h, blk["fc1"]["w"], blk["fc1"]["b"])),
                   blk["fc2"]["w"], blk["fc2"]["b"])
        x = x + h
        norms["ffn"].append(_l2(x))

    dec = params["decoder"]
    x = layer_norm(x, dec["ln_post"]["w"], dec["ln_post"]["b"])
    return project_to_vocab(params, x), norms, torch.stack(cross_weights)


def encoder_forward_traced(params: dict, mel: torch.Tensor,
                           config: ModelConfig
                           ) -> Tuple[torch.Tensor, List[Dict[str, float]]]:
    """Encoder forward emitting per-layer activation/attention metrics:
    ``(enc_out, metrics)``, ``metrics[i]`` the block output's mean and
    max |activation| and the self-attention entropy of layer ``i`` (the
    data of the reference's TUI encoder panel, src/tui/app.rs:96).
    mel [B, n_frames, n_mels]."""
    from .encoder import conv_stem

    enc = params["encoder"]
    x = conv_stem(mel.float(), enc["conv1"], enc["conv2"])
    x = x + enc["pos_emb"][None, : x.shape[1], :].to(x.dtype)
    n_heads = config.n_audio_head

    metrics: List[Dict[str, float]] = []
    for i in range(config.n_audio_layer):
        blk = layer_slice(enc["blocks"], i)
        h = layer_norm(x, blk["ln1"]["w"], blk["ln1"]["b"])
        a = blk["attn"]
        attn, w = _mha_with_weights(
            linear(h, a["q_w"], a["q_b"]), linear(h, a["k_w"], a["k_b"]),
            linear(h, a["v_w"], a["v_b"]), n_heads)
        x = x + linear(attn, a["o_w"], a["o_b"])
        h = layer_norm(x, blk["ln2"]["w"], blk["ln2"]["b"])
        h = linear(gelu(linear(h, blk["fc1"]["w"], blk["fc1"]["b"])),
                   blk["fc2"]["w"], blk["fc2"]["b"])
        x = x + h
        w = torch.clamp(w.float(), 1e-12, 1.0)
        metrics.append({
            "layer": i,
            "mean_activation": float(torch.mean(torch.abs(x))),
            "max_activation": float(torch.max(torch.abs(x))),
            "attention_entropy": float(
                torch.mean(-torch.sum(w * torch.log(w), dim=-1))),
        })
    out = layer_norm(x, enc["ln_post"]["w"], enc["ln_post"]["b"])
    return out, metrics
