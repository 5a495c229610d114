"""Whisper audio encoder: port of ``whisper_apr_tpu/model/encoder.py``.

Conv stem as two GEMMs (the k=3 taps stitched with slices into a
``[B, T_out, 3*C_in]`` operand), then pre-norm transformer blocks over the
stacked layer params, then LayerNorm. Plain PyTorch, as the JAX package
leaves this work to XLA, except for the self-attention with ``use_flash``:
the flash kernel K16 (``ops/flash_attention.mha_flash``), once per layer.

Input is frame-major mel ``[B, n_frames, n_mels]``; output
``[B, n_frames // 2, d_model]``.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig
from ..ops import flash_attention as fa
from ..ops.basic import gelu, layer_norm, linear, mha
from ..ops.tp import local_config, require_unsharded
from .params import layer_slice


def conv_stem(mel: torch.Tensor, conv1: dict, conv2: dict) -> torch.Tensor:
    """conv1: n_mels->d, k=3, stride 1, pad 1, GELU; conv2: d->d, k=3,
    stride 2, pad 1, GELU. mel [B, T, n_mels] -> [B, T//2, d]. Weights in
    HF's [out, in, k]."""
    def conv1d_gemm(x, w, b, stride):
        B, T, C = x.shape
        xp = torch.nn.functional.pad(x, (0, 0, 1, 1))
        if stride == 1:
            taps = [xp[:, j: j + T] for j in range(3)]
        else:
            t_out = T // 2
            taps = [xp[:, j: j + 2 * t_out - 1: 2] for j in range(3)]
        x3 = torch.cat(taps, dim=-1)                   # [B, T_out, 3C]
        # w [C_out, C_in, K] -> [K, C_in, C_out] -> [3*C_in, C_out]
        kernel = w.permute(2, 1, 0).reshape(3 * C, -1)
        y = torch.matmul(x3, kernel.to(x.dtype))
        return y + b.to(x.dtype)

    x = gelu(conv1d_gemm(mel, conv1["w"], conv1["b"], 1))
    return gelu(conv1d_gemm(x, conv2["w"], conv2["b"], 2))


def encoder_block(x: torch.Tensor, blk: dict, layer: int,
                  n_heads: int, use_flash: bool = False) -> torch.Tensor:
    """One pre-norm encoder block; ``blk`` is the stacked block tree.
    ``use_flash`` takes the self-attention through K16 (the flash
    kernel's arithmetic, not ``mha``'s: see ``ops/flash_attention``)."""
    b = layer_slice(blk, layer)
    h = layer_norm(x, b["ln1"]["w"], b["ln1"]["b"])
    a = b["attn"]
    q = linear(h, a["q_w"], a["q_b"])
    k = linear(h, a["k_w"], a["k_b"])
    v = linear(h, a["v_w"], a["v_b"])
    attn = fa.mha_flash(q, k, v, n_heads) if use_flash \
        else mha(q, k, v, n_heads)
    x = x + linear(attn, a["o_w"], a["o_b"])
    h = layer_norm(x, b["ln2"]["w"], b["ln2"]["b"])
    h = linear(gelu(linear(h, b["fc1"]["w"], b["fc1"]["b"])),
               b["fc2"]["w"], b["fc2"]["b"])
    return x + h


def encode(params: dict, mel: torch.Tensor, config: ModelConfig,
           compute_dtype: torch.dtype = torch.float32,
           use_flash: bool = False) -> torch.Tensor:
    """Full encoder forward: conv stem -> +sinusoidal pos emb -> blocks ->
    LN. mel [B, n_frames, n_mels] -> [B, n_frames//2, d_model].

    Over a tp-sharded tree (``parallel/mesh.shard_params``) each rank runs
    its heads and hidden units (``ops/tp``): the output projection and
    fc2 sum over tp, and the LayerNorms act on the summed rows. K16 takes
    no sharded tree."""
    if use_flash:
        require_unsharded(params, "the flash encoder (K16)")
    config = local_config(params, config)
    enc = params["encoder"]
    mel = mel.to(compute_dtype)
    x = conv_stem(mel, enc["conv1"], enc["conv2"])
    x = x + enc["pos_emb"][None, : x.shape[1], :].to(compute_dtype)
    for layer in range(config.n_audio_layer):
        x = encoder_block(x, enc["blocks"], layer, config.n_audio_head,
                          use_flash)
    return layer_norm(x, enc["ln_post"]["w"], enc["ln_post"]["b"])
