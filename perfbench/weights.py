"""Seeded weights of a Whisper configuration, drawn on the device.

One ``torch.Generator`` on the device, seeded from ``--seed``, draws every
tensor in a fixed order, one call per stacked tensor, so the same seed on
the same device gives the same bytes, and the reference redraws exactly
what the program was given. Matmul weights are int8 values uniform on
[-127, 127] with per-output-channel f32 scales, input-major and stacked
over layers: ``(q [L, K, N] int8, scale [L, 1, N] f32)``, the form the
port's int8 loader keeps. The token embedding is ``(q [V, D] int8, scale
[1, D] f32)``, its ``eot`` row zero. Everything else is f32. The names are
the benchmark's own; ``port.port_params`` and the reference each read
them.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .spec import Dims

Q_STD = math.sqrt((255 ** 2 - 1) / 12)    # std of uniform ints on [-127, 127]
INIT_STD = 0.02     # HF's init_std: v, o, fc1, fc2, the embeddings
QK_STD = 0.065      # q and k projections
CONV_STD = 0.05     # the conv stem
BIAS_STD = 0.002    # biases and LayerNorm shifts


def draw(dims: Dims, seed: int, device) -> Dict[str, object]:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & (2 ** 63 - 1))
    f32 = dict(dtype=torch.float32, device=device)

    def normal(*shape, std=INIT_STD, mean=0.0):
        return torch.randn(*shape, generator=g, **f32) * std + mean

    def qlin(L, K, N, std=INIT_STD):
        q = torch.randint(-127, 128, (L, K, N), generator=g, device=device,
                          dtype=torch.int8)
        s = (std / Q_STD) * (0.75 + 0.5 * torch.rand(
            (L, 1, N), generator=g, **f32))
        return q, s

    D, F, M = dims.d_model, dims.ffn, dims.n_mels
    w: Dict[str, object] = {
        "enc.conv1.w": normal(D, M, 3, std=CONV_STD),
        "enc.conv1.b": normal(D, std=BIAS_STD),
        "enc.conv2.w": normal(D, D, 3, std=CONV_STD),
        "enc.conv2.b": normal(D, std=BIAS_STD),
    }

    def block(prefix, L, attns):
        w[f"{prefix}.ln1.w"] = normal(L, D, std=0.1, mean=1.0)
        w[f"{prefix}.ln1.b"] = normal(L, D, std=BIAS_STD)
        for i, a in enumerate(attns):
            if i:
                w[f"{prefix}.ln{i + 1}.w"] = normal(L, D, std=0.1, mean=1.0)
                w[f"{prefix}.ln{i + 1}.b"] = normal(L, D, std=BIAS_STD)
            for p in "qkvo":
                w[f"{prefix}.{a}.{p}"] = qlin(L, D, D, QK_STD if p in "qk"
                                              else INIT_STD)
                w[f"{prefix}.{a}.{p}.b"] = (torch.zeros(L, D, **f32)
                                            if p == "k" else
                                            normal(L, D, std=BIAS_STD))
        n = len(attns) + 1
        w[f"{prefix}.ln{n}.w"] = normal(L, D, std=0.1, mean=1.0)
        w[f"{prefix}.ln{n}.b"] = normal(L, D, std=BIAS_STD)
        w[f"{prefix}.fc1"] = qlin(L, D, F)
        w[f"{prefix}.fc1.b"] = normal(L, F, std=BIAS_STD)
        w[f"{prefix}.fc2"] = qlin(L, F, D)
        w[f"{prefix}.fc2.b"] = normal(L, D, std=BIAS_STD)

    block("enc", dims.encoder_layers, ["attn"])
    w["enc.ln_post.w"] = normal(D, std=0.1, mean=1.0)
    w["enc.ln_post.b"] = normal(D, std=BIAS_STD)
    tq = torch.randint(-127, 128, (dims.vocab, D), generator=g,
                       device=device, dtype=torch.int8)
    tq[dims.eot] = 0
    ts = (INIT_STD / Q_STD) * (0.75 + 0.5 * torch.rand((1, D), generator=g,
                                                        **f32))
    w["dec.tok"] = (tq, ts)
    w["dec.pos"] = normal(dims.n_text_ctx, D)
    block("dec", dims.decoder_layers, ["self", "cross"])
    w["dec.ln_post.w"] = normal(D, std=0.1, mean=1.0)
    w["dec.ln_post.b"] = normal(D, std=BIAS_STD)
    return w


def sinusoids(length: int, channels: int) -> torch.Tensor:
    """Whisper's sinusoidal encoder positions [length, channels], f32."""
    log_timescale = math.log(10_000.0) / (channels // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(channels // 2,
                                                  dtype=torch.float64))
    t = torch.arange(length, dtype=torch.float64)[:, None] * inv[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1).float()
