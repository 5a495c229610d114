"""Roofline model: analytic floors of a decode step, an encode and a
whole transcription on one chip (port of the JAX package's
``utils/roofline.py``, the same formulas).

- **Device-memory bandwidth** bounds incremental decode: every step
  streams the decoder weights and the live KV rows.
- **Matrix throughput** bounds the encoder (large GEMMs over 1500
  frames).

The port's chip is ``H100`` (every default); ``V5E`` stays as a data row
only, so the formulas can be compared with the JAX package's. Per-kernel
bounds are computed where the kernels are measured (``chip_smoke.py``);
these are the model-level floors.
"""

from __future__ import annotations

import dataclasses

from ..config import ModelConfig

_QUANT_BYTES = {"f32": 4.0, "bf16": 2.0, "int8": 1.0, "q6k": 210 / 256,
                "q5k": 176 / 256, "q4k": 144 / 256, "q4": 0.5625,
                "int4": 0.5}
_KV_BYTES = {"bf16": 2.0, "f32": 4.0, "int8": 1.0, "fp8": 1.0}


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """One accelerator's headline ceilings (public datasheet numbers)."""

    name: str
    bf16_tflops: float
    int8_tops: float
    hbm_gb_s: float
    hbm_gib: float


# NVIDIA H100 SXM (data sheet, dense, at its 700 W limit): 989 bf16
# TFLOP/s, 1979 int8 TOP/s, 3350 GB/s HBM3, 80 GiB -- the port's chip
H100 = ChipSpec("nvidia-h100-sxm", bf16_tflops=989.0, int8_tops=1979.0,
                hbm_gb_s=3350.0, hbm_gib=80.0)
# TPU v5e public specs, kept as a data row only so the formulas can be
# held against the JAX package's: 197 bf16 TFLOP/s, 394 int8 TOP/s,
# 819 GB/s HBM
V5E = ChipSpec("tpu-v5e", bf16_tflops=197.0, int8_tops=394.0,
               hbm_gb_s=819.0, hbm_gib=16.0)


def decoder_weight_bytes(config: ModelConfig, quant: str = "int8") -> float:
    """Bytes of decoder weights streamed per incremental step.

    Per layer: self q/k/v/o (4 D^2) + cross q/o (2 D^2; cross k/v are
    prefill-only) + ffn fc1/fc2 (8 D^2); plus the vocab projection
    (D x n_vocab) read for the logits every step. Per-channel scales and
    biases add ~11 D f32 per layer (kept: they are real traffic).
    """
    D, L, V = config.n_text_state, config.n_text_layer, config.n_vocab
    wb = _QUANT_BYTES[quant]
    per_layer = 14 * D * D * wb + 11 * D * 4
    return per_layer * L + D * V * wb + V * 4


def decode_step_floor_ms(config: ModelConfig, quant: str = "int8",
                         pos: int = 112, kv: str = "bf16",
                         batch: int = 1, chip: ChipSpec = H100) -> float:
    """HBM-bandwidth floor for one incremental decode step.

    Streams: full decoder weights (amortized across the batch — one read
    serves all sequences) + each sequence's live self-KV rows (2 per
    layer up to ``pos``) + the full cross-KV (read every step).
    """
    kvb = _KV_BYTES[kv]
    D, L, S = config.n_text_state, config.n_text_layer, config.n_audio_ctx
    self_kv = pos * 2 * L * D * kvb * batch
    cross_kv = S * 2 * L * D * kvb * batch
    total = decoder_weight_bytes(config, quant) + self_kv + cross_kv
    return total / (chip.hbm_gb_s * 1e9) * 1e3


def encoder_flops(config: ModelConfig) -> float:
    """Forward FLOPs for one 30 s window (matmuls only; 2 FLOP/MAC)."""
    D, L, S, M = (config.n_audio_state, config.n_audio_layer,
                  config.n_audio_ctx, config.n_mels)
    conv = 2 * (2 * S) * 3 * M * D + 2 * S * 3 * D * D  # two k=3 conv GEMMs
    attn = L * (2 * S * 4 * D * D + 2 * 2 * S * S * D)  # qkvo + scores/values
    ffn = L * 2 * S * 8 * D * D
    return conv + attn + ffn


def encoder_floor_ms(config: ModelConfig, chip: ChipSpec = H100,
                     dtype: str = "bf16") -> float:
    """Matrix-unit floor for one 30 s encode (HBM is secondary here)."""
    peak = chip.bf16_tflops if dtype == "bf16" else chip.int8_tops
    return encoder_flops(config) / (peak * 1e12) * 1e3


def rtf_floor(config: ModelConfig, decode_tokens: int = 224,
              quant: str = "int8", kv: str = "bf16",
              chip: ChipSpec = H100, audio_s: float = 30.0) -> float:
    """Speed-of-light RTF for the full pipeline on one chip: encoder at
    its compute floor + ``decode_tokens`` steps at the bandwidth floor
    (mean live-KV length = half the final length)."""
    dec_ms = decode_tokens * decode_step_floor_ms(
        config, quant, pos=decode_tokens // 2, kv=kv, chip=chip)
    return (encoder_floor_ms(config, chip) + dec_ms) / (audio_s * 1e3)


def encoder_weight_bytes(config: ModelConfig, quant: str = "int8") -> float:
    """Encoder weight footprint (stem + qkvo/ffn matmuls per layer)."""
    D, L, M = config.n_audio_state, config.n_audio_layer, config.n_mels
    wb = _QUANT_BYTES[quant]
    stem = (3 * M * D + 3 * D * D) * wb
    return stem + 12 * D * D * wb * L


def kv_cache_bytes_per_stream(config: ModelConfig, kv: str = "bf16",
                              max_len: int = 448) -> float:
    """Resident K+V cache HBM per serving slot (self at ``max_len`` +
    full cross)."""
    kvb = _KV_BYTES[kv]
    D, L, S = config.n_text_state, config.n_text_layer, config.n_audio_ctx
    return 2.0 * L * D * kvb * (max_len + S)


def streams_per_chip_floor(config: ModelConfig, quant: str = "int8",
                           kv: str = "bf16", chip: ChipSpec = H100,
                           decode_tokens: int = 224,
                           audio_s: float = 30.0,
                           max_len: int = 448) -> float:
    """Upper bound on real-time 30 s streams for one chip.

    Batched serving amortizes the per-step weight stream across every
    resident stream, so the bound is NOT ``1/rtf_floor`` (that charges
    one stream the full weight read). The true ceiling is the throughput
    of the largest HBM-resident batch:

        wall(B) = decode_tokens * (W + B*kv_step) / BW + B * enc_floor
        bound   = B * audio_s / wall(B),  B = HBM-capacity-limited batch

    (throughput is monotone in B, so the capacity-limited B is optimal).
    """
    D, L, S = config.n_text_state, config.n_text_layer, config.n_audio_ctx
    w = decoder_weight_bytes(config, quant)
    kv_step = (decode_tokens // 2 + S) * 2 * L * D * _KV_BYTES[kv]
    free = (chip.hbm_gib * 2 ** 30 - w
            - encoder_weight_bytes(config, quant))
    b = max(1.0, free // kv_cache_bytes_per_stream(config, kv, max_len))
    wall_ms = (decode_tokens * (w + b * kv_step)
               / (chip.hbm_gb_s * 1e9) * 1e3
               + b * encoder_floor_ms(config, chip))
    return b * audio_s * 1e3 / wall_ms
