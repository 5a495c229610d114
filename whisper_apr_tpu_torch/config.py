# Copied from whisper_apr_tpu/config.py (host-side numpy, no JAX); keep the two in step.
"""Model hyperparameter configuration and presets.

Mirrors the reference ``ModelConfig`` (reference: src/model/mod.rs:36-150) with
the same preset hyperparameters for tiny/base/small/medium/large, extended with
the large-v2/v3 variants the reference enumerates in its ``ModelType`` enum
(reference: src/format/mod.rs:290-312).

Port additions: compute dtype policy and padding/bucketing knobs that
have no reference counterpart (the reference is scalar/SIMD f32 only).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .errors import ConfigError

# Audio constants (reference: src/audio/mod.rs:31-37)
SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH_S = 30
N_SAMPLES_30S = SAMPLE_RATE * CHUNK_LENGTH_S  # 480_000
N_FRAMES = 3000  # mel frames per 30 s window (reference: src/lib.rs:409)

# Model-type codes as stored in the .apr header byte 2
# (reference: src/format/mod.rs:297-312)
MODEL_TYPE_CODES = {
    "tiny": 0,
    "tiny.en": 1,
    "base": 2,
    "base.en": 3,
    "small": 4,
    "small.en": 5,
    "medium": 6,
    "medium.en": 7,
    "large": 8,
    "large-v1": 9,
    "large-v2": 10,
    "large-v3": 11,
    "large-v3-turbo": 12,
}
MODEL_TYPE_NAMES = {v: k for k, v in MODEL_TYPE_CODES.items()}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Whisper model hyperparameters (reference: src/model/mod.rs:36-63)."""

    model_type: str = "tiny"
    n_vocab: int = 51_865
    n_audio_ctx: int = 1500
    n_audio_state: int = 384
    n_audio_head: int = 6
    n_audio_layer: int = 4
    n_text_ctx: int = 448
    n_text_state: int = 384
    n_text_head: int = 6
    n_text_layer: int = 4
    n_mels: int = 80

    def __post_init__(self) -> None:
        if self.n_audio_state % self.n_audio_head != 0:
            raise ConfigError(
                f"n_audio_state {self.n_audio_state} not divisible by "
                f"n_audio_head {self.n_audio_head}"
            )
        if self.n_text_state % self.n_text_head != 0:
            raise ConfigError(
                f"n_text_state {self.n_text_state} not divisible by "
                f"n_text_head {self.n_text_head}"
            )

    # -- derived -----------------------------------------------------------
    @property
    def audio_head_dim(self) -> int:
        return self.n_audio_state // self.n_audio_head

    @property
    def text_head_dim(self) -> int:
        return self.n_text_state // self.n_text_head

    @property
    def is_multilingual(self) -> bool:
        # reference: src/tokenizer/vocab.rs:27 MULTILINGUAL_VOCAB_THRESHOLD
        return self.n_vocab >= 51_865

    @property
    def model_type_code(self) -> int:
        return MODEL_TYPE_CODES.get(self.model_type, 0)

    # -- presets (reference: src/model/mod.rs:64-150) ----------------------
    @staticmethod
    def tiny() -> "ModelConfig":
        return ModelConfig("tiny", 51_865, 1500, 384, 6, 4, 448, 384, 6, 4, 80)

    @staticmethod
    def tiny_en() -> "ModelConfig":
        return ModelConfig("tiny.en", 51_864, 1500, 384, 6, 4, 448, 384, 6, 4, 80)

    @staticmethod
    def base() -> "ModelConfig":
        return ModelConfig("base", 51_865, 1500, 512, 8, 6, 448, 512, 8, 6, 80)

    @staticmethod
    def base_en() -> "ModelConfig":
        return ModelConfig("base.en", 51_864, 1500, 512, 8, 6, 448, 512, 8, 6, 80)

    @staticmethod
    def small() -> "ModelConfig":
        return ModelConfig("small", 51_865, 1500, 768, 12, 12, 448, 768, 12, 12, 80)

    @staticmethod
    def small_en() -> "ModelConfig":
        return ModelConfig("small.en", 51_864, 1500, 768, 12, 12, 448, 768, 12, 12, 80)

    @staticmethod
    def medium() -> "ModelConfig":
        return ModelConfig("medium", 51_865, 1500, 1024, 16, 24, 448, 1024, 16, 24, 80)

    @staticmethod
    def medium_en() -> "ModelConfig":
        return ModelConfig("medium.en", 51_864, 1500, 1024, 16, 24, 448, 1024, 16, 24, 80)

    @staticmethod
    def large() -> "ModelConfig":
        return ModelConfig("large", 51_865, 1500, 1280, 20, 32, 448, 1280, 20, 32, 80)

    @staticmethod
    def large_v1() -> "ModelConfig":
        return dataclasses.replace(ModelConfig.large(), model_type="large-v1")

    @staticmethod
    def large_v2() -> "ModelConfig":
        return dataclasses.replace(ModelConfig.large(), model_type="large-v2")

    @staticmethod
    def large_v3() -> "ModelConfig":
        # large-v3 uses 128 mel bins and one extra vocab slot for <|yue|>
        return ModelConfig("large-v3", 51_866, 1500, 1280, 20, 32, 448, 1280, 20, 32, 128)

    @staticmethod
    def large_v3_turbo() -> "ModelConfig":
        # turbo: large-v3 encoder with the decoder pruned to 4 layers
        # (OpenAI's distilled release; ~6x fewer decoder weights per step)
        return ModelConfig("large-v3-turbo", 51_866, 1500, 1280, 20, 32,
                           448, 1280, 20, 4, 128)

    @staticmethod
    def from_name(name: str) -> "ModelConfig":
        table = {
            "tiny": ModelConfig.tiny,
            "tiny.en": ModelConfig.tiny_en,
            "base": ModelConfig.base,
            "base.en": ModelConfig.base_en,
            "small": ModelConfig.small,
            "small.en": ModelConfig.small_en,
            "medium": ModelConfig.medium,
            "medium.en": ModelConfig.medium_en,
            "large": ModelConfig.large,
            "large-v1": ModelConfig.large_v1,
            "large-v2": ModelConfig.large_v2,
            "large-v3": ModelConfig.large_v3,
            "large-v3-turbo": ModelConfig.large_v3_turbo,
            "turbo": ModelConfig.large_v3_turbo,
        }
        if name not in table:
            raise ConfigError(f"unknown model preset: {name!r}")
        return table[name]()

    # -- memory estimation (reference: src/model/mod.rs:162-320) -----------
    def parameter_count(self) -> int:
        """Approximate parameter count (reference: src/model/mod.rs:162)."""
        d_a, d_t = self.n_audio_state, self.n_text_state
        # conv stem: conv1 (n_mels*d*3 + d) + conv2 (d*d*3 + d)
        conv = self.n_mels * d_a * 3 + d_a + d_a * d_a * 3 + d_a
        # encoder block: attn 4*(d*d+d) + ffn 2*(4d*d)+5d + 2 LN
        enc_block = 4 * (d_a * d_a + d_a) + (d_a * 4 * d_a + 4 * d_a) + (
            4 * d_a * d_a + d_a) + 4 * d_a
        enc = conv + self.n_audio_layer * enc_block + 2 * d_a + self.n_audio_ctx * d_a
        # decoder: embeddings + blocks (self-attn + cross-attn + ffn + 3 LN)
        dec_block = 2 * 4 * (d_t * d_t + d_t) + (d_t * 4 * d_t + 4 * d_t) + (
            4 * d_t * d_t + d_t) + 6 * d_t
        dec = (self.n_vocab * d_t + self.n_text_ctx * d_t
               + self.n_text_layer * dec_block + 2 * d_t)
        return enc + dec

    def kv_cache_bytes(self, batch: int = 1, dtype_bytes: int = 4) -> int:
        """Self + cross attention KV cache footprint for one decode session.

        (reference: src/model/mod.rs:232 kv_cache_memory_bytes)
        """
        d = self.n_text_state
        self_kv = 2 * self.n_text_layer * batch * self.n_text_ctx * d
        cross_kv = 2 * self.n_text_layer * batch * self.n_audio_ctx * d
        return (self_kv + cross_kv) * dtype_bytes


@dataclasses.dataclass(frozen=True)
class ComputeConfig:
    """Device execution policy (no reference counterpart; the reference is
    f32 scalar/SIMD only — reference: src/simd.rs:25 best_backend). Controls
    the dtype the matmuls see and the fidelity/speed tradeoff.
    """

    # dtype for matmuls/activations: "bfloat16" (fast path) or "float32" (fidelity)
    compute_dtype: str = "float32"
    # dtype parameters are stored in on device
    param_dtype: str = "float32"
    # flash attention for encoder self-attention: True runs each encoder
    # layer's attention through K16 (ops/flash_attention.mha_flash, bf16 or
    # f32 on the tensor cores), False plain torch attention, None the
    # kernel selector's choice (ops/dispatch.KernelSelector)
    use_flash_attention: "bool | None" = None
    # runtime weight quantization: "none" | "int8" | "int4" | "q4" |
    # "q4k" | "q5k" | "q6k" (model/params.quantize_params implements
    # every mode)
    quantization: str = "none"
    # decode KV-cache / attention-kernel mode (quantized fast path only).
    # The semantics are the JAX package's; the default resolution ("auto"
    # -> "cross8" at B=1) is copied from it and awaits the port's own
    # measurement:
    # "bf16"    = per-block kernel step with compute-dtype KV rows,
    # "int8"    = per-row int8 KV with f32 row scales (self and cross),
    # "fp8"     = float8_e4m3fn KV rows, no scales (self and cross),
    # "cross8"  = int8 rows for the cross cache only, compute-dtype self,
    # "crossf8" = fp8 rows for the cross cache only, compute-dtype self,
    # "scan"    = per-kernel scan step (decode_step_q: K8 and K9)
    kv_mode: str = "auto"

    # decode in larger position buckets to bound recompilation
    text_bucket: int = 448

    _KV_MODES = ("auto", "bf16", "int8", "fp8", "cross8", "crossf8",
                 "scan")

    def __post_init__(self):
        if self.kv_mode not in self._KV_MODES:
            raise ValueError(
                f"kv_mode must be one of {self._KV_MODES}, "
                f"got {self.kv_mode!r}")

    def replace(self, **kw) -> "ComputeConfig":
        return dataclasses.replace(self, **kw)
