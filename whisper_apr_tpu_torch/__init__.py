"""whisper_apr_tpu_torch — the PyTorch / CUDA port of whisper_apr_tpu.

Same module paths and function names as the JAX package; plain PyTorch
for the host-driven pipeline and hand-written CUDA kernels (``csrc/``,
built at first use) for the per-token decode step on an NVIDIA Hopper
GPU. Imports torch and numpy only — never JAX.
"""

__version__ = "0.1.0"

from .config import ComputeConfig, ModelConfig
from .engine import (BatchTranscriptionResult, TranscribeOptions,
                     TranscriptionResult, WhisperApr)
from .errors import (AudioError, FormatError, InferenceError, ModelError,
                     WhisperError)
from .format import AprReader, AprWriter

__all__ = [
    "ModelConfig", "ComputeConfig", "WhisperApr", "TranscribeOptions",
    "TranscriptionResult", "BatchTranscriptionResult", "AprReader",
    "AprWriter", "WhisperError", "FormatError", "AudioError", "ModelError",
    "InferenceError", "__version__",
]
