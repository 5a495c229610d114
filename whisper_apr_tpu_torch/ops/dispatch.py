"""Kernel dispatch: port of ``whisper_apr_tpu/ops/dispatch.py``.

Per op and shape, the choice between plain PyTorch ops (the member
``XLA``, the JAX package's name for "leave it to the compiler") and a
hand-written kernel (``PALLAS``, the JAX package's name for its kernels;
here the CUDA kernels of ``csrc/``), plus the device description the
choice reads. The rules and the threshold are the JAX package's. The
attention threshold (``4 << 20`` score elements) was set from a TPU
measurement; at Whisper's 1500 x 1500 it never picks the flash kernel,
so ``ComputeConfig(use_flash_attention=None)`` keeps the plain encoder
attention. What the H100 measures for both is in ``PERF.md``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Union

import torch


class KernelBackend(enum.Enum):
    XLA = "xla"          # plain PyTorch ops
    PALLAS = "pallas"    # a hand-written CUDA kernel
    AUTO = "auto"


@dataclasses.dataclass(frozen=True)
class DeviceCapabilities:
    platform: str        # "cuda" or "cpu"
    name: str
    n_devices: int
    hbm_bytes: int

    @staticmethod
    def detect(device: Union[str, torch.device, None] = None
               ) -> "DeviceCapabilities":
        """The card of ``device`` (default: the first CUDA device when
        there is one), else the host."""
        device = torch.device(device if device is not None else (
            "cuda" if torch.cuda.is_available() else "cpu"))
        if device.type != "cuda":
            return DeviceCapabilities("cpu", "cpu", 1, 16 << 30)
        idx = device.index if device.index is not None else 0
        props = torch.cuda.get_device_properties(idx)
        return DeviceCapabilities(
            "cuda", torch.cuda.get_device_name(idx),
            torch.cuda.device_count(), int(props.total_memory))


def resolve_device(device, what: str) -> torch.device:
    """``device`` as a torch.device; raise when it is a CUDA device and
    there is none (the port's entry points default to "cuda" and never
    fall back to the CPU on their own)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}(device='cuda') needs a CUDA device; "
                           "pass device='cpu' to run the plain versions")
    return device


@dataclasses.dataclass(frozen=True)
class SelectorConfig:
    # at and above this q * k sequence product the flash kernel is chosen
    flash_attention_score_elements: int = 4 << 20   # 2048 x 2048
    prefer_pallas: bool = True


class KernelSelector:
    """Per-op kernel choice table (JAX ``KernelSelector``)."""

    def __init__(self, config: Optional[SelectorConfig] = None,
                 caps: Optional[DeviceCapabilities] = None) -> None:
        self.config = config or SelectorConfig()
        self.caps = caps or DeviceCapabilities.detect()

    def attention(self, q_len: int, k_len: int,
                  backend: KernelBackend = KernelBackend.AUTO
                  ) -> KernelBackend:
        """Self/cross attention: the flash kernel (K16) when the score
        matrix has at least ``flash_attention_score_elements`` entries;
        the CPU always takes the plain path."""
        if backend != KernelBackend.AUTO:
            return backend
        if self.caps.platform == "cpu" or not self.config.prefer_pallas:
            return KernelBackend.XLA
        if q_len * k_len >= self.config.flash_attention_score_elements:
            return KernelBackend.PALLAS
        return KernelBackend.XLA

    def matmul(self, m: int, n: int, k: int) -> KernelBackend:
        """Plain GEMMs stay plain."""
        return KernelBackend.XLA

    def dequant_matmul(self, bits: int) -> KernelBackend:
        """Packed int4 wants the unpack-fused kernel (K18) off the CPU;
        int8 stays plain."""
        return KernelBackend.PALLAS if bits == 4 and \
            self.caps.platform != "cpu" else KernelBackend.XLA
