"""Device memory planning and introspection (port of the JAX package's
``utils/memory.py``): live memory stats of the card, footprint estimates
of a model and its caches, the largest preset a memory size holds, and
the bytes of a param tree.

JAX's ``donate_buffers`` (jit with donated inputs, so XLA reuses their
memory for the outputs) has no counterpart: PyTorch runs eagerly, its
caching allocator reuses freed blocks, and the port updates caches in
place where it saves memory.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..config import ModelConfig
from ..model.params import tree_leaves

H100_BYTES = 80 << 30


@dataclasses.dataclass
class MemoryStats:
    """Device memory snapshot."""

    bytes_in_use: int
    bytes_limit: int
    peak_bytes: int

    @property
    def utilization(self) -> float:
        return self.bytes_in_use / self.bytes_limit if self.bytes_limit else 0.0


def device_memory_stats(device: "torch.device | str | None" = None
                        ) -> Optional[MemoryStats]:
    """PyTorch's allocated bytes (now and at peak) on a CUDA device
    against the card's total memory; None for a device that is not a
    card (or when there is none)."""
    device = torch.device(device if device is not None else "cuda")
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    s = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return MemoryStats(
        bytes_in_use=int(s.get("allocated_bytes.all.current", 0)),
        bytes_limit=int(total),
        peak_bytes=int(s.get("allocated_bytes.all.peak", 0)))


@dataclasses.dataclass
class MemoryPlan:
    """Pre-flight footprint estimate of one inference session."""

    weights_bytes: int
    kv_cache_bytes: int
    activations_bytes: int

    @property
    def total_bytes(self) -> int:
        return self.weights_bytes + self.kv_cache_bytes + self.activations_bytes

    def fits(self, hbm_bytes: int = H100_BYTES) -> bool:
        return self.total_bytes < hbm_bytes * 0.9


def plan_memory(config: ModelConfig, batch: int = 1,
                param_bytes_per_el: int = 4,
                compute_bytes_per_el: int = 4) -> MemoryPlan:
    """Estimate the device memory one inference session needs."""
    weights = config.parameter_count() * param_bytes_per_el
    kv = config.kv_cache_bytes(batch, compute_bytes_per_el)
    # encoder activations dominate: [B, 1500, d] x ~4 live tensors + scores
    acts = batch * config.n_audio_ctx * config.n_audio_state \
        * compute_bytes_per_el * 8
    return MemoryPlan(weights, kv, acts)


def recommend_model(hbm_bytes: int, batch: int = 1,
                    quantization: str = "int8") -> str:
    """Largest model preset whose inference session fits the given
    memory."""
    per_el = {"int8": 1, "int4": 1, "none": 4,
              "bfloat16": 2, "float32": 4}.get(quantization, 4)
    best = "tiny"
    for name in ("tiny", "base", "small", "medium", "large-v3"):
        plan = plan_memory(ModelConfig.from_name(name), batch,
                           param_bytes_per_el=per_el,
                           compute_bytes_per_el=2)
        if plan.fits(hbm_bytes):
            best = name
    return best


def tree_bytes(params: Any) -> int:
    """Bytes of a param tree's tensors (a QTensor's values, scales and
    zeros at their stored width)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(params))
