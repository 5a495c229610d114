"""Benchmark infrastructure: the mel / encode / decode split of one
transcription, its RTF against the roofline floor, JSON / CSV / text
reports (port of the JAX package's ``utils/benchmark.py``).

On the card each stage is timed by CUDA events recorded around it on the
current stream (the decode loop syncs the host once a token, so a
stage's event time is its wall time); on the CPU (tests) by the host
clock, and the report says so.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

@dataclasses.dataclass
class ComponentTiming:
    """One pipeline component's timing (reference: benchmark.rs:706)."""

    name: str
    seconds: float
    fraction: float = 0.0


@dataclasses.dataclass
class BenchmarkReport:
    """Pipeline benchmark result (reference: benchmark.rs RtfBenchmark)."""

    audio_seconds: float
    total_seconds: float
    components: List[ComponentTiming]
    tokens_decoded: int
    # analytic speed-of-light bound for the same workload (utils/roofline)
    # -- 0 when no model config was available to derive it
    rtf_floor: float = 0.0
    # where it ran: the card's name, or "cpu" (host times)
    device: str = ""

    @property
    def rtf(self) -> float:
        return self.total_seconds / max(self.audio_seconds, 1e-9)

    @property
    def tokens_per_second(self) -> float:
        return self.tokens_decoded / max(self.total_seconds, 1e-9)

    def bottleneck(self) -> str:
        """(reference: benchmark.rs bottleneck())"""
        return max(self.components, key=lambda c: c.seconds).name

    def to_json(self) -> str:
        return json.dumps({
            "device": self.device,
            "audio_seconds": self.audio_seconds,
            "total_seconds": round(self.total_seconds, 6),
            "rtf": round(self.rtf, 6),
            "tokens_per_second": round(self.tokens_per_second, 2),
            "bottleneck": self.bottleneck(),
            "rtf_floor": round(self.rtf_floor, 6),
            "vs_floor": round(self.rtf / self.rtf_floor, 2)
            if self.rtf_floor else None,
            "components": [{
                "name": c.name, "seconds": round(c.seconds, 6),
                "fraction": round(c.fraction, 4)} for c in self.components],
        })

    def to_csv(self) -> str:
        lines = ["component,seconds,fraction"]
        for c in self.components:
            lines.append(f"{c.name},{c.seconds:.6f},{c.fraction:.4f}")
        lines.append(f"total,{self.total_seconds:.6f},1.0")
        return "\n".join(lines)

    def to_text(self) -> str:
        lines = [f"RTF {self.rtf:.4f}  ({self.total_seconds:.3f}s for "
                 f"{self.audio_seconds:.1f}s audio, "
                 f"{self.tokens_per_second:.1f} tok/s; {self.device})"]
        for c in self.components:
            lines.append(f"  {c.name:<12} {c.seconds * 1e3:9.2f} ms "
                         f"{100 * c.fraction:5.1f}%")
        lines.append(f"  bottleneck: {self.bottleneck()}")
        if self.rtf_floor:
            lines.append(f"  roofline: rtf floor {self.rtf_floor:.4f} "
                         f"({self.rtf / self.rtf_floor:.2f}x above "
                         f"speed-of-light)")
        return "\n".join(lines)


def _stage_timer(device: torch.device) -> Callable:
    """``timed(fn, *args) -> (result, seconds)``: CUDA events around
    ``fn`` on a card, the host clock on the CPU."""
    if device.type != "cuda":
        def timed(fn, *args):
            t0 = time.perf_counter()
            out = fn(*args)
            return out, time.perf_counter() - t0
        return timed

    def timed(fn, *args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) / 1e3
    return timed


def run_pipeline_benchmark(model_path: Optional[str] = None,
                           audio_seconds: float = 30.0,
                           decode_tokens: int = 224,
                           emit: str = "text",
                           device: "torch.device | str" = "cuda") -> str:
    """One timed transcription split into mel / encode / decode.

    Uses the model at ``model_path`` or random whisper-tiny weights in
    bf16 (seed 0); 30 s of noise (seed 0); the decode is the plain greedy
    loop over ``decode_tokens`` tokens with EOT suppressed, as the JAX
    package's. Warms up once, then times one run."""
    from ..audio.mel import MelFilterbank
    from ..config import ModelConfig
    from ..model.decoder import greedy_generate_body
    from ..model.encoder import encode
    from ..model.params import init_params, to_device, tree_map
    from ..ops.dispatch import resolve_device
    from ..tokenizer.special_tokens import SpecialTokens
    from .roofline import rtf_floor

    device = resolve_device(device, "run_pipeline_benchmark")
    quant = "bf16"
    if model_path:
        from ..engine import WhisperApr
        eng = WhisperApr.load_from_apr(model_path, device=device)
        cfg, params, fb = eng.config, eng.params, eng.mel_filters
        compute_dtype = eng._compute_dtype
        quant = {0: "f32", 2: "int8", 4: "q4k", 5: "q5k", 6: "q6k"}.get(
            eng.quantization_code, "bf16") \
            if hasattr(eng, "quantization_code") else "bf16"
    else:
        cfg = ModelConfig.tiny()
        params = to_device(tree_map(lambda t: t.to(torch.bfloat16),
                                    init_params(cfg, seed=0)), device)
        fb = MelFilterbank.create(cfg.n_mels)
        compute_dtype = torch.bfloat16

    rng = np.random.default_rng(0)
    audio = rng.normal(0, 0.1, int(16_000 * audio_seconds)).astype(np.float32)
    specials = SpecialTokens.for_vocab_size(cfg.n_vocab)
    prompt_len = 4
    prompt = torch.full((1, prompt_len), specials.sot, dtype=torch.int32,
                        device=device)
    bias = torch.zeros(cfg.n_vocab, dtype=torch.float32, device=device)
    eot = specials.eot
    bias[eot] = float(np.finfo(np.float32).min)   # fixed-length decode
    max_len = prompt_len + decode_tokens

    def stage_mel():
        return fb.compute_30s_device(audio, device=device)

    def stage_encode(mel):
        return encode(params, mel[None], cfg, compute_dtype=compute_dtype)

    def stage_decode(enc):
        return greedy_generate_body(params, enc, prompt, bias, eot, cfg,
                                    max_len=max_len, prompt_len=prompt_len,
                                    compute_dtype=compute_dtype).tokens

    stage_decode(stage_encode(stage_mel()))          # warm-up
    timed = _stage_timer(device)
    timings: Dict[str, float] = {}
    t0 = time.perf_counter()
    mel, timings["mel"] = timed(stage_mel)
    enc, timings["encode"] = timed(stage_encode, mel)
    _, timings["decode"] = timed(stage_decode, enc)
    total = time.perf_counter() - t0

    components = [ComponentTiming(k, v, v / total) for k, v in timings.items()]
    floor = rtf_floor(cfg, decode_tokens=decode_tokens, quant=quant,
                      audio_s=audio_seconds)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu (host times)")
    report = BenchmarkReport(audio_seconds, total, components, decode_tokens,
                             rtf_floor=floor, device=name)
    if emit == "json":
        return report.to_json()
    if emit == "csv":
        return report.to_csv()
    return report.to_text()
