"""Golden-trace harness: per-stage dumps + tolerance-gated comparison:
port of ``whisper_apr_tpu/tools/golden.py`` (the same files, stats and
gates; ``capture_pipeline`` runs the port's engine on its device).

(reference: the numerical-parity example suite — examples/compare_mel_hf.rs,
compare_encoder_hf.rs, compare_hidden_states.rs, debug_* binaries loading HF
.npy dumps and diffing mean/std/min/max per stage; captured by
scripts/capture_golden_traces.sh with `make bench-regression` comparing
baselines, Makefile:247.)

Stages: audio -> mel -> encoder -> decoder hidden/logits. Dumps are .npy
files plus a stats JSON; comparison gates on max-abs-diff and cosine.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class StageStats:
    """(reference: test_data/*.json stats blocks)"""

    name: str
    shape: tuple
    mean: float
    std: float
    min: float
    max: float

    @staticmethod
    def compute(name: str, arr: np.ndarray) -> "StageStats":
        arr = np.asarray(arr, dtype=np.float64)
        return StageStats(name, tuple(arr.shape), float(arr.mean()),
                          float(arr.std()), float(arr.min()),
                          float(arr.max()))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class StageComparison:
    name: str
    max_abs_diff: float
    cosine: float
    passed: bool


def cosine(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 or nb == 0:
        return 1.0 if na == nb else 0.0
    return float(a @ b / (na * nb))


class GoldenTrace:
    """Capture / load / compare per-stage pipeline tensors."""

    # default gates per stage (cosine, max_abs) — mel gate mirrors the
    # reference's cosine > 0.99 (reference_summary.md); encoder/logits gates
    # match the HF-parity tolerances validated in tests/test_model.py
    GATES = {
        "audio": (0.9999, 1e-6),
        "mel": (0.999, 0.05),
        "encoder": (0.999, 1e-2),
        "logits": (0.999, 1e-1),
    }

    def __init__(self, directory: str) -> None:
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def dump(self, name: str, arr: np.ndarray) -> str:
        path = os.path.join(self.directory, f"{name}.npy")
        np.save(path, np.asarray(arr, np.float32))
        stats = StageStats.compute(name, arr)
        with open(os.path.join(self.directory, f"{name}.json"), "w") as f:
            json.dump(stats.to_dict(), f, indent=2)
        return path

    def load(self, name: str) -> Optional[np.ndarray]:
        path = os.path.join(self.directory, f"{name}.npy")
        return np.load(path) if os.path.exists(path) else None

    def capture_pipeline(self, engine, audio: np.ndarray,
                         tokens: Optional[List[int]] = None) -> Dict[str, str]:
        """Run each stage and dump audio/mel/encoder(/logits); the encoder
        and the teacher-forced decoder run on the engine's device."""
        import torch
        out = {"audio": self.dump("audio", audio)}
        mel = engine.compute_mel(audio)
        out["mel"] = self.dump("mel", mel)
        enc = engine.encode(mel)
        out["encoder"] = self.dump("encoder", enc[0].float().cpu().numpy())
        if tokens:
            from ..model.decoder import decoder_forward
            logits = decoder_forward(
                engine.params,
                torch.tensor([list(tokens)], dtype=torch.int64,
                             device=engine.device), enc, engine.config)
            out["logits"] = self.dump("logits",
                                      logits[0].float().cpu().numpy())
        return out

    def compare(self, other_dir: str) -> List[StageComparison]:
        """Diff this trace against another capture directory."""
        other = GoldenTrace(other_dir)
        results = []
        for name, (cos_gate, abs_gate) in self.GATES.items():
            a = self.load(name)
            b = other.load(name)
            if a is None or b is None:
                continue
            if a.shape != b.shape:
                results.append(StageComparison(name, float("inf"), 0.0, False))
                continue
            diff = float(np.abs(a.astype(np.float64)
                                - b.astype(np.float64)).max())
            cos = cosine(a, b)
            results.append(StageComparison(
                name, diff, cos, cos >= cos_gate and diff <= abs_gate))
        return results

    @staticmethod
    def summary(comparisons: List[StageComparison]) -> str:
        lines = []
        for c in comparisons:
            mark = "PASS" if c.passed else "FAIL"
            lines.append(f"[{mark}] {c.name}: max_abs={c.max_abs_diff:.3e} "
                         f"cosine={c.cosine:.6f}")
        return "\n".join(lines)
