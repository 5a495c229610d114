# Copied from whisper_apr_tpu/format/validation.py (host-side numpy, no JAX); keep the two in step.
"""25-point .apr model QA validator.

Re-implements the reference's validation checklist
(reference: src/format/validation.rs:230-345 ``AprValidator::validate_all``):

  A. Structural integrity (1-5): magic, header, tensor count, shapes, CRC32
  B. Layer norms (6-10): LN weight/bias statistics, NaN/Inf
  C. Attention/linear (11-15): Q/K/V means, FFN means, stds, zero tensors, biases
  D. Embeddings (16-20): token/positional embedding shapes and stats
  E. Functional (21-25): reference-data comparisons (skipped without data)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np

from .container import AprReader


@dataclasses.dataclass
class ValidationCheck:
    """One checklist item (reference: src/format/validation.rs:139-178)."""

    id: int
    category: str
    description: str
    message: str
    passed: bool

    @staticmethod
    def ok(id_: int, category: str, description: str, message: str) -> "ValidationCheck":
        return ValidationCheck(id_, category, description, message, True)

    @staticmethod
    def fail(id_: int, category: str, description: str, message: str) -> "ValidationCheck":
        return ValidationCheck(id_, category, description, message, False)


@dataclasses.dataclass
class TensorStats:
    """Summary statistics for one tensor (reference: src/format/validation.rs:42)."""

    mean: float
    std: float
    min: float
    max: float
    has_nan: bool
    has_inf: bool
    all_zero: bool

    @staticmethod
    def compute(arr: np.ndarray) -> "TensorStats":
        arr = np.asarray(arr, dtype=np.float64)
        finite = np.isfinite(arr)
        return TensorStats(
            mean=float(arr[finite].mean()) if finite.any() else math.nan,
            std=float(arr[finite].std()) if finite.any() else math.nan,
            min=float(arr[finite].min()) if finite.any() else math.nan,
            max=float(arr[finite].max()) if finite.any() else math.nan,
            has_nan=bool(np.isnan(arr).any()),
            has_inf=bool(np.isinf(arr).any()),
            all_zero=bool((arr == 0).all()),
        )


@dataclasses.dataclass
class ValidationReport:
    """Aggregate result (reference: src/format/validation.rs:180-225)."""

    checks: List[ValidationCheck]
    critical_failures: List[str]

    @property
    def passed(self) -> bool:
        return all(c.passed for c in self.checks) and not self.critical_failures

    @property
    def n_passed(self) -> int:
        return sum(1 for c in self.checks if c.passed)

    def checks_by_category(self, category: str) -> List[ValidationCheck]:
        return [c for c in self.checks if c.category == category]

    def summary(self) -> str:
        lines = [f"Validation: {self.n_passed}/{len(self.checks)} checks passed"]
        for c in self.checks:
            mark = "PASS" if c.passed else "FAIL"
            lines.append(f"  [{mark}] {c.id:2d} ({c.category}) {c.description}: {c.message}")
        for msg in self.critical_failures:
            lines.append(f"  !! {msg}")
        return "\n".join(lines)


class AprValidator:
    """25-point model QA checklist (reference: src/format/validation.rs:218)."""

    def __init__(self, reader: AprReader) -> None:
        self.reader = reader
        self._stats_cache: Dict[str, Optional[TensorStats]] = {}

    def _stats(self, name: str) -> Optional[TensorStats]:
        if name not in self._stats_cache:
            try:
                self._stats_cache[name] = TensorStats.compute(self.reader.load_tensor(name))
            except Exception:
                self._stats_cache[name] = None
        return self._stats_cache[name]

    def validate_all(self) -> ValidationReport:
        checks: List[ValidationCheck] = []
        checks.extend(self._structural())
        ln_checks = self._layer_norms()
        critical = [f"Critical: {c.message}" for c in ln_checks
                    if not c.passed and 6 <= c.id <= 9]
        checks.extend(ln_checks)
        checks.extend(self._attention_linear())
        checks.extend(self._embeddings())
        checks.extend(self._functional())
        return ValidationReport(checks, critical)

    # -- A. structural (1-5) -------------------------------------------------
    def _structural(self) -> List[ValidationCheck]:
        r = self.reader
        out = [ValidationCheck.ok(1, "A", "Magic bytes valid", "APR1 magic present"),
               ValidationCheck.ok(2, "A", "Header parseable", f"Version {r.header.version}")]

        n = r.header.n_tensors
        if n > 0:
            out.append(ValidationCheck.ok(3, "A", "All tensors present", f"{n} tensors"))
        else:
            out.append(ValidationCheck.fail(3, "A", "All tensors present", "no tensors"))

        shape_failures = []
        for desc in r.tensors:
            expected = 1
            for d in desc.dims:
                expected *= d
            if desc.dims and expected != desc.n_elements:
                shape_failures.append(f"{desc.name}: shape {desc.dims} != {desc.n_elements}")
        if shape_failures:
            out.append(ValidationCheck.fail(4, "A", "Tensor shapes match",
                                            "; ".join(shape_failures[:5])))
        else:
            out.append(ValidationCheck.ok(4, "A", "Tensor shapes match",
                                          "All critical shapes valid"))

        if r.verify_crc():
            out.append(ValidationCheck.ok(5, "A", "CRC32 valid", "Checksum verified"))
        else:
            out.append(ValidationCheck.fail(5, "A", "CRC32 valid", "Checksum mismatch"))
        return out

    # -- B. layer norms (6-10) ------------------------------------------------
    def _ln_names(self) -> List[str]:
        r = self.reader
        names = ["encoder.layer_norm", "decoder.layer_norm"]
        for i in range(r.header.n_audio_layer):
            names += [f"encoder.layers.{i}.self_attn_layer_norm",
                      f"encoder.layers.{i}.final_layer_norm"]
        for i in range(r.header.n_text_layer):
            names += [f"decoder.layers.{i}.self_attn_layer_norm",
                      f"decoder.layers.{i}.encoder_attn_layer_norm",
                      f"decoder.layers.{i}.final_layer_norm"]
        return names

    def _ln_weight_check(self, id_: int, name: str, desc: str) -> ValidationCheck:
        # LN weight means should be near 1.0 (reference: validation.rs:439-462)
        stats = self._stats(f"{name}.weight")
        if stats is None:
            return ValidationCheck.fail(id_, "B", desc, f"Tensor {name}.weight not found")
        if 0.1 <= stats.mean <= 10.0:
            return ValidationCheck.ok(id_, "B", desc, f"mean={stats.mean:.4f}")
        return ValidationCheck.fail(id_, "B", desc, f"suspicious mean={stats.mean:.4f}")

    def _layer_norms(self) -> List[ValidationCheck]:
        out = [self._ln_weight_check(6, "encoder.layer_norm", "Encoder LN weight mean"),
               self._ln_weight_check(7, "decoder.layer_norm", "Decoder LN weight mean")]

        bad = []
        for name in self._ln_names():
            stats = self._stats(f"{name}.weight")
            if stats is not None and not (0.1 <= stats.mean <= 10.0):
                bad.append(f"{name} mean={stats.mean:.3f}")
        out.append(ValidationCheck.ok(8, "B", "Block LN weight means", "all within range")
                   if not bad else
                   ValidationCheck.fail(8, "B", "Block LN weight means", "; ".join(bad[:5])))

        # LN bias means should be small (reference: validation.rs:500-526)
        bad = []
        for name in self._ln_names():
            stats = self._stats(f"{name}.bias")
            if stats is not None and abs(stats.mean) > 2.0:
                bad.append(f"{name} bias mean={stats.mean:.3f}")
        out.append(ValidationCheck.ok(9, "B", "LN bias means", "all within range")
                   if not bad else
                   ValidationCheck.fail(9, "B", "LN bias means", "; ".join(bad[:5])))

        nan_hits = []
        for name in self._ln_names():
            for suffix in (".weight", ".bias"):
                stats = self._stats(name + suffix)
                if stats is not None and (stats.has_nan or stats.has_inf):
                    nan_hits.append(name + suffix)
        out.append(ValidationCheck.ok(10, "B", "No NaN/Inf in LN", "clean")
                   if not nan_hits else
                   ValidationCheck.fail(10, "B", "No NaN/Inf in LN", "; ".join(nan_hits[:5])))
        return out

    # -- C. attention / linear (11-15) ----------------------------------------
    def _attention_linear(self) -> List[ValidationCheck]:
        r = self.reader
        out = []

        qkv_bad = []
        for prefix in (["encoder.layers.%d.self_attn" % i for i in range(r.header.n_audio_layer)]
                       + ["decoder.layers.%d.self_attn" % i for i in range(r.header.n_text_layer)]
                       + ["decoder.layers.%d.encoder_attn" % i
                          for i in range(r.header.n_text_layer)]):
            for proj in ("q_proj", "k_proj", "v_proj"):
                stats = self._stats(f"{prefix}.{proj}.weight")
                if stats is not None and abs(stats.mean) > 1.0:
                    qkv_bad.append(f"{prefix}.{proj} mean={stats.mean:.3f}")
        out.append(ValidationCheck.ok(11, "C", "Q/K/V proj means", "all near zero")
                   if not qkv_bad else
                   ValidationCheck.fail(11, "C", "Q/K/V proj means", "; ".join(qkv_bad[:5])))

        ffn_bad = []
        for scope, n in (("encoder", r.header.n_audio_layer), ("decoder", r.header.n_text_layer)):
            for i in range(n):
                for fc in ("fc1", "fc2"):
                    stats = self._stats(f"{scope}.layers.{i}.{fc}.weight")
                    if stats is not None and abs(stats.mean) > 1.0:
                        ffn_bad.append(f"{scope}.layers.{i}.{fc} mean={stats.mean:.3f}")
        out.append(ValidationCheck.ok(12, "C", "FFN weight means", "all near zero")
                   if not ffn_bad else
                   ValidationCheck.fail(12, "C", "FFN weight means", "; ".join(ffn_bad[:5])))

        std_bad = []
        for desc in r.tensors:
            if desc.name.endswith(".weight") and desc.n_dims >= 2:
                stats = self._stats(desc.name)
                if stats is None:
                    continue
                # NaN/Inf anywhere in a weight matrix is disqualifying —
                # the mean/std fields cover FINITE values only, so without
                # this an Inf in e.g. q_proj escaped every check (found by
                # the round-3 corrupted-model tests)
                if stats.has_nan or stats.has_inf:
                    std_bad.append(f"{desc.name} has NaN/Inf")
                elif stats.std > 20.0 or (stats.std == 0.0
                                          and not stats.all_zero):
                    std_bad.append(f"{desc.name} std={stats.std:.3f}")
        out.append(ValidationCheck.ok(13, "C", "Weight std/finite", "all within range")
                   if not std_bad else
                   ValidationCheck.fail(13, "C", "Weight std/finite", "; ".join(std_bad[:5])))

        zero = []
        for desc in r.tensors:
            if desc.name.endswith(".weight"):
                stats = self._stats(desc.name)
                if stats is not None and stats.all_zero:
                    zero.append(desc.name)
        out.append(ValidationCheck.ok(14, "C", "No zero tensors", "all non-zero")
                   if not zero else
                   ValidationCheck.fail(14, "C", "No zero tensors", "; ".join(zero[:5])))

        bias_bad = []
        for desc in r.tensors:
            if desc.name.endswith(".bias"):
                stats = self._stats(desc.name)
                if stats is not None and (stats.has_nan or stats.has_inf):
                    bias_bad.append(desc.name)
        out.append(ValidationCheck.ok(15, "C", "Bias vectors valid", "all finite")
                   if not bias_bad else
                   ValidationCheck.fail(15, "C", "Bias vectors valid", "; ".join(bias_bad[:5])))
        return out

    # -- D. embeddings (16-20) -------------------------------------------------
    def _embeddings(self) -> List[ValidationCheck]:
        r = self.reader
        out = []
        te = r.find_tensor("decoder.embed_tokens.weight") or r.find_tensor(
            "decoder.token_embedding")
        if te is not None and te.dims[:2] == (r.header.n_vocab, r.header.n_text_state):
            out.append(ValidationCheck.ok(16, "D", "Token embedding shape", str(te.dims)))
        elif te is not None:
            out.append(ValidationCheck.fail(
                16, "D", "Token embedding shape",
                f"{te.dims} != ({r.header.n_vocab}, {r.header.n_text_state})"))
        else:
            out.append(ValidationCheck.fail(16, "D", "Token embedding shape", "not found"))

        te_stats = self._stats(te.name) if te is not None else None
        if te_stats is not None and not te_stats.has_nan and not te_stats.has_inf \
                and te_stats.std > 1e-6:
            out.append(ValidationCheck.ok(
                17, "D", "Token embedding stats",
                f"mean={te_stats.mean:.4f} std={te_stats.std:.4f}"))
        else:
            out.append(ValidationCheck.fail(17, "D", "Token embedding stats", "bad stats"))

        pe = r.find_tensor("decoder.embed_positions.weight") or r.find_tensor(
            "decoder.positional_embedding")
        if pe is not None and pe.dims[:2] == (r.header.n_text_ctx, r.header.n_text_state):
            out.append(ValidationCheck.ok(18, "D", "Positional embedding shape", str(pe.dims)))
        elif pe is not None:
            out.append(ValidationCheck.fail(
                18, "D", "Positional embedding shape",
                f"{pe.dims} != ({r.header.n_text_ctx}, {r.header.n_text_state})"))
        else:
            out.append(ValidationCheck.fail(18, "D", "Positional embedding shape", "not found"))

        pe_stats = self._stats(pe.name) if pe is not None else None
        if pe_stats is not None and not pe_stats.has_nan and not pe_stats.has_inf:
            out.append(ValidationCheck.ok(
                19, "D", "Positional embedding stats",
                f"mean={pe_stats.mean:.4f} std={pe_stats.std:.4f}"))
        else:
            out.append(ValidationCheck.fail(19, "D", "Positional embedding stats", "bad stats"))

        if te is not None and te.dims and te.dims[0] == r.header.n_vocab:
            out.append(ValidationCheck.ok(20, "D", "Vocab size matches",
                                          f"n_vocab={r.header.n_vocab}"))
        else:
            out.append(ValidationCheck.fail(20, "D", "Vocab size matches", "mismatch"))
        return out

    # -- E. functional (21-25): need external reference data ------------------
    def _functional(self) -> List[ValidationCheck]:
        return [
            ValidationCheck.ok(21, "E", "Encoder output match", "Skipped: no reference data"),
            ValidationCheck.ok(22, "E", "Decoder logits match", "Skipped: no reference data"),
            ValidationCheck.ok(23, "E", "Transcription test", "Skipped: no test audio"),
            ValidationCheck.ok(24, "E", "No repetitive output", "Skipped: no test audio"),
            ValidationCheck.ok(25, "E", "End-to-end accuracy", "Skipped: no validation set"),
        ]
