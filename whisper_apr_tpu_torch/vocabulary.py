# Copied from whisper_apr_tpu/vocabulary.py (host-side numpy, no JAX); keep the two in step.
"""Hotword boosting: token-trie prefix boosts + domain adaptation.

(reference: src/vocabulary/ — VocabularyTrie with apply_prefix_boost at
src/vocabulary/trie.rs:324, HotwordBooster, DomainAdapter, composed by
VocabularyCustomizer::apply(logits, context) at src/vocabulary/mod.rs:86.)

Boosts are applied to logits. The context-independent part (a
DomainAdapter's token boosts) folds into the decode loop's suppression
bias vector; the trie's context-dependent prefix boosts run on the host
per step (the engine's host-stepped hotword decode).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


class VocabularyTrie:
    """Token-sequence trie (reference: src/vocabulary/trie.rs)."""

    def __init__(self) -> None:
        self._root: Dict[int, dict] = {}
        self._n_phrases = 0

    def insert(self, token_ids: Sequence[int], boost: float) -> None:
        node = self._root
        for t in token_ids:
            node = node.setdefault(int(t), {})
        node["__boost__"] = float(boost)
        self._n_phrases += 1

    def __len__(self) -> int:
        return self._n_phrases

    def continuations(self, context: Sequence[int]) -> List[Tuple[int, float]]:
        """Next tokens continuing any phrase suffix of ``context``, with the
        boost of the (partial) phrase (reference: trie.rs:324
        apply_prefix_boost walks all suffixes)."""
        out: Dict[int, float] = {}
        context = [int(t) for t in context]
        for start in range(len(context) + 1):
            node = self._root
            ok = True
            for t in context[start:]:
                if t not in node:
                    ok = False
                    break
                node = node[t]
            if not ok:
                continue
            for tok, child in node.items():
                if tok == "__boost__":
                    continue
                boost = child.get("__boost__")
                if boost is None:
                    # partial phrase: propagate the max boost beneath
                    boost = _max_boost(child)
                out[tok] = max(out.get(tok, -np.inf), boost)
        return list(out.items())

    def apply_prefix_boost(self, logits: np.ndarray,
                           context: Sequence[int]) -> np.ndarray:
        out = np.array(logits, copy=True)
        for tok, boost in self.continuations(context):
            if 0 <= tok < out.shape[-1]:
                out[..., tok] += boost
        return out


def _max_boost(node: dict) -> float:
    best = node.get("__boost__", -np.inf)
    for k, child in node.items():
        if k != "__boost__":
            best = max(best, _max_boost(child))
    return best if np.isfinite(best) else 0.0


@dataclasses.dataclass
class Hotword:
    phrase: str
    boost: float = 5.0


class HotwordBooster:
    """Phrase-level boosting (reference: src/vocabulary/ HotwordBooster)."""

    def __init__(self, tokenizer, boost: float = 5.0) -> None:
        self.tokenizer = tokenizer
        self.default_boost = boost
        self.trie = VocabularyTrie()
        self.hotwords: List[Hotword] = []

    def add_hotword(self, phrase: str, boost: Optional[float] = None) -> None:
        b = self.default_boost if boost is None else boost
        ids = self.tokenizer.encode(" " + phrase.strip())
        if ids:
            self.trie.insert(ids, b)
            self.hotwords.append(Hotword(phrase, b))

    def apply(self, logits: np.ndarray, context: Sequence[int]) -> np.ndarray:
        return self.trie.apply_prefix_boost(logits, context)


class DomainAdapter:
    """Static per-token domain bias (reference: src/vocabulary/ DomainAdapter).

    Context-independent, so it folds directly into the on-device
    suppression-bias vector.
    """

    def __init__(self, n_vocab: int) -> None:
        self.n_vocab = n_vocab
        self._bias = np.zeros(n_vocab, dtype=np.float32)

    def boost_token(self, token_id: int, amount: float) -> None:
        if 0 <= token_id < self.n_vocab:
            self._bias[token_id] += amount

    def boost_words(self, tokenizer, words: Iterable[str],
                    amount: float = 2.0) -> None:
        for w in words:
            for t in tokenizer.encode(" " + w.strip()):
                self.boost_token(t, amount)

    def bias(self) -> np.ndarray:
        return self._bias.copy()


class VocabularyCustomizer:
    """Composes boosters (reference: src/vocabulary/mod.rs:86 apply)."""

    def __init__(self) -> None:
        self.boosters: List[HotwordBooster] = []
        self.adapters: List[DomainAdapter] = []

    def add_booster(self, b: HotwordBooster) -> None:
        self.boosters.append(b)

    def add_adapter(self, a: DomainAdapter) -> None:
        self.adapters.append(a)

    def static_bias(self, n_vocab: int) -> np.ndarray:
        """Context-independent bias for the decode loop."""
        bias = np.zeros(n_vocab, dtype=np.float32)
        for a in self.adapters:
            bias[: a.n_vocab] += a.bias()[:n_vocab]
        return bias

    def apply(self, logits: np.ndarray, context: Sequence[int]) -> np.ndarray:
        out = np.array(logits, copy=True)
        for a in self.adapters:
            n = min(out.shape[-1], a.n_vocab)
            out[..., :n] += a.bias()[:n]
        for b in self.boosters:
            out = b.apply(out, context)
        return out
