"""Decoding support: token suppression, timestamp rules, sampling and the
quality gates, beam search (the greedy loop itself is in
``model/decoder.py``)."""

from .processors import WhisperTokenSuppressor, suppression_bias

__all__ = ["WhisperTokenSuppressor", "suppression_bias"]
