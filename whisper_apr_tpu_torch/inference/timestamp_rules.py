"""Whisper's timestamp decoding grammar: port of
``whisper_apr_tpu/inference/timestamp_rules.py``.

OpenAI's ApplyTimestampRules, as [B, V] masks built from a small
per-sequence state:

  1. the FIRST sampled token must be a timestamp, capped at
     ``MAX_INITIAL_TIMESTAMP_STEPS`` (1.0 s);
  2. timestamps come in pairs: after a lone timestamp the next token must
     be a timestamp or EOT; after a pair the next must be text;
  3. timestamps never decrease;
  4. when the total probability mass on timestamp tokens exceeds the best
     text token's, a timestamp must be sampled.

Each masked entry adds ``finfo(float32).min``; two such masks sum to -inf,
as in the JAX package (not clamped).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NEG = torch.finfo(torch.float32).min
MAX_INITIAL_TIMESTAMP_STEPS = 50  # 1.0 s at 20 ms per step


class TimestampState(NamedTuple):
    """Per-sequence grammar state."""

    last_was_ts: torch.Tensor      # [B] bool: previous token a timestamp
    penult_was_ts: torch.Tensor    # [B] bool: the one before too
    max_ts: torch.Tensor           # [B] int32: highest timestamp id emitted
    n_sampled: torch.Tensor        # [B] int32: tokens sampled so far


def init_state(batch: int, device=None) -> TimestampState:
    def z(dtype):
        return torch.zeros(batch, dtype=dtype, device=device)
    return TimestampState(z(torch.bool), z(torch.bool), z(torch.int32),
                          z(torch.int32))


def _neg_where(cond: torch.Tensor) -> torch.Tensor:
    """NEG where ``cond``, else 0 (f32)."""
    return torch.where(cond, NEG, 0.0)


def apply_rules(logits: torch.Tensor, state: TimestampState,
                timestamp_base: int, eot: int,
                is_first: torch.Tensor) -> torch.Tensor:
    """Mask [B, V] f32 logits per the grammar. ``is_first`` [B] marks the
    first sampled position of each sequence."""
    B, V = logits.shape
    ids = torch.arange(V, device=logits.device)
    is_ts = ids >= timestamp_base                          # [V]
    is_text = (ids < timestamp_base) & (ids != eot)

    # rule 1: the first token is a timestamp within the initial cap
    cap = timestamp_base + MAX_INITIAL_TIMESTAMP_STEPS
    first_block = is_text | (ids == eot) | (ids > cap)
    mask = _neg_where(is_first[:, None] & first_block[None, :])

    # with fewer than 2 sampled tokens the penultimate counts as a
    # timestamp, so the opening <|t0|> is followed by text
    penult_eff = state.penult_was_ts | (state.n_sampled < 2)
    # rule 2a: after a segment-closing lone timestamp: timestamp or EOT
    lone = state.last_was_ts & ~penult_eff
    mask = mask + _neg_where(lone[:, None] & is_text[None, :])
    # rule 2b: after a boundary pair (or the opening timestamp): text
    pair = state.last_was_ts & penult_eff
    mask = mask + _neg_where(pair[:, None] & is_ts[None, :])

    # rule 3: right after a lone closing timestamp its pair partner may
    # repeat it; elsewhere the next timestamp strictly increases. max_ts
    # 0 means none sampled yet: no constraint
    has_ts = state.max_ts > 0
    min_allowed = state.max_ts + torch.where(lone, 0, 1).to(torch.int32)
    floor = torch.where(has_ts, min_allowed, torch.zeros_like(min_allowed))
    below = ids[None, :] < floor[:, None]
    mask = mask + _neg_where(below & is_ts[None, :])

    masked = logits + mask

    # rule 4: P(any timestamp) > max P(any other id, EOT included) forces
    # a timestamp (OpenAI: logits[k, : timestamp_begin] = -inf)
    below_ts = ids < timestamp_base
    logp = torch.log_softmax(masked, dim=-1)
    ts_lse = torch.logsumexp(torch.where(is_ts[None, :], logp, NEG), dim=-1)
    text_max = torch.where(below_ts[None, :], logp, NEG).amax(dim=-1)
    force_ts = ts_lse > text_max
    return masked + _neg_where(force_ts[:, None] & below_ts[None, :])


def update_state(state: TimestampState, token: torch.Tensor,
                 timestamp_base: int) -> TimestampState:
    """Advance the grammar state after sampling ``token`` [B]."""
    tok_is_ts = token >= timestamp_base
    tok = token.to(torch.int32)
    return TimestampState(
        last_was_ts=tok_is_ts,
        penult_was_ts=state.last_was_ts,
        max_ts=torch.where(tok_is_ts, torch.maximum(state.max_ts, tok),
                           state.max_ts),
        n_sampled=state.n_sampled + 1)
