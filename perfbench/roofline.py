"""The yardstick's arithmetic: the card's peaks, model FLOPs, and the
floor of each hand-kernel launch on the served paths.

Copied from the port's ``utils/roofline.py`` (``encoder_flops``) and from
``chip_smoke.py`` (``bound``: each input byte read once and each output
byte written once over the HBM bandwidth, against the operations over the
peak of the units that run them), and kept here so that a change to the
program cannot move the yardstick.
"""

from __future__ import annotations

from .spec import Dims

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
PEAK_FLOPS = {"bfloat16": 989e12, "int8": 1979e12, "float32": 67e12}
HBM_BPS = 3.35e12
MFU_PEAK = PEAK_FLOPS["bfloat16"]


def encoder_flops(d: Dims) -> float:
    """Forward FLOPs of one 30 s window (matmuls only; 2 FLOP/MAC)."""
    D, L, S, M = d.d_model, d.encoder_layers, d.n_audio_ctx, d.n_mels
    conv = 2 * (2 * S) * 3 * M * D + 2 * S * 3 * D * D
    attn = L * (2 * S * 4 * D * D + 2 * 2 * S * S * D)
    ffn = L * 2 * S * 2 * D * d.ffn
    return conv + attn + ffn


def cross_kv_flops(d: Dims) -> float:
    """The cross K/V projections of one window, every decoder layer."""
    return d.decoder_layers * 2 * 2 * d.n_audio_ctx * d.d_model ** 2


def decoder_token_flops(d: Dims, pos: int) -> float:
    """One decoder token at position ``pos`` (attending over ``pos + 1``
    self rows and every encoder row), with the vocab projection."""
    D, L = d.d_model, d.decoder_layers
    linears = 2 * (4 * D * D + 2 * D * D + 2 * D * d.ffn)
    attn = 4 * (pos + 1) * D + 4 * d.n_audio_ctx * D
    return L * (linears + attn) + 2 * D * d.vocab


def prompt_flops(d: Dims, n_prompt: int) -> float:
    """The prompt prefill (every position's logits are not needed: the
    last one's vocab projection only)."""
    return sum(decoder_token_flops(d, p) - 2 * d.d_model * d.vocab
               for p in range(n_prompt)) + 2 * d.d_model * d.vocab


def admission_flops(d: Dims, n_prompt: int) -> float:
    return encoder_flops(d) + cross_kv_flops(d) + prompt_flops(d, n_prompt)


def bound_s(name: str, D: int, B: int, n_vocab: int = 0, rows: int = 0,
            cache_bytes: int = 2, scales: bool = False, act_bytes: int = 2,
            ffn: int = 0, compute: str = "bfloat16") -> float:
    """Seconds of one launch at its floor: ``chip_smoke.bound`` for the
    decode blocks and vocab heads. ``B`` rows, ``rows`` cache rows
    attended, summed over the rows; ``ffn`` the hidden width (4 D)."""
    ffn = ffn or 4 * D
    v_pad = n_vocab + (-n_vocab) % 128
    w_bytes, n_f32, flops = {
        "self_block": (4 * D * D, 10 * D, 8 * B * D * D),
        "cross_block": (2 * D * D, 6 * D, 4 * B * D * D),
        "ffn_block": (2 * D * ffn, 4 * D + 2 * ffn, 4 * B * D * ffn),
        "qmatvec_greedy_head": (D * v_pad, v_pad, 2 * B * D * v_pad),
        "qmatvec_stacked": (D * v_pad, v_pad, 2 * B * D * v_pad),
    }[name]
    row_bytes = D * cache_bytes + (4 if scales else 0)
    nbytes = w_bytes + 4 * n_f32 + 2 * rows * row_bytes + 2 * B * D * act_bytes
    flops += 4 * rows * D
    if name == "self_block":
        nbytes += 2 * B * (row_bytes + 4)        # the new k/v rows
    if name == "qmatvec_stacked":
        nbytes += B * v_pad * 4 - B * D * act_bytes   # f32 logits out
    if name == "qmatvec_greedy_head":
        nbytes += B * 12 - B * D * act_bytes          # token, max, lse
    return max(nbytes / HBM_BPS, flops / PEAK_FLOPS[compute])


def tick_floor_s(d: Dims, positions, self_bytes: int, self_scales: bool,
                 cross_bytes: int, cross_scales: bool, head: str) -> float:
    """Floor of one decode step's hand kernels (K5, K6, K7 every layer,
    then the vocab head) over the rows that need it: ``positions`` the
    live rows' positions (each attends over its ``pos`` cached rows)."""
    B = len(positions)
    if B == 0:
        return 0.0
    D = d.d_model
    rows = int(sum(positions))
    per_layer = (
        bound_s("self_block", D, B, rows=rows, cache_bytes=self_bytes,
                scales=self_scales)
        + bound_s("cross_block", D, B, rows=B * d.n_audio_ctx,
                  cache_bytes=cross_bytes, scales=cross_scales)
        + bound_s("ffn_block", D, B, ffn=d.ffn))
    return d.decoder_layers * per_layer + bound_s(head, D, B,
                                                  n_vocab=d.vocab)
