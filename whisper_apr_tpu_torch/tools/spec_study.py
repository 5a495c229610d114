"""Speculative-decode value study: measure acceptance, model the gain.
Port of the root ``tools/spec_study.py``.

Speculative decoding is token-exact by construction; whether it pays
depends on how often the early-exit draft agrees with the full model,
and with random weights that rate means little. This study measures the
acceptance on weights with a controlled depth structure and turns it
into ms per token from step costs the caller measured.

Depth structure: after the first ``draft_layers`` layers every residual
contribution (the attention output projections and fc2, with their
biases) is scaled by ``gamma``. gamma = 1 is the unstructured random
model; gamma -> 0 approaches a network whose late layers refine rather
than rewrite the residual stream, the regime early exit relies on.

Cost model, from the full step time ``c_full`` and the vocab head's
``c_vocab`` (both measured on the device the estimate is for; there are
no defaults):

  c_draft ~ c_full * draft_layers / L + c_vocab
  a verify pass over k + 1 positions ~ c_full (one read of the weights)
  ms / token = (k * c_draft + c_full) / E,  E = accepted + 1 a round

Usage: python -m whisper_apr_tpu_torch.tools.spec_study
           [--c-full MS --c-vocab MS] [--device cpu]
(on the card by default; acceptance is a property of the weights, so
``--device cpu`` measures the same).
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.dispatch import resolve_device


def structured_params(cfg, gamma: float, draft_layers: int, seed: int = 0):
    """``init_params`` with the residual contributions of the layers past
    ``draft_layers`` scaled by ``gamma``."""
    from ..model.params import init_params
    p = init_params(cfg, seed=seed)
    blocks = p["decoder"]["blocks"]

    def damp(a: torch.Tensor) -> torch.Tensor:
        out = a.clone()
        out[draft_layers:] = out[draft_layers:] * gamma
        return out

    for grp in ("self_attn", "cross_attn"):
        blocks[grp]["o_w"] = damp(blocks[grp]["o_w"])
        blocks[grp]["o_b"] = damp(blocks[grp]["o_b"])
    blocks["fc2"]["w"] = damp(blocks["fc2"]["w"])
    blocks["fc2"]["b"] = damp(blocks["fc2"]["b"])
    return p


def measure_acceptance(cfg, params, draft_tokens: int, draft_layers: int,
                       n_clips: int = 4, max_len: int = 48,
                       device: str = "cuda") -> Tuple[float, float]:
    """(E, the mean tokens emitted a round, and the share of emitted
    tokens that were accepted drafts) over ``n_clips`` random encoder
    outputs."""
    from ..inference.speculative import speculative_greedy_generate
    from ..model.params import to_device
    device = resolve_device(device, "measure_acceptance")
    params = to_device(params, device)
    rng = np.random.default_rng(0)
    eot = cfg.n_vocab - 1
    rounds = accepted = emitted = 0
    for _ in range(n_clips):
        enc = torch.from_numpy(rng.normal(
            0, 0.5, (1, cfg.n_audio_ctx, cfg.n_text_state)
        ).astype(np.float32)).to(device)
        prompt = torch.full((1, 3), 5, dtype=torch.long, device=device)
        bias = torch.zeros(cfg.n_vocab, device=device)
        res = speculative_greedy_generate(
            params, enc, prompt, bias, eot, cfg, max_len=max_len,
            prompt_len=3, draft_tokens=draft_tokens,
            draft_layers=draft_layers)
        rounds += res.n_verify_passes
        accepted += res.n_accepted
        emitted += int(res.lengths[0]) - 3
    E = (accepted + rounds) / max(rounds, 1)   # accepted + 1 a round
    return E, accepted / max(emitted, 1)


def net_ms_per_token(E: float, k: int, L: int, draft_layers: int,
                     c_full: float, c_vocab: float) -> Tuple[float, float]:
    """(ms per emitted token, ms per draft step) under the cost model."""
    c_draft = c_full * draft_layers / L + c_vocab
    return (k * c_draft + c_full) / E, c_draft


def main(argv=None) -> int:
    from ..config import ModelConfig
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--c-full", type=float, default=None,
                   help="measured full decode step, ms")
    p.add_argument("--c-vocab", type=float, default=None,
                   help="measured vocab head, ms")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    device = resolve_device(a.device, "spec_study")
    costs: Optional[Tuple[float, float]] = (
        None if a.c_full is None or a.c_vocab is None
        else (a.c_full, a.c_vocab))
    cfg = ModelConfig(
        model_type="tiny", n_vocab=512, n_audio_ctx=32, n_audio_state=128,
        n_audio_head=4, n_audio_layer=2, n_text_ctx=64, n_text_state=128,
        n_text_head=4, n_text_layer=8, n_mels=80)
    L = cfg.n_text_layer
    Ld = L // 4
    k = 4
    head = f"L={L} draft_layers={Ld} draft_tokens={k}"
    if costs:
        c_draft = net_ms_per_token(1.0, k, L, Ld, *costs)[1]
        head += (f" c_full={costs[0]} ms c_vocab={costs[1]} ms "
                 f"(break-even E > {1 + k * c_draft / costs[0]:.2f})")
    print(head)
    print(f"{'gamma':>6} {'E/round':>8} {'acc%':>6}"
          + (f" {'ms/tok':>8} {'vs full':>8}" if costs else ""))
    with torch.inference_mode():
        for gamma in (1.0, 0.5, 0.2, 0.1, 0.05):
            params = structured_params(cfg, gamma, Ld)
            E, acc = measure_acceptance(cfg, params, k, Ld, device=device)
            row = f"{gamma:6.2f} {E:8.2f} {100 * acc:6.1f}"
            if costs:
                ms, _ = net_ms_per_token(E, k, L, Ld, *costs)
                row += (f" {ms:8.3f} "
                        f"{'WIN' if ms < costs[0] else 'lose':>8}")
            print(row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
