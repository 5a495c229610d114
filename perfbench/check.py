"""The comparison that decides ``correct``.

Each sampled request's served tokens are run through the reference once
(teacher-forced over its prompt and the tokens the program emitted); at
every emitted position the gap is the reference's best logit among the
tokens greedy decoding may emit, less the logit of the token the program
emitted there. The number compared is the widest gap over the sample.
The control takes the program's place: at the same positions, the token
that a lower precision of the reference puts first, read by the f32
reference in the same way. Both are read in every run: the program's has
to lie under the limit and the control's above it, since a sample on
which the control would pass cannot tell a fault from a sound run.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from .reference.whisper import Whisper, fp8_rows, full_f32


@dataclasses.dataclass
class Item:
    audio: np.ndarray          # what the request carried (host samples)
    tokens: List[int]          # prompt + emitted tokens
    prompt_len: int


@dataclasses.dataclass
class Gaps:
    widest: float              # over every emitted token of the sample
    per_item: List[float]
    n_tokens: int
    control_widest: float      # the control's, at the same positions


def sample(rng_seed: int, n_done: int, lengths: Sequence[int], k: int
           ) -> List[int]:
    """Indices of ``k`` finished requests drawn from the seed, the longest
    among them."""
    if n_done == 0:
        return []
    longest = int(np.argmax(lengths))
    rng = np.random.default_rng([int(rng_seed) & (2 ** 64 - 1), 99])
    rest = [i for i in rng.permutation(n_done) if i != longest]
    return [longest] + [int(i) for i in rest[: k - 1]]


def gaps(w, dims, items: List[Item], allowed: int, block: int = 4) -> Gaps:
    """Widest gap of the program's tokens and of the fp8 control's against
    the f32 reference, ``block`` requests at a time. Token ids below
    ``allowed`` are those greedy decoding may emit."""
    ref = Whisper(w, dims.d_model, dims.heads, dims.n_mels,
                  2 * dims.n_audio_ctx)
    ctl = Whisper(w, dims.d_model, dims.heads, dims.n_mels,
                  2 * dims.n_audio_ctx, act=fp8_rows)
    per, ctl_worst, n_tok = [], 0.0, 0
    with torch.no_grad(), full_f32():
        for b0 in range(0, len(items), block):
            chunk = items[b0: b0 + block]
            mel = torch.stack([ref.log_mel(it.audio) for it in chunk])
            enc = ref.encode(mel)
            enc_c = ctl.encode(torch.stack([ctl.log_mel(it.audio)
                                            for it in chunk]))
            for j, it in enumerate(chunk):
                toks = torch.tensor(it.tokens, device=enc.device)[None]
                P = it.prompt_len
                lg = ref.logits(enc[j: j + 1], toks[:, :-1])[0, P - 1:,
                                                             :allowed]
                served = toks[0, P:]
                best = lg.max(dim=-1).values
                mine = lg.gather(1, served[:, None].clamp_max(
                    allowed - 1))[:, 0]
                # a token greedy decoding may not emit lies infinitely low
                mine = torch.where(served < allowed, mine,
                                   torch.full_like(mine, float("inf")) * -1)
                per.append(float((best - mine).max()))
                n_tok += int(served.numel())
                lc = ctl.logits(enc_c[j: j + 1], toks[:, :-1])[
                    0, P - 1:, :allowed]
                pick = lc.argmax(dim=-1)
                cg = best - lg.gather(1, pick[:, None])[:, 0]
                ctl_worst = max(ctl_worst, float(cg.max()))
            del mel, enc, enc_c
    return Gaps(max(per) if per else float("nan"), per, n_tok, ctl_worst)
