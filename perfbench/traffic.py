"""The general traffic generator: requests and audio from a mix file and
``--seed``.

Every seed gets the same set of sizes and gaps in another order, so the
work of a run does not change with the seed: each block of ``block``
consecutive draws takes one value at the midpoint of each of ``block``
equal-probability strata, in an order the seed permutes. Arrivals of an
open loop are exponential gaps drawn so (a Poisson process with its
gaps' quantiles evened out, scaled so that a block's mean gap is exactly
1 / rate). The audio is slices of one synthetic recording made on the
device from the seed: voiced harmonics under a syllable-rate envelope,
with noise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch

SAMPLE_RATE = 16_000


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), stream])


def stratified_unit(rng: np.random.Generator, n: int, block: int
                    ) -> np.ndarray:
    """``n`` values in (0, 1): each block the ``block`` stratum midpoints
    (k + 0.5) / block in a seeded order."""
    mids = (np.arange(block) + 0.5) / block
    out = [rng.permutation(mids) for _ in range(-(-n // block))]
    return np.concatenate(out)[:n] if out else np.zeros(0)


def uniform(rng, n: int, block: int, lo: float, hi: float) -> np.ndarray:
    return lo + stratified_unit(rng, n, block) * (hi - lo)


def uniform_int(rng, n: int, block: int, lo: int, hi: int) -> np.ndarray:
    """Integers on [lo, hi], stratified."""
    u = stratified_unit(rng, n, block)
    return np.minimum(lo + np.floor(u * (hi - lo + 1)), hi).astype(np.int64)


def poisson_gaps(rng, n: int, block: int, rate: float) -> np.ndarray:
    """Exponential gaps at ``rate`` per second, stratified, each block's
    mean exactly 1 / rate."""
    mids = (np.arange(block) + 0.5) / block
    q = -np.log1p(-mids)
    q *= block / q.sum()
    out = [rng.permutation(q) for _ in range(-(-n // block))]
    return np.concatenate(out)[:n] / rate


@dataclasses.dataclass
class Request:
    index: int
    due: float            # seconds from the window's opening (< 0: preroll)
    offset: int           # first sample in the recording
    n_samples: int
    tokens: int           # tokens the request decodes (its max_tokens)

    @property
    def audio_s(self) -> float:
        return self.n_samples / SAMPLE_RATE


def serve_requests(mix: dict, seed: int, horizon_s: float,
                   rate: float = 0.0) -> List[Request]:
    """Open-loop requests due from ``-preroll_s`` to ``horizon_s`` after
    the window opens, at the mix's rate (or ``rate``). The window's
    requests start a block at its opening, so that every seed's window
    holds the same whole blocks of sizes and gaps; the preroll's are drawn
    from streams of their own, backwards from the opening."""
    if mix.get("arrivals") != "poisson":
        raise ValueError(f"unknown arrivals {mix.get('arrivals')!r}: the "
                         "generator draws Poisson arrivals only")
    rate = rate or float(mix["rate_rps"])
    block = int(mix["block"])
    pre = float(mix["preroll_s"])
    n = int(math.ceil(horizon_s * rate * 1.2)) + block
    due = np.cumsum(poisson_gaps(_rng(seed, 1), n, block, rate))
    n = int(np.searchsorted(due, horizon_s))
    m = int(math.ceil(pre * rate * 1.5)) + block
    back = np.cumsum(poisson_gaps(_rng(seed, 11), m, block, rate))
    back = back[back <= pre]
    dues = np.concatenate([-back[::-1], due[:n]])
    sizes = [_sizes(mix, seed, 10, len(back)), _sizes(mix, seed, 0, n)]
    secs = np.concatenate([sizes[0][0][::-1], sizes[1][0]])
    toks = np.concatenate([sizes[0][1][::-1], sizes[1][1]])
    lens = np.rint(secs * SAMPLE_RATE).astype(np.int64)
    room = int(mix["recording_s"] * SAMPLE_RATE) - lens
    offs = (_rng(seed, 4).random(len(dues)) * room).astype(np.int64)
    return [Request(i, float(dues[i]), int(offs[i]), int(lens[i]),
                    int(toks[i])) for i in range(len(dues))]


def _sizes(mix: dict, seed: int, stream: int, n: int):
    """Durations and token counts of ``n`` requests, stratified."""
    block = int(mix["block"])
    a = mix["audio_s"]
    secs = uniform(_rng(seed, stream + 2), n, block, a["lo"], a["hi"])
    t = mix["tokens"]
    if t["kind"] == "uniform":
        toks = uniform_int(_rng(seed, stream + 3), n, block, t["lo"],
                           t["hi"])
    elif t["kind"] == "per_second":
        per = uniform(_rng(seed, stream + 3), n, block, t["lo"], t["hi"])
        toks = np.clip(np.rint(secs * per), t["min"], t["max"]).astype(
            np.int64)
    else:
        raise ValueError(f"unknown token draw {t['kind']!r}")
    return secs, toks


def files(mix: dict, seed: int, n: int) -> List[Request]:
    """``n`` closed-loop files (``due`` 0), durations and max_tokens
    stratified over blocks of ``block`` files."""
    block = int(mix["block"])
    f = mix["file_s"]
    secs = uniform(_rng(seed, 2), n, block, f["lo"], f["hi"])
    m = mix["max_tokens"]
    toks = uniform_int(_rng(seed, 3), n, block, m["lo"], m["hi"])
    lens = np.rint(secs * SAMPLE_RATE).astype(np.int64)
    room = int(mix["recording_s"] * SAMPLE_RATE) - lens
    offs = (_rng(seed, 4).random(n) * room).astype(np.int64)
    return [Request(i, 0.0, int(offs[i]), int(lens[i]), int(toks[i]))
            for i in range(n)]


def recording(seed: int, seconds: float, device) -> np.ndarray:
    """A synthetic recording of ``seconds`` at 16 kHz, f32 on the host,
    made on ``device`` in a few large calls: per 0.25 s segment a pitch
    of 90-260 Hz and a level, harmonics 1-4 at falling amplitude, the
    level's envelope linear between segments, noise at -34 dB."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & (2 ** 63 - 1))
    n = int(seconds * SAMPLE_RATE)
    seg = SAMPLE_RATE // 4
    n_seg = n // seg + 2
    f0 = 90.0 + 170.0 * torch.rand(n_seg, generator=g, device=device,
                                   dtype=torch.float64)
    level = torch.rand(n_seg, generator=g, device=device,
                       dtype=torch.float64) ** 2
    idx = torch.arange(n, device=device, dtype=torch.float64) / seg
    lo = idx.floor().long()
    frac = idx - lo
    env = level[lo] * (1 - frac) + level[lo + 1] * frac
    phase = torch.cumsum(2 * math.pi * f0[lo] / SAMPLE_RATE, dim=0)
    voiced = sum(torch.sin(h * phase) / h for h in range(1, 5))
    noise = torch.randn(n, generator=g, device=device, dtype=torch.float64)
    x = 0.1 * env * voiced + 0.002 * noise
    return x.float().cpu().numpy()


def clip(rec: np.ndarray, req: Request) -> np.ndarray:
    return rec[req.offset: req.offset + req.n_samples]
