"""Plain float32 Whisper: log-mel, encoder and the teacher-forced decoder,
from the benchmark's drawn weights.

Written from the published architecture (OpenAI's Whisper, HF's
``WhisperForConditionalGeneration``): a log-mel front end over a periodic
Hann window, 400-point frames every 160 samples without centering (the
served program's framing), a Slaney-normalised mel filterbank, log10
floored 8 below the window's maximum and scaled by (x + 4) / 4, the frames
past the audio at -1; two GELU convolutions (k 3; stride 1, then 2),
sinusoidal positions, pre-norm blocks (LayerNorm eps 1e-5, heads of 64
scaled by 64 ** -0.5, exact GELU), a final LayerNorm; a decoder with
learned positions, causal self-attention, cross-attention and the vocab
projection tied to the token embedding. Int8 weights are widened to f32
here (value times scale); nothing of the program is imported or read.

``act`` rounds every activation the model stores: each matmul's
activation operand (both operands of the attention products) and the
residual stream after each block's additions: the identity for the
reference, a lower precision for the control.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

N_FFT = 400
HOP = 160
SAMPLE_RATE = 16_000
LN_EPS = 1e-5


@contextlib.contextmanager
def full_f32():
    """TF32 off for matmuls and convolutions (restored after)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def slaney_mel_filters(n_mels: int, n_fft: int = N_FFT,
                       sr: int = SAMPLE_RATE) -> torch.Tensor:
    """[n_mels, n_fft // 2 + 1] triangles on the Slaney mel scale (linear
    to 1 kHz at 200/3 Hz a mel, then logarithmic at ln(6.4) / 27 a mel),
    each scaled to unit area (2 / its width in Hz), in float64."""
    f_sp, brk = 200.0 / 3.0, 1000.0
    brk_mel = brk / f_sp
    step = math.log(6.4) / 27.0

    def to_mel(f):
        return torch.where(f >= brk, brk_mel + torch.log(f / brk) / step,
                           f / f_sp)

    def to_hz(m):
        return torch.where(m >= brk_mel, brk * torch.exp(step * (m - brk_mel)),
                           m * f_sp)

    freqs = torch.linspace(0, sr / 2, n_fft // 2 + 1, dtype=torch.float64)
    edges = to_hz(torch.linspace(0.0, float(to_mel(torch.tensor(
        sr / 2, dtype=torch.float64))), n_mels + 2, dtype=torch.float64))
    lo, mid, hi = edges[:-2, None], edges[1:-1, None], edges[2:, None]
    up = (freqs[None] - lo) / (mid - lo)
    down = (hi - freqs[None]) / (hi - mid)
    tri = torch.clamp(torch.minimum(up, down), min=0.0)
    return tri * (2.0 / (hi - lo))


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 with a scale per row (the last axis's absmax to 448),
    back in x's dtype: the control's activations."""
    amax = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    s = 448.0 / amax
    return (x * s).to(torch.float8_e4m3fn).to(x.dtype) / s


class Whisper:
    """The reference model over ``w`` (``perfbench.weights.draw``'s
    names), on ``w``'s device."""

    def __init__(self, w: Dict[str, object], d_model: int, heads: int,
                 n_mels: int, n_frames: int = 3000,
                 act: Optional[Callable] = None) -> None:
        self.w = w
        self.D, self.H, self.M = d_model, heads, n_mels
        self.n_frames = n_frames
        self.act = act or _identity
        self.dev = w["enc.conv1.w"].device
        self.mel_fb = slaney_mel_filters(n_mels).float().to(self.dev)
        n = torch.arange(N_FFT, dtype=torch.float64)
        self.window = (0.5 - 0.5 * torch.cos(2 * math.pi * n / N_FFT)
                       ).float().to(self.dev)

    # -- weights ------------------------------------------------------------
    def _w(self, name: str, layer: Optional[int] = None) -> torch.Tensor:
        v = self.w[name]
        if isinstance(v, tuple):
            q, s = v
            if layer is not None:
                q, s = q[layer], s[layer]
            return q.float() * s.float()
        return (v if layer is None else v[layer]).float()

    def _linear(self, x, name, layer, bias=True):
        y = self.act(x) @ self._w(name, layer)
        return y + self._w(name + ".b", layer) if bias else y

    @staticmethod
    def _ln(x, w, b):
        return F.layer_norm(x, (x.shape[-1],), w, b, LN_EPS)

    def _attend(self, q, k, v, causal: bool):
        B, Tq, D = q.shape
        Tk = k.shape[1]
        hd = D // self.H
        q = q.reshape(B, Tq, self.H, hd).transpose(1, 2) * hd ** -0.5
        k = k.reshape(B, Tk, self.H, hd).transpose(1, 2)
        v = v.reshape(B, Tk, self.H, hd).transpose(1, 2)
        s = self.act(q) @ self.act(k).transpose(-1, -2)
        if causal:
            mask = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).tril()
            s = s.masked_fill(~mask, float("-inf"))
        p = torch.softmax(s, dim=-1)
        o = self.act(p) @ self.act(v)
        return o.transpose(1, 2).reshape(B, Tq, D)

    # -- front end ------------------------------------------------------------
    def log_mel(self, audio: np.ndarray) -> torch.Tensor:
        """30 s of ``audio`` (zero-padded or cut) -> [n_frames, n_mels]."""
        n = self.n_frames * HOP
        a = np.zeros(n, np.float32)
        m = min(n, len(audio))
        a[:m] = audio[:m]
        x = torch.from_numpy(a).to(self.dev)
        frames = x.unfold(0, N_FFT, HOP) * self.window        # [T, 400]
        spec = torch.fft.rfft(frames, dim=-1)
        power = spec.real ** 2 + spec.imag ** 2
        mel = power @ self.mel_fb.T
        lm = torch.log10(mel.clamp_min(1e-10))
        lm = torch.maximum(lm, lm.max() - 8.0)
        lm = (lm + 4.0) / 4.0
        out = torch.full((self.n_frames, self.M), -1.0, device=self.dev)
        out[: lm.shape[0]] = lm[: self.n_frames]
        return out

    # -- encoder ------------------------------------------------------------
    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        """[B, n_frames, n_mels] -> [B, n_frames // 2, d_model]."""
        x = mel.transpose(1, 2)
        x = F.gelu(F.conv1d(self.act(x.transpose(1, 2)).transpose(1, 2),
                            self._w("enc.conv1.w"), self._w("enc.conv1.b"),
                            padding=1))
        x = F.gelu(F.conv1d(self.act(x.transpose(1, 2)).transpose(1, 2),
                            self._w("enc.conv2.w"), self._w("enc.conv2.b"),
                            stride=2, padding=1))
        x = x.transpose(1, 2)
        S = x.shape[1]
        x = x + self._sinusoids(S)
        L = self.w["enc.ln1.w"].shape[0]
        for l in range(L):
            h = self._ln(x, self._w("enc.ln1.w", l), self._w("enc.ln1.b", l))
            q = self._linear(h, "enc.attn.q", l)
            k = self._linear(h, "enc.attn.k", l)
            v = self._linear(h, "enc.attn.v", l)
            x = self.act(x + self._linear(self._attend(q, k, v, False),
                                          "enc.attn.o", l))
            h = self._ln(x, self._w("enc.ln2.w", l), self._w("enc.ln2.b", l))
            h = F.gelu(self._linear(h, "enc.fc1", l))
            x = self.act(x + self._linear(h, "enc.fc2", l))
        return self._ln(x, self._w("enc.ln_post.w"), self._w("enc.ln_post.b"))

    def _sinusoids(self, length: int) -> torch.Tensor:
        half = self.D // 2
        inc = math.log(10_000.0) / (half - 1)
        inv = torch.exp(-inc * torch.arange(half, dtype=torch.float64))
        t = torch.arange(length, dtype=torch.float64)[:, None] * inv[None]
        return torch.cat([t.sin(), t.cos()], dim=1).float().to(self.dev)

    # -- decoder ------------------------------------------------------------
    def logits(self, enc: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """Teacher-forced logits [B, T, V] of ``tokens`` [B, T] over the
        encoder output ``enc`` [B, S, D]."""
        T = tokens.shape[1]
        emb = self._w("dec.tok")                                # [V, D]
        x = emb[tokens] + self._w("dec.pos")[:T]
        L = self.w["dec.ln1.w"].shape[0]
        for l in range(L):
            h = self._ln(x, self._w("dec.ln1.w", l), self._w("dec.ln1.b", l))
            q = self._linear(h, "dec.self.q", l)
            k = self._linear(h, "dec.self.k", l)
            v = self._linear(h, "dec.self.v", l)
            x = self.act(x + self._linear(self._attend(q, k, v, True),
                                          "dec.self.o", l))
            h = self._ln(x, self._w("dec.ln2.w", l), self._w("dec.ln2.b", l))
            q = self._linear(h, "dec.cross.q", l)
            k = self._linear(enc, "dec.cross.k", l)
            v = self._linear(enc, "dec.cross.v", l)
            x = self.act(x + self._linear(self._attend(q, k, v, False),
                                          "dec.cross.o", l))
            h = self._ln(x, self._w("dec.ln3.w", l), self._w("dec.ln3.b", l))
            h = F.gelu(self._linear(h, "dec.fc1", l))
            x = self.act(x + self._linear(h, "dec.fc2", l))
        x = self._ln(x, self._w("dec.ln_post.w"), self._w("dec.ln_post.b"))
        return self.act(x) @ emb.T
