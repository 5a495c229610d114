"""Decode matvecs over int8 weights: port of
``whisper_apr_tpu/ops/qmatvec.py``.

- K4 ``qmatvec_greedy_head``: argmax_v (x @ vocab + bias) for each row of
  x [M, K] without a logits row. Returns per row the token (the FIRST
  index of the maximum, ``jnp.argmax``'s tie rule), the max logit and the
  logsumexp m + log(max(z, 1e-30)), so the chosen token's log-prob is
  max - logsumexp. Columns >= n_vocab (the lane padding) and suppressed
  (-inf bias) columns add nothing.
- K8 ``qmatvec_stacked``: y [M, N] = (x [M, K] @ wq[layer]) * scale[layer]
  over a stacked int8 [L, K, N] weight (``qmatvec`` for one [K, N]).
- K9 ``ffn_fused``: y [M, D] = gelu(x @ w1[layer] * s1[layer] +
  b1[layer]) @ w2[layer], the scan step's FFN; the caller applies fc2's
  scale and bias.

Each wrapper runs its hand-written CUDA kernel (K4 and K8
``csrc/int8_matmul.cu``, K17's decode-row kernel: K8 split as
``int8_matmul.int8_plan`` says, K4 with K whole and a head epilogue; K9
``csrc/ffn_batched.cu``, K7's tensor-core kernel, launched as
``decode_blocks.ffn_plan`` says) for CUDA tensors and the plain PyTorch
version below for CPU tensors. One launch takes at most
``_build.MAX_ROWS`` rows; a wrapper launches once per chunk of rows
(``_build.in_row_chunks``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .basic import gelu
from .decode_blocks import ffn_launch
from .int8_matmul import int8_plan

_STRIP = 128           # vocab columns a block of K4 owns (csrc Q8_STRIP)

# launches of each kernel in this process (reset by the caller)
LAUNCHES = {"qmatvec_greedy_head": 0, "qmatvec_stacked": 0, "ffn_fused": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def qmatvec_greedy_head_plain(x: torch.Tensor, wq: torch.Tensor,
                              bias: torch.Tensor, n_vocab: int
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    N = wq.shape[2]
    logit = x.float() @ wq[0].float() + bias.float()          # [M, N]
    col = torch.arange(N, device=x.device)
    logit = torch.where(col < n_vocab, logit,
                        torch.full_like(logit, float("-inf")))
    m = logit.amax(-1, keepdim=True)
    big = torch.full_like(col, 2 ** 30)
    tok = torch.where(logit == m, col, big).amin(-1).to(torch.int32)
    e = torch.where(logit == float("-inf"), torch.zeros_like(logit),
                    torch.exp(logit - m))
    z = e.sum(-1)
    lse = m[:, 0] + torch.log(torch.clamp_min(z, 1e-30))
    return tok, m[:, 0], lse


def qmatvec_stacked_plain(x: torch.Tensor, wq: torch.Tensor,
                          scale: torch.Tensor, layer: int,
                          out_dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    y = (x.float() @ wq[layer].float()) * scale[layer].float()
    return y.to(out_dtype or x.dtype)


def ffn_fused_plain(x: torch.Tensor, w1: torch.Tensor, s1: torch.Tensor,
                    b1: torch.Tensor, w2: torch.Tensor,
                    layer: int) -> torch.Tensor:
    l = layer
    h = (x.float() @ w1[l].float()) * s1[l] + b1[l]
    g = gelu(h).to(x.dtype)
    return (g.float() @ w2[l].float()).to(x.dtype)


def _check_rows(x: torch.Tensor, K: int) -> int:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be f32 or bf16, got {x.dtype}")
    M = x.shape[0] if x.dim() == 2 else 0
    if not (x.dim() == 2 and M >= 1 and x.shape[1] == K):
        raise ValueError(f"x must be [M, {K}] with M >= 1, got "
                         f"{tuple(x.shape)}")
    return M


def _check_on(device, **tensors) -> None:
    for name, t in tensors.items():
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor on "
                             f"{device}")


def _greedy_head_cuda(x, wq, bias, n_vocab):
    if wq.dtype != torch.int8 or bias.dtype != torch.float32:
        raise TypeError("vocab must be int8 and the bias f32")
    K, N = wq.shape[1], wq.shape[2]
    if wq.shape[0] != 1 or bias.shape != (1, N) or x.dim() != 2 \
            or x.shape[1] != K:
        raise ValueError(f"shapes x {tuple(x.shape)}, wq {tuple(wq.shape)}, "
                         f"bias {tuple(bias.shape)}: want [M, K], [1, K, N], "
                         "[1, N]")
    M = _check_rows(x, K)
    _check_on(x.device, x=x, wq=wq, bias=bias)
    dev, st = x.device, _build.stream()
    strips = -(-N // _STRIP)       # partials of each row: one a strip
    tok = torch.empty(M, dtype=torch.int32, device=dev)
    mx = torch.empty(M, dtype=torch.float32, device=dev)
    lse = torch.empty(M, dtype=torch.float32, device=dev)
    W = _build.workspace
    P = _build.ptr
    n_part = min(M, _build.MAX_ROWS) * strips
    # zero when allocated, and each launch leaves them zero: a partial
    # counts once the kernel has marked it written, never left over
    part = (W(st, dev, "head_part", 3 * n_part, torch.int64, zero=True),
            W(st, dev, "head_ticket", 1, torch.int64, zero=True))

    def launch(rows):
        r = rows.start                     # chunk = pointer offsets
        rc = _build.library().wa_greedy_head(
            P(x, r * K), _build.DTYPE_CODES[x.dtype], rows.stop - r, K,
            P(wq), N, P(bias), int(n_vocab), *part, P(tok, r), P(mx, r),
            P(lse, r), st)
        _build.check(rc, "qmatvec_greedy_head")
        LAUNCHES["qmatvec_greedy_head"] += 1

    _build.in_row_chunks(M, launch)
    return tok, mx, lse


def _stacked_cuda(x, wq, scale, layer, out_dtype):
    if wq.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError("weights must be int8 and the scale f32")
    L, K, N = wq.shape
    if scale.shape != (L, 1, N):
        raise ValueError(f"scale {tuple(scale.shape)} does not match "
                         f"wq {tuple(wq.shape)}")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside the {L}-layer stack")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out dtype must be f32 or bf16, got {out_dtype}")
    M = _check_rows(x, K)
    _check_on(x.device, x=x, wq=wq, scale=scale)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    P = _build.ptr
    st = _build.stream()

    def launch(rows):
        r = rows.start                     # chunk = pointer offsets
        m = rows.stop - r
        rc = _build.library().wa_qmatvec_stacked(
            P(x, r * K), _build.DTYPE_CODES[x.dtype], m, K,
            P(wq, layer * K * N), N, P(scale, layer * N), P(out, r * N),
            _build.DTYPE_CODES[out_dtype],
            *int8_plan(m, K, N), st)
        _build.check(rc, "qmatvec_stacked")
        LAUNCHES["qmatvec_stacked"] += 1

    _build.in_row_chunks(M, launch)
    return out


def _ffn_fused_cuda(x, w1, s1, b1, w2, layer):
    if w1.dtype != torch.int8 or w2.dtype != torch.int8 \
            or s1.dtype != torch.float32 or b1.dtype != torch.float32:
        raise TypeError("fc1/fc2 weights must be int8, s1 and b1 f32")
    L, D, H = w1.shape
    if tuple(w2.shape) != (L, H, D) or s1.shape != (L, 1, H) \
            or b1.shape != (L, 1, H):
        raise ValueError(f"w1 {tuple(w1.shape)}, s1 {tuple(s1.shape)}, b1 "
                         f"{tuple(b1.shape)}, w2 {tuple(w2.shape)}: want "
                         "[L, D, H], [L, 1, H], [L, 1, H], [L, H, D]")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside the {L}-layer stack")
    _check_rows(x, D)
    _check_on(x.device, x=x, w1=w1, s1=s1, b1=b1, w2=w2)
    out = torch.empty_like(x)
    P = _build.ptr

    def launch(rows, plan, ypart, tickets):
        r = rows.start                     # chunk = pointer offsets
        rc = _build.library().wa_ffn_fused(
            P(x, r * D), _build.DTYPE_CODES[x.dtype], rows.stop - r, D, H,
            P(w1, layer * D * H), P(s1, layer * H), P(b1, layer * H),
            P(w2, layer * H * D), P(out, r * D), *plan, ypart, tickets,
            _build.stream())
        _build.check(rc, "ffn_fused")
        LAUNCHES["ffn_fused"] += 1

    ffn_launch(x, H, launch)
    return out


def qmatvec_greedy_head(x: torch.Tensor, wq: torch.Tensor,
                        bias: torch.Tensor, n_vocab: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy vocab head (K4).

    x [M, K] (the vocab K-side scale already folded in); wq [1, K, N]
    int8 (N lane-padded >= n_vocab; the kernel takes N a multiple of 16
    up to 65536, every Whisper vocab); bias [1, N] f32 (real
    suppressions).
    Returns (token [M] int32, max_logit [M] f32, logsumexp [M] f32).
    """
    if x.device.type == "cpu":
        return qmatvec_greedy_head_plain(x, wq, bias, n_vocab)
    if x.device.type == "cuda":
        return _greedy_head_cuda(x, wq, bias, n_vocab)
    raise ValueError(f"no kernel for device {x.device}")


def qmatvec_stacked(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                    layer: int, out_dtype: Optional[torch.dtype] = None
                    ) -> torch.Tensor:
    """K8: x [M, K] @ wq[layer] with a per-channel scale, the layer a host
    int. wq [L, K, N] int8 (N a multiple of 32; the JAX kernel's 128);
    scale [L, 1, N] f32. Returns [M, N] in x.dtype or ``out_dtype``."""
    if x.device.type == "cpu":
        return qmatvec_stacked_plain(x, wq, scale, int(layer), out_dtype)
    if x.device.type == "cuda":
        return _stacked_cuda(x, wq, scale, int(layer), out_dtype)
    raise ValueError(f"no kernel for device {x.device}")


def qmatvec(x: torch.Tensor, wq: torch.Tensor, scale) -> torch.Tensor:
    """Unstacked convenience wrapper of K8: wq [K, N], scale [N] or a
    scalar."""
    K, N = wq.shape
    s = torch.broadcast_to(torch.as_tensor(scale, dtype=torch.float32,
                                           device=wq.device).reshape(1, -1),
                           (1, N))
    return qmatvec_stacked(x, wq[None], s[None].contiguous(), 0)


def ffn_fused(x: torch.Tensor, w1: torch.Tensor, s1: torch.Tensor,
              b1: torch.Tensor, w2: torch.Tensor, layer: int) -> torch.Tensor:
    """K9: y = gelu(x @ w1[l] * s1[l] + b1[l]) @ w2[l] with f32
    accumulation, the GELU output and the unscaled fc2 sum rounded to x's
    dtype. x [M, D] f32 or bf16; w1 [L, D, H] / w2 [L, H, D] int8; s1, b1
    [L, 1, H] f32; the layer a host int. Returns [M, D] in x.dtype; fc2's
    per-channel scale and bias are the caller's, in f32."""
    if x.device.type == "cpu":
        return ffn_fused_plain(x, w1, s1, b1, w2, int(layer))
    if x.device.type == "cuda":
        return _ffn_fused_cuda(x, w1, s1, b1, w2, int(layer))
    raise ValueError(f"no kernel for device {x.device}")
