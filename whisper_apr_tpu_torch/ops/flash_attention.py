"""Tiled attention with an online softmax (K16): port of
``whisper_apr_tpu/ops/flash_attention.py``.

``flash_attention`` computes, per (batch, head), ``softmax(q kᵀ ·
sm_scale) v`` over q/k/v ``[B, H, T, d]`` in the flash kernel's
arithmetic, which is not ``basic.mha``'s: the scores are the f32 sum of
the inputs' products scaled AFTER the product (``mha`` scales q in the
compute dtype first), and p is rounded to v's dtype before ``p · v``
(its sum stays f32), so in bf16 the two differ by rounding. Keys at or
past ``kv_valid``, and with ``causal`` keys past the query row, score
-0.7 * f32max; a row whose sum is 0 divides by 1. ``mha_flash`` is the
same over combined heads ``[B, T, H * d]``, the layout of
``basic.mha``.

The JAX signature's ``block_q`` / ``block_k`` are the TPU kernel's tiling
and are not taken here: the CUDA kernel picks its own tiles.
``flash_attention`` runs the hand-written CUDA kernel
(``csrc/flash_attention.cu``, head dim 64) for CUDA tensors, addressed by
strides so ``mha_flash`` transposes nothing, and the plain PyTorch
version below for CPU tensors. Both dtypes run on the tensor cores, f32
with every operand as three bf16 terms (six bf16 products a product).
The kernel may split the key tiles of a (query tile, head) over several
blocks and combine their partial sums in a second launch;
``flash_split`` decides how many (bf16 rows that are not 16-byte aligned
take a kernel that does not split).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import torch

from . import _build

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

# launches of the kernel in this process (reset by the caller): all, and
# those on f32 inputs (the three-term kernel)
LAUNCHES = {"flash_attention": 0, "flash_attention_f32": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# the tensor-core kernels' tiles (csrc FM_BQ, FA_BK), and the blocks of
# either an H100 holds at once (csrc FM_BLOCKS_PER_SM on each of 132 SMs)
BLOCK_Q, BLOCK_K = 128, 64
WAVE = 2 * 132
MAX_SPLITS = 4


class FlashSplit(NamedTuple):
    """``n_split`` blocks per (query tile, head), split ``s`` taking key
    tiles [s * split_tiles, (s + 1) * split_tiles)."""
    n_split: int
    split_tiles: int

    def key_ranges(self, Tk: int) -> List[Tuple[int, int]]:
        """The [start, end) keys of each split."""
        w = self.split_tiles * BLOCK_K
        return [(s * w, min(Tk, (s + 1) * w)) for s in range(self.n_split)]


def flash_split(B: int, H: int, Tq: int, Tk: int) -> FlashSplit:
    """How the tensor-core kernels (bf16, and f32 as three bf16 terms: the
    same tiles, two blocks an SM) split the keys: where B * H * ceil(Tq /
    128) blocks fill at most half of one wave (the ``WAVE`` blocks the card
    holds at once), each (query tile, head) takes as many blocks as still
    fit in that wave, at most ``MAX_SPLITS``, in whole key tiles, none
    empty; else one. At 1500 frames whisper-tiny's 6 heads at B=1 (72
    blocks) split in three; large-v3's 20 at B=1 (240) do not."""
    blocks = B * H * math.ceil(Tq / BLOCK_Q)
    tiles = math.ceil(Tk / BLOCK_K)
    n = 1 if 2 * blocks > WAVE else min(MAX_SPLITS, tiles, WAVE // blocks)
    per = math.ceil(tiles / n)
    return FlashSplit(math.ceil(tiles / per), per)


def _resolve(q, k, sm_scale, kv_valid):
    d, Tk = q.shape[-1], k.shape[2]
    sm_scale = d ** -0.5 if sm_scale is None else float(sm_scale)
    kv_valid = Tk if kv_valid is None else int(kv_valid)
    if not 1 <= kv_valid <= Tk:
        raise ValueError(f"kv_valid {kv_valid} outside [1, {Tk}]")
    return sm_scale, kv_valid


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          sm_scale: Optional[float] = None,
                          causal: bool = False,
                          kv_valid: Optional[int] = None,
                          out: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    sm_scale, kv_valid = _resolve(q, k, sm_scale, kv_valid)
    Tq, Tk = q.shape[2], k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    col = torch.arange(Tk, device=q.device)[None, :]
    mask = col < kv_valid
    if causal:
        mask = mask & (col <= torch.arange(Tq, device=q.device)[:, None])
    s = torch.where(mask, s, MASK_VALUE)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    o = (o / torch.where(l == 0, 1.0, l)).to(q.dtype)
    if out is None:
        return o
    out.copy_(o)
    return out


def _flash_cuda(q, k, v, sm_scale, causal, kv_valid, out):
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share one dtype, f32 or bf16: "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    B, H, Tq, d = q.shape
    Tk = k.shape[2]
    if d != 64 or k.shape != (B, H, Tk, d) or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: want [B, H, T, 64]")
    if out is None:
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
    elif out.shape != q.shape or out.dtype != q.dtype:
        raise ValueError(f"out must be {tuple(q.shape)} {q.dtype}")
    for name, t in dict(q=q, k=k, v=v, out=out).items():
        if t.device != q.device or t.stride(-1) != 1:
            raise ValueError(f"{name} must be on {q.device} with its last "
                             "dim contiguous")
    plan = FlashSplit(1, math.ceil(Tk / BLOCK_K))
    part_acc = part_ml = None
    f32 = q.dtype == torch.float32
    if f32 or all(                        # bf16: the tensor-core kernel's rows
            t.data_ptr() % 16 == 0 and all(x % 8 == 0 for x in t.stride()[:3])
            for t in (q, k, v, out)):
        plan = flash_split(B, H, Tq, Tk)
        if plan.n_split > 1:
            rows = plan.n_split * B * H * Tq
            part_acc = torch.empty(rows * d, dtype=torch.float32,
                                   device=q.device)
            part_ml = torch.empty(rows * 2, dtype=torch.float32,
                                  device=q.device)
    P_ = _build.ptr
    rc = _build.library().wa_flash_attention(
        *(x for t in (q, k, v, out) for x in (P_(t), *t.stride()[:3])),
        _build.DTYPE_CODES[q.dtype], B, H, Tq, Tk, kv_valid, sm_scale,
        int(causal), *plan, P_(part_acc), P_(part_ml), _build.stream())
    _build.check(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    LAUNCHES["flash_attention_f32"] += f32
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: Optional[float] = None, causal: bool = False,
                    kv_valid: Optional[int] = None,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K16: q [B, H, Tq, d], k/v [B, H, Tk, d] (f32 or bf16, one dtype)
    -> [B, H, Tq, d] in q's dtype. ``sm_scale`` defaults to d**-0.5,
    ``kv_valid`` (1 <= kv_valid <= Tk) to Tk. ``out``, if given, is
    written and returned (any strides with the last dim contiguous)."""
    sm_scale, kv_valid = _resolve(q, k, sm_scale, kv_valid)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, sm_scale, causal, kv_valid,
                                     out)
    if q.device.type == "cuda":
        return _flash_cuda(q, k, v, sm_scale, causal, kv_valid, out)
    raise ValueError(f"no kernel for device {q.device}")


def mha_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              n_heads: int, causal: bool = False) -> torch.Tensor:
    """``flash_attention`` over combined heads: q [B, Tq, D], k/v
    [B, Tk, D] -> [B, Tq, D] (the layout of ``basic.mha``)."""
    B, Tq, D = q.shape
    Tk = k.shape[1]
    hd = D // n_heads

    def heads(t, T):
        return t.reshape(B, T, n_heads, hd).transpose(1, 2)
    out = torch.empty((B, Tq, D), dtype=q.dtype, device=q.device)
    flash_attention(heads(q, Tq), heads(k, Tk), heads(v, Tk), causal=causal,
                    out=heads(out, Tq))
    return out
