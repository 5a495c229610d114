"""Matmul over int8 weights (K17): port of
``whisper_apr_tpu/ops/int8_matmul.py``.

``int8_matmul`` computes y = (x @ wq) * scale with an f32 sum and the
result cast to x's dtype (per-column or one scale). Its output is rounded
to x's dtype BEFORE the bias add of ``linear_int8``, while the default
path (``basic.linear``) dequantizes ``q * s`` to x's dtype and multiplies
then: in bf16 the two round differently, in f32 they agree to the order
of the sums.

``USE_PALLAS_INT8`` (off by default, the JAX package's name) routes the
plain int8 linears of ``basic.linear`` through this kernel for CUDA
tensors. ``int8_matmul`` runs the hand-written CUDA kernel
(``csrc/int8_matmul.cu``) for CUDA tensors and the plain PyTorch
version below for CPU tensors. The JAX signature's block sizes are the
TPU kernel's tiling and are not taken. Every row count runs on the
tensor cores, f32 x as three bf16 terms whose sum is x (each product with
the exactly widened weight exact, the sums f32). At most 32 rows the
kernel splits K over the blocks of a thread block cluster and sums the
splits inside it, in the same launch and with no scratch; ``int8_plan``
says how. K8
(``qmatvec.qmatvec_stacked``) runs the same decode-row kernel with the
same plan, and K4 (``qmatvec.qmatvec_greedy_head``) with K whole and a
head epilogue in place of the store.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, NamedTuple, Optional, Tuple

import torch

from . import _build
from .quant import QTensor

# opt-in switch (see ops/basic.linear)
USE_PALLAS_INT8 = False

# launches of the kernel in this process (reset by the caller): all, and
# those of the tile kernel on f32 x (three bf16 terms), as the C entry
# point reports the kernel it launched
LAUNCHES = {"int8_matmul": 0, "int8_matmul_f32": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _scale_vector(scale: torch.Tensor, N: int) -> torch.Tensor:
    """The scale as f32 [1] (one for every column) or [N]."""
    s = torch.as_tensor(scale).reshape(-1)
    if s.numel() not in (1, N):
        raise ValueError(f"scale of {s.numel()} values for {N} columns: "
                         "want 1 or one per column")
    return s.float().contiguous()


def int8_matmul_plain(x: torch.Tensor, wq: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    s = _scale_vector(scale, wq.shape[1]).to(x.device)
    return ((x.float() @ wq.float()) * s).to(x.dtype)


def _check_operands(x, wq, s, N):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be f32 or bf16, got {x.dtype}")
    if wq.dtype != torch.int8:
        raise TypeError(f"weights must be int8, got {wq.dtype}")
    if x.dim() != 2 or wq.dim() != 2 or x.shape[1] != wq.shape[0] \
            or x.shape[0] < 1:
        raise ValueError(f"shapes x {tuple(x.shape)}, wq {tuple(wq.shape)}:"
                         " want [M >= 1, K], [K, N]")
    for name, t in dict(x=x, wq=wq, scale=s).items():
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor on "
                             f"{x.device}")


# the decode-row kernel (csrc/int8_matmul.cu int8_mv_mma_kernel): a
# block owns STRIP output columns and a range of K rows, in 16-row steps
# taken by its WARPS warps in turn (4 where K is whole); the splits of a
# strip form one cluster (at most MAX_SPLIT blocks)
DECODE_ROWS = 32       # at most this many rows of x take it (one launch
                       # of K8, _build.MAX_ROWS)
STRIP = 128
STEP = 16
WARPS = 8
MAX_SPLIT = 16
BLOCKS = 132           # blocks a launch aims at: one an SM of an H100 ...
BLOCKS_WIDE = 96       # ... and above 16 rows, where a block holds its SM
                       # alone (200+ registers a thread)


class SplitPlan(NamedTuple):
    """``n_split`` blocks per column strip, split ``s`` taking K rows
    [s * split_rows, (s + 1) * split_rows) (``int8_plan``; K18's
    ``int4_plan``)."""
    n_split: int
    split_rows: int

    def k_ranges(self, K: int) -> List[Tuple[int, int]]:
        """The [start, end) K rows of each split."""
        r = self.split_rows
        return [(s * r, min(K, (s + 1) * r)) for s in range(self.n_split)]


def int8_plan(M: int, K: int, N: int) -> SplitPlan:
    """How the int8 kernels spread K over blocks. Above ``DECODE_ROWS``
    rows (K17's tile kernel): one block per output tile, K whole. Else
    each strip of ``STRIP`` columns takes enough splits for about
    ``BLOCKS`` blocks (``BLOCKS_WIDE`` above 16 rows), at most
    ``MAX_SPLIT`` (the splits are summed inside their cluster, in the
    same launch: no scratch), in whole 16-row steps, none empty; a split
    of more steps than the block has warps takes whole rounds of them, so
    no warp waits on one load more than the others. The scan step's
    projections take 4-12 splits where one block a strip would leave
    most of the card idle; the vocab's 406 strips are not split."""
    if M > DECODE_ROWS:
        return SplitPlan(1, K)
    blocks = BLOCKS if M <= 16 else BLOCKS_WIDE
    want = max(1, min(MAX_SPLIT, blocks // math.ceil(N / STRIP)))
    steps = math.ceil(K / STEP / want)
    if steps > WARPS:
        steps = WARPS * math.ceil(steps / WARPS)
    rows = STEP * steps
    return SplitPlan(math.ceil(K / rows), rows)


def _int8_cuda(x, wq, scale):
    M, K = x.shape
    N = wq.shape[1]
    s = _scale_vector(scale, N)
    _check_operands(x, wq, s, N)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    P = _build.ptr
    tile = ctypes.c_int(0)     # the C entry sets it: 1 for the tile kernel
    rc = _build.library().wa_int8_matmul(
        P(x), _build.DTYPE_CODES[x.dtype], M, K, P(wq), N, P(s), s.numel(),
        P(y), *int8_plan(M, K, N), ctypes.addressof(tile), _build.stream())
    _build.check(rc, "int8_matmul")
    LAUNCHES["int8_matmul"] += 1
    LAUNCHES["int8_matmul_f32"] += x.dtype == torch.float32 and tile.value
    return y


def int8_matmul(x: torch.Tensor, wq: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """K17: x [M, K] (f32 or bf16) @ int8 wq [K, N], times scale (one
    value, or one per column: any shape of 1 or N values); f32 sum; [M, N]
    in x's dtype."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, wq, scale)
    if x.device.type == "cuda":
        return _int8_cuda(x, wq, scale)
    raise ValueError(f"no kernel for device {x.device}")


def takes(w: QTensor) -> bool:
    """Whether a QTensor is one K17 computes: plain int8 [K, N] with one
    scale or one per column. Group-scaled, asymmetric, k-quant and int4
    QTensors are not (``basic.linear`` dequantizes them)."""
    return (not w.int4 and w.group is None and w.zero is None
            and not w.kpack and w.q.dim() == 2
            and w.scale.numel() in (1, w.q.shape[1]))


def linear_int8(x: torch.Tensor, qt: QTensor,
                b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Linear layer over an int8 QTensor through K17: x [..., K] ->
    [..., N]; the bias, cast to the output's dtype, is added after the
    kernel's cast."""
    lead = x.shape[:-1]
    y = int8_matmul(x.reshape(-1, x.shape[-1]).contiguous(), qt.q, qt.scale)
    if b is not None:
        y = y + b.to(y.dtype)
    return y.reshape(lead + (y.shape[-1],))
