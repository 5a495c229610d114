"""The lowering probes P1-P3: port of the Pallas kernels of the JAX
package's ``tools/probe_layer_kernel.py`` (``int8dot_probe``,
``pallas_call`` at :427 and :447; ``tricks_probe``, at :479).

They ask which contractions run on the card and whether they are exact:
the question behind keeping int8 K/V rows int8 up to the tensor-core
fragments of the batched attention kernels (K5/K6) instead of casting
them in a separate pass.

- P1 ``int8_dot``: int8 [M, K] . int8 [K, N] -> int32, exact
  (``mma.sync`` m16n8k32 s8 over 32 x 32 tiles; ``int8_plan`` sizes its
  K chunks).
- P2 ``mixed_dot``: int8 [M, K] . bf16 [K, N] -> f32 (int8 converted to
  bf16 in registers, then ``mma.sync`` m16n8k16 bf16; ``mixed_plan``
  sizes its tiles and K chunks, as ``int8_plan`` P1's).
- P3 ``tricks_dot`` / ``tricks_transpose``: ``dot`` / ``dot_general``
  with an f32 result over f32, bf16 and int8 operands, the left operand
  given transposed (contracting its dim 0) and a leading batch axis;
  ``cast_a_bf16`` rounds an f32 left operand to bf16 in the kernel, as
  sub-probe (i)'s ``astype``. Any f32 operand keeps the contraction on
  the CUDA cores in f32 (tensor cores would round it to TF32); bf16 and
  int8 operands go to the tensor cores in bf16. The transpose is a 2-D
  f32 transpose.

Bound (``csrc/probe_mma.cu``): at the probes' shapes each call moves at
most a few MB and does at most 42 MFLOP: bounds of 0.1-3 us, under a
launch's latency. A CUDA tensor runs the kernel (or raises); a CPU tensor
runs the plain PyTorch version beside it. ``dot_plan`` sizes the f32
contraction's launch: its output tile and how K is split over blocks.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import torch

from . import _build

# launches of each probe's kernels in this process (reset by the caller);
# P3's contraction and transpose count together
LAUNCHES = {"int8_dot": 0, "mixed_dot": 0, "tricks": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _dims(a: torch.Tensor, b: torch.Tensor, trans_a: bool):
    """(batch, M, K, N) of ``a`` [(B,) M, K] (or [(B,) K, M]) . ``b``
    [(B,) K, N]; raises on a mismatch."""
    if a.dim() != b.dim() or a.dim() not in (2, 3):
        raise ValueError(f"operands [M, K] . [K, N] or [B, M, K] . "
                         f"[B, K, N]: got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    batch = a.shape[0] if a.dim() == 3 else 1
    if a.dim() == 3 and b.shape[0] != batch:
        raise ValueError(f"batch {batch} != {b.shape[0]}")
    K, M = a.shape[-2:] if trans_a else a.shape[-2:][::-1]
    if b.shape[-2] != K:
        raise ValueError(f"contracted dims differ: {tuple(a.shape)} "
                         f"(trans_a={trans_a}) . {tuple(b.shape)}")
    return batch, M, K, b.shape[-1]


def _check_cuda(*ts: torch.Tensor) -> None:
    for t in ts:
        if t.device.type != "cuda" or not t.is_contiguous() \
                or t.device != ts[0].device:
            raise ValueError("operands must be contiguous, on one CUDA "
                             "device")


def _check_device(a: torch.Tensor) -> None:
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {a.device}")


# ---------------------------------------------------------------------------
# P1
# ---------------------------------------------------------------------------

def int8_dot_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 . int8 -> int32, in float64 (exact: |sum| <= K * 127^2 stays
    under 2^53; PyTorch has no int32 matmul on the card)."""
    _dims(a, b, False)
    return torch.matmul(a.double(), b.double()).to(torch.int32)


# P1's K staging (csrc int8_mma_kernel): whole up to this depth, else a
# 2-stage ring of chunks this deep
I8_PANEL_K = 256
I8_RING_K = 128


def int8_plan(K: int) -> int:
    """The K that P1 stages at a time for a contraction of ``K``: K
    rounded up to 32, whole up to ``I8_PANEL_K``, else ``I8_RING_K``."""
    k = 32 * math.ceil(K / 32)
    return k if k <= I8_PANEL_K else I8_RING_K


def int8_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """P1: a [M, K] int8 . b [K, N] int8 -> [M, N] int32."""
    _check_device(a)
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_dot takes int8 operands: {a.dtype}, "
                        f"{b.dtype}")
    if a.device.type == "cpu":
        return int8_dot_plain(a, b)
    return _int8_cuda(a, b)


def _int8_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _, M, K, N = _dims(a, b, False)
    if a.dim() != 2:
        raise ValueError("int8_dot takes 2-D operands")
    _check_cuda(a, b)
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    rc = _build.library().wa_probe_int8_mma(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), M, K, N,
        int8_plan(K), _build.stream())
    _build.check(rc, "int8_dot")
    LAUNCHES["int8_dot"] += 1
    return out


# ---------------------------------------------------------------------------
# P2 and P3: contractions with an f32 result
# ---------------------------------------------------------------------------

# the tensor-core contraction's launch plan (csrc mixed_mma_kernel)
MX_SMEM = 48 * 1024       # a block's shared bytes, at most
MX_MIN_BLOCKS = 64        # the 64 x 64 tile only where it gives this many
MX_PANEL_K = 256          # K staged whole up to this depth
MX_RING_K = (128, 64, 32)   # else chunks this deep, the first that fits


class MixedPlan(NamedTuple):
    """A ``tile`` x ``tile`` output block (4 ``tile`` threads), K staged
    ``k_chunk`` at a time: whole, or through a 2-stage ring."""
    tile: int
    k_chunk: int


def mixed_stage_bytes(tile: int, k_chunk: int, trans_a: bool, a_size: int,
                      b_size: int) -> int:
    """Shared bytes of one stage (csrc ``mx_stage_bytes``): A [tile]
    [k_chunk] (``trans_a``: [k_chunk][tile]) and B [k_chunk][tile], each
    row 16 bytes longer, in the operands' own element sizes."""
    a = (k_chunk * (tile + 16 // a_size) if trans_a
         else tile * (k_chunk + 16 // a_size)) * a_size
    return a + k_chunk * (tile + 16 // b_size) * b_size


def mixed_smem(plan: MixedPlan, K: int, trans_a: bool, a_size: int,
               b_size: int) -> int:
    """A block's shared bytes (csrc ``mx_smem``): one stage, two when K
    takes more than one chunk; at least the second k group's sums."""
    stages = 2 if K > plan.k_chunk else 1
    return max(stages * mixed_stage_bytes(plan.tile, plan.k_chunk, trans_a,
                                          a_size, b_size),
               4 * plan.tile * plan.tile)


def mixed_plan(batch: int, M: int, K: int, N: int, trans_a: bool = False,
               a_size: int = 1, b_size: int = 2) -> MixedPlan:
    """The launch of P2 and P3 (b), (i) for [batch, M, K] . [batch, K, N]
    with elements of ``a_size`` and ``b_size`` bytes: the 64 x 64 tile
    where it gives at least ``MX_MIN_BLOCKS`` blocks, else 32 x 32 (256^3:
    64 blocks; P3 (b)'s 32 x 1280: 40); K rounded up to 32 and staged whole
    up to ``MX_PANEL_K`` where one stage fits in ``MX_SMEM``, else the
    deepest of ``MX_RING_K`` whose two stages fit."""
    tile = 64 if batch * math.ceil(M / 64) * math.ceil(N / 64) \
        >= MX_MIN_BLOCKS else 32
    whole = 32 * math.ceil(K / 32)
    if whole <= MX_PANEL_K and mixed_stage_bytes(
            tile, whole, trans_a, a_size, b_size) <= MX_SMEM:
        return MixedPlan(tile, whole)
    for k_chunk in MX_RING_K:
        if 2 * mixed_stage_bytes(tile, k_chunk, trans_a, a_size,
                                 b_size) <= MX_SMEM:
            break
    return MixedPlan(tile, k_chunk)


def _mma(a, b, trans_a, dims) -> torch.Tensor:
    """The tensor-core kernel (bf16 products, f32 sums), at
    ``mixed_plan``."""
    batch, M, K, N = dims
    _check_cuda(a, b)
    out = torch.empty(((batch,) if a.dim() == 3 else ()) + (M, N),
                      dtype=torch.float32, device=a.device)
    plan = mixed_plan(batch, M, K, N, trans_a, a.element_size(),
                      b.element_size())
    rc = _build.library().wa_probe_mma_bf16(
        a.data_ptr(), _build.DTYPE_CODES[a.dtype], int(trans_a),
        b.data_ptr(), _build.DTYPE_CODES[b.dtype], out.data_ptr(), batch,
        M, K, N, *plan, _build.stream())
    _build.check(rc, "probe mma")
    return out


def _plain_contract(a, b, trans_a, cast_a_bf16=False) -> torch.Tensor:
    if cast_a_bf16:
        a = a.to(torch.bfloat16)
    a = a.float()
    if trans_a:
        a = a.transpose(-1, -2)
    return torch.matmul(a, b.float())


def mixed_dot_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 . bf16 -> f32: both promoted to f32 (exact products), an f32
    matmul."""
    _dims(a, b, False)
    return _plain_contract(a, b, False)


def mixed_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """P2: a [M, K] int8 . b [K, N] bf16 -> [M, N] f32."""
    _check_device(a)
    if a.dtype != torch.int8 or b.dtype != torch.bfloat16:
        raise TypeError(f"mixed_dot takes int8 . bf16: {a.dtype}, "
                        f"{b.dtype}")
    if a.device.type == "cpu":
        return mixed_dot_plain(a, b)
    out = _mma(a, b, False, _dims(a, b, False))
    LAUNCHES["mixed_dot"] += 1
    return out


_CUDA_CORES = {(torch.float32, torch.float32), (torch.float32, torch.int8),
               (torch.int8, torch.float32)}

# the f32 contraction's launch plan (csrc f32_dot_kernel)
H100_SMS = 132
DOT_SMEM = 48 * 1024      # staged panels of a block, all stages
DOT_MAX_SPLITS = 32
DOT_SPLIT_MIN_K = 512     # shorter contractions run whole in one block
DOT_SPLIT_ALIGN = 64      # K of a split is a multiple of this
DOT_RING_CHUNK = 32       # K a stage holds where a split's panel won't fit


class DotPlan(NamedTuple):
    """A ``bm`` x ``bn`` output tile per block of ``k_groups`` x 128
    threads (each group takes a share of every staged chunk's K); K cut
    into ``n_split`` ranges of ``k_split``, one block each, staged
    ``k_chunk`` at a time."""
    bm: int
    bn: int
    k_groups: int
    n_split: int
    k_split: int
    k_chunk: int

    def k_ranges(self, K: int) -> List[Tuple[int, int]]:
        """The [start, end) of K each split contracts."""
        return [(s * self.k_split, min(K, (s + 1) * self.k_split))
                for s in range(self.n_split)]


def dot_stage_bytes(bm: int, bn: int, k_chunk: int, trans_a: bool,
                    a_size: int, b_size: int) -> int:
    """Shared bytes of one stage: A [bm][k_chunk + 16 bytes of pad]
    (``trans_a``: [k_chunk][bm]) and B [k_chunk][bn], in the operands'
    own element sizes (csrc ``stage_bytes``)."""
    a_ld = bm if trans_a else k_chunk + 16 // a_size
    a_rows = k_chunk if trans_a else bm
    return a_rows * a_ld * a_size + k_chunk * bn * b_size


def dot_plan(batch: int, M: int, K: int, N: int, trans_a: bool = False,
             a_size: int = 4, b_size: int = 4) -> DotPlan:
    """The launch of ``tricks_dot``'s f32 contraction for [batch, M, K] .
    [batch, K, N] with elements of ``a_size`` and ``b_size`` bytes.

    Tile: 32 x 64 where M <= N, else 64 x 32, so a 32-wide side fills
    it; 32 x 32 where that still gives fewer blocks than SMs. Split: a
    contraction of at least ``DOT_SPLIT_MIN_K`` on fewer tiles than SMs
    is cut into the shortest ranges that are a multiple of
    ``DOT_SPLIT_ALIGN`` and number at most ``DOT_MAX_SPLITS``, none
    empty (K = 1280: 20 ranges of 64). A 32 x 32 block that contracts its
    K whole runs two thread groups, each on half of every chunk.
    Staging: a split's whole K in one stage where it fits in
    ``DOT_SMEM``, else two stages of ``DOT_RING_CHUNK``."""
    bm, bn = (32, 64) if M <= N else (64, 32)
    tiles = batch * math.ceil(M / bm) * math.ceil(N / bn)
    if tiles < H100_SMS:
        bm = bn = 32
        tiles = batch * math.ceil(M / bm) * math.ceil(N / bn)
    n_split, k_split = 1, K
    if tiles < H100_SMS and K >= DOT_SPLIT_MIN_K:
        k_split = DOT_SPLIT_ALIGN * math.ceil(
            K / DOT_MAX_SPLITS / DOT_SPLIT_ALIGN)
        n_split = math.ceil(K / k_split)
    k_groups = 2 if bm == bn == 32 and n_split == 1 else 1
    k_chunk = 16 * math.ceil(k_split / 16)
    if dot_stage_bytes(bm, bn, k_chunk, trans_a, a_size,
                       b_size) > DOT_SMEM:
        k_chunk = DOT_RING_CHUNK
    return DotPlan(bm, bn, k_groups, n_split, k_split, k_chunk)
_TENSOR_CORES = {torch.bfloat16, torch.int8}


def tricks_dot_plain(a: torch.Tensor, b: torch.Tensor, trans_a: bool = False,
                     cast_a_bf16: bool = False) -> torch.Tensor:
    """The contraction in f32 (a rounded to bf16 first if
    ``cast_a_bf16``)."""
    _dims(a, b, trans_a)
    return _plain_contract(a, b, trans_a, cast_a_bf16)


def tricks_dot(a: torch.Tensor, b: torch.Tensor, trans_a: bool = False,
               cast_a_bf16: bool = False) -> torch.Tensor:
    """P3's contractions: a [(B,) M, K] (``trans_a``: [(B,) K, M]) . b
    [(B,) K, N] -> [(B,) M, N] f32. a and b f32 or int8 (CUDA cores, f32),
    or both bf16 / int8 (tensor cores); ``cast_a_bf16`` takes an f32 a,
    rounds it to bf16 in the kernel and runs on the tensor cores."""
    _check_device(a)
    dims = _dims(a, b, trans_a)
    if cast_a_bf16 and a.dtype != torch.float32:
        raise TypeError("cast_a_bf16 takes an f32 left operand")
    mma = cast_a_bf16 or (a.dtype in _TENSOR_CORES
                          and b.dtype in _TENSOR_CORES)
    if not mma and (a.dtype, b.dtype) not in _CUDA_CORES:
        raise TypeError(f"no probe contraction for {a.dtype} . {b.dtype}")
    if mma and b.dtype not in _TENSOR_CORES:
        raise TypeError(f"the tensor-core contraction takes a bf16 or int8 "
                        f"right operand: {b.dtype}")
    if a.device.type == "cpu":
        return tricks_dot_plain(a, b, trans_a, cast_a_bf16)
    if mma:
        out = _mma(a, b, trans_a, dims)
    else:
        batch, M, K, N = dims
        _check_cuda(a, b)
        out = torch.empty(((batch,) if a.dim() == 3 else ()) + (M, N),
                          dtype=torch.float32, device=a.device)
        plan = dot_plan(batch, M, K, N, trans_a, a.element_size(),
                        b.element_size())
        part = None if plan.n_split == 1 else torch.empty(
            plan.n_split * batch * M * N, dtype=torch.float32,
            device=a.device)
        rc = _build.library().wa_probe_dot_f32(
            a.data_ptr(), _build.DTYPE_CODES[a.dtype], int(trans_a),
            b.data_ptr(), _build.DTYPE_CODES[b.dtype], out.data_ptr(),
            batch, M, K, N, *plan, _build.ptr(part), _build.stream())
        _build.check(rc, "probe f32 dot")
    LAUNCHES["tricks"] += 1
    return out


def tricks_transpose_plain(a: torch.Tensor) -> torch.Tensor:
    return a.t().contiguous()


def tricks_transpose(a: torch.Tensor) -> torch.Tensor:
    """P3 (d): a [R, C] f32 -> [C, R]."""
    if a.dim() != 2 or a.dtype != torch.float32:
        raise ValueError(f"tricks_transpose takes a 2-D f32 tensor: "
                         f"{a.dtype} {tuple(a.shape)}")
    _check_device(a)
    if a.device.type == "cpu":
        return tricks_transpose_plain(a)
    _check_cuda(a)
    R, C = a.shape
    out = torch.empty((C, R), dtype=torch.float32, device=a.device)
    rc = _build.library().wa_probe_transpose(a.data_ptr(), out.data_ptr(),
                                             R, C, _build.stream())
    _build.check(rc, "tricks_transpose")
    LAUNCHES["tricks"] += 1
    return out
