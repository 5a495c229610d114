"""Tensor-parallel weights and their collectives (Megatron splits).

The JAX package places its weights with ``NamedSharding`` and leaves the
collectives to GSPMD. Here a weight cut for tensor parallelism is a
:class:`TPShard`: the rank's own slice of the full weight, the kind of
split, and the tp group that holds the other slices. The plain ops
recognise it and do the collective themselves:

- ``col``: the output dimension is split (q/k/v projections, fc1, and
  their biases). The product stays local: each rank holds its heads or
  hidden units.
- ``row``: the input dimension is split (the attention output
  projections, fc2). Each rank's partial product is summed over the tp
  group by one ``all_reduce``, then the (replicated) bias is added once.
- ``vocab``: the rows of the token embedding are split. A lookup takes
  the ids in the rank's ``[lo, hi)`` rows and sums over tp; the tied
  vocab projection fills the rank's columns of a zero ``[.., V]`` buffer
  and sums over tp, which gathers the logits in rank order exactly.

Only ``all_reduce`` runs, in f32, so the same code serves NCCL and gloo
(gloo has ``all_reduce`` and ``broadcast`` on CUDA tensors, no
``all_gather``). A tree of shards holds each rank's heads, so the
forward runs with a local config (:func:`local_config`: heads and width
divided by tp). The kernel paths take no shards (:func:`require_unsharded`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class TPGroup:
    """The tp group of a rank: the process group (None: the default
    group), this rank's index in it and its size."""

    group: Any
    rank: int
    size: int


@dataclasses.dataclass(frozen=True)
class TPShard:
    """This rank's slice of a weight split over a tp group: ``local``
    holds the rows or columns ``[rank * n, (rank + 1) * n)`` of the split
    axis (``kind``: "col", "row" or "vocab") of a weight whose split axis
    is ``full`` long."""

    local: torch.Tensor
    kind: str
    tp: TPGroup
    full: int

    @property
    def shape(self):
        return self.local.shape

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "TPShard":
        """``fn`` applied to the local slice (a layer of a stacked weight,
        a device move); the split kept."""
        return dataclasses.replace(self, local=fn(self.local))

    def __repr__(self) -> str:
        return (f"TPShard({self.kind}, {self.tp.rank}/{self.tp.size}, "
                f"local={tuple(self.local.shape)})")


def is_shard(w: Any) -> bool:
    return isinstance(w, TPShard)


def all_reduce_sum(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """Sum ``x`` over the tp group, accumulated in f32; the result in x's
    dtype on every rank."""
    import torch.distributed as dist
    acc = (x if x.dtype in (torch.float32, torch.float64)
           else x.float()).contiguous()
    dist.all_reduce(acc, group=tp.group)
    return acc.to(x.dtype)


def linear_shard(x: torch.Tensor, w: TPShard, b, matmul: Callable
                 ) -> torch.Tensor:
    """``linear`` over a split weight: ``matmul(x, w, b)`` on the local
    slice (a col split, its bias split with it), or the local partial
    product summed over tp and the replicated bias added once (a row
    split)."""
    if w.kind == "col":
        return matmul(x, w.local, b.local if is_shard(b) else b)
    if w.kind != "row":
        raise ValueError(f"linear over a {w.kind} split")
    y = all_reduce_sum(matmul(x, w.local, None), w.tp)
    return y if b is None else y + b.to(y.dtype)


def vocab_lookup(emb: TPShard, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding rows of ``tokens`` from a vocab-split table: each rank
    takes the ids in its rows, zeros elsewhere, summed over tp (one row
    and zeros: exact)."""
    n = emb.local.shape[0]
    idx = tokens.long() - emb.tp.rank * n
    inside = (idx >= 0) & (idx < n)
    rows = emb.local[idx.clamp(0, n - 1)]
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return all_reduce_sum(rows, emb.tp)


def vocab_logits(x: torch.Tensor, emb: TPShard) -> torch.Tensor:
    """Tied vocab projection over a vocab-split table: the rank's columns
    ``x @ local.T`` written into a zero f32 ``[.., V]`` buffer, summed
    over tp (each column from one rank: the gather, exact)."""
    part = torch.matmul(x, emb.local.to(x.dtype).T).float()
    n = part.shape[-1]
    lo = emb.tp.rank * n
    out = torch.zeros(part.shape[:-1] + (emb.full,), dtype=torch.float32,
                      device=part.device)
    out[..., lo: lo + n] = part
    return all_reduce_sum(out, emb.tp)


def tp_of(params: dict) -> Optional[TPGroup]:
    """The tp group of a sharded tree (its decoder q projection split),
    None for a tree held whole."""
    w = params.get("decoder", {}).get("blocks", {}).get(
        "self_attn", {}).get("q_w")
    return w.tp if is_shard(w) else None


def local_config(params: dict, config):
    """The config a tp rank runs its forward with: heads and widths
    divided by tp for a sharded tree (``mha`` takes the rank's heads; the
    self cache is the rank's width), ``config`` itself otherwise. The
    entry points take the model's config, as JAX's sharded forward does,
    and call each other: a config whose width is not the q projection's
    full width is already local and is returned as it is."""
    tp = tp_of(params)
    if tp is None or tp.size == 1:
        return config
    if config.n_text_state != params["decoder"]["blocks"]["self_attn"][
            "q_w"].full:
        return config
    n = tp.size
    if config.n_text_head % n or config.n_audio_head % n:
        raise ValueError(f"{config.n_audio_head} / {config.n_text_head} "
                         f"heads do not split over tp={n}")
    return dataclasses.replace(
        config, n_text_state=config.n_text_state // n,
        n_text_head=config.n_text_head // n,
        n_audio_state=config.n_audio_state // n,
        n_audio_head=config.n_audio_head // n)


def require_unsharded(params: dict, what: str) -> None:
    """Refuse a tp-sharded tree on a kernel path: the kernels take whole
    weights, so a slice would compute garbage. On a mesh the plain step
    runs, as in the JAX package."""
    if tp_of(params) is not None:
        raise ValueError(
            f"{what}: whole weights only, not a tp-sharded tree (on a mesh "
            f"the plain step runs: parallel/mesh.py)")
