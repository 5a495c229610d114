"""Device mesh and tensor-parallel placements: port of
``whisper_apr_tpu/parallel/mesh.py``.

One process per device, joined in a ``torch.distributed`` process group
(``parallel/distributed.init_distributed``). The mesh is a
``DeviceMesh`` over those ranks with two dims:

- ``dp``: data parallel. Each dp index holds its rows of the batch
  (``shard_batch``) and, when serving, its slots.
- ``tp``: tensor parallel. The ranks of one dp index split each block's
  heads and FFN hidden units, and the token embedding's vocabulary
  (Megatron splits, ``param_specs``).

GSPMD inserted the collectives for the JAX package. Here every rank
holds the whole weights, as every JAX process does, and cuts its own
shard (``shard_params``); the split weights are ``ops/tp.TPShard``
records, and ``linear``, ``embed`` and ``project_to_vocab`` do the tp
collectives themselves (``all_reduce`` only). Batches are plain local
tensors: a rank's dp rows (``shard_batch``) or the whole batch
(``replicate``); :func:`gather_dp` brings every dp shard's rows to every
rank. On a 1 x 1 mesh nothing is cut, so the same code serves one
device and many. The kernel paths (the qdecode kernels, the paged step,
the flash encoder) take no sharded tree; on a mesh the plain step runs,
as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from ..ops.quant import is_quantized
from ..ops.tp import TPGroup, TPShard

DIMS = ("dp", "tp")


def _placements():
    # imported at first use: torch.distributed.tensor takes seconds to
    # import, and every module of the port is imported by the tests
    from torch.distributed.tensor import Replicate, Shard
    return Replicate, Shard


def mesh_device_type() -> str:
    """The DeviceMesh device type of the process group's backend: "cuda"
    for NCCL, "cpu" for gloo (whose groups also carry CUDA tensors)."""
    import torch.distributed as dist
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              tp: int = 1, devices: Optional[Sequence[int]] = None):
    """A (dp, tp) ``DeviceMesh`` over the first ``n_devices`` of
    ``devices`` (ranks; all ranks of the process group by default), tp
    the fast dim. Every rank of the group calls it (it makes the dim
    groups); a rank outside the mesh gets None from ``get_coordinate``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group "
                           "(parallel/distributed.init_distributed)")
    ranks = list(devices if devices is not None
                 else range(dist.get_world_size()))
    n = n_devices or len(ranks)
    if n > len(ranks):
        raise ValueError(f"mesh of {n} devices over {len(ranks)} ranks")
    ranks = ranks[:n]
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"mesh {dp}x{tp} != {n} devices")
    return DeviceMesh(mesh_device_type(),
                      torch.tensor(ranks, dtype=torch.int64).reshape(dp, tp),
                      mesh_dim_names=DIMS)


def mesh_shape(mesh) -> Dict[str, int]:
    """{"dp": n, "tp": m}, the JAX ``Mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def coordinate(mesh) -> Tuple[int, int]:
    """This rank's (dp, tp) index; ValueError for a rank outside."""
    c = mesh.get_coordinate()
    if c is None:
        raise ValueError("this rank is not in the mesh")
    return int(c[0]), int(c[1])


def tp_group(mesh) -> TPGroup:
    """This rank's tp group, its index in it and the group's size."""
    return TPGroup(mesh.get_group("tp"), coordinate(mesh)[1],
                   mesh_shape(mesh)["tp"])


def _attn_specs(tp_ok: bool) -> dict:
    """Placements of one stacked attention group [L, ...]."""
    Replicate, Shard = _placements()
    rep = (Replicate(), Replicate())
    col = (Replicate(), Shard(2)) if tp_ok else rep
    row = (Replicate(), Shard(1)) if tp_ok else rep
    vec = (Replicate(), Shard(1)) if tp_ok else rep
    return {"q_w": col, "q_b": vec, "k_w": col, "k_b": vec,
            "v_w": col, "v_b": vec,
            "o_w": row, "o_b": rep}  # row-split output proj: bias whole


def param_specs(params: dict, shard_tp: bool = True) -> dict:
    """The placement tree of ``params`` over (dp, tp), the JAX
    ``param_specs`` one for one: every leaf is replicated over dp; over
    tp the QKV / fc1 weights split their output dim (``Shard(2)`` of
    [L, d_in, d_out]) with their biases (``Shard(1)``), the output
    projections and fc2 their input dim (``Shard(1)``, bias whole), the
    token embedding its vocab rows (``Shard(0)``); LayerNorms, the conv
    stem and the positional embeddings are replicated."""
    Replicate, Shard = _placements()
    rep = (Replicate(), Replicate())
    ln = {"w": rep, "b": rep}
    col3 = (Replicate(), Shard(2)) if shard_tp else rep
    row3 = (Replicate(), Shard(1)) if shard_tp else rep
    vec2 = (Replicate(), Shard(1)) if shard_tp else rep
    enc = {
        "conv1": {"w": rep, "b": rep},
        "conv2": {"w": rep, "b": rep},
        "pos_emb": rep,
        "blocks": {
            "ln1": dict(ln), "attn": _attn_specs(shard_tp), "ln2": dict(ln),
            "fc1": {"w": col3, "b": vec2},
            "fc2": {"w": row3, "b": rep},
        },
        "ln_post": dict(ln),
    }
    dec = {
        "token_emb": (Replicate(), Shard(0)) if shard_tp else rep,
        "pos_emb": rep,
        "blocks": {
            "ln1": dict(ln), "self_attn": _attn_specs(shard_tp),
            "ln2": dict(ln), "cross_attn": _attn_specs(shard_tp),
            "ln3": dict(ln),
            "fc1": {"w": col3, "b": vec2},
            "fc2": {"w": row3, "b": rep},
        },
        "ln_post": dict(ln),
    }
    return {"encoder": enc, "decoder": dec}


def split_axis(placements) -> Optional[int]:
    """The axis a placement pair splits over tp, None if replicated."""
    p = placements[DIMS.index("tp")]
    return p.dim if p.is_shard() else None


def shard_params(params: dict, mesh, shard_tp: bool = True) -> dict:
    """Each rank cuts its own tp shard out of the whole tree it holds
    (every rank loads the same weights; nothing is scattered): split
    leaves become ``ops/tp.TPShard`` records, the rest stay as they are.
    A split dim that tp does not divide raises ValueError, as JAX's
    ``NamedSharding`` does (whisper-tiny ... medium's 51865 vocab rows do
    not split over 2). Quantized weights are refused: the JAX
    ``shard_params`` maps plain arrays only. ``shard_tp=False`` (or a tp
    of 1) keeps every leaf whole."""
    tp = tp_group(mesh)
    specs = param_specs(params, shard_tp=shard_tp and tp.size > 1)

    def cut(x, spec, path):
        if isinstance(x, dict):
            if set(x) != set(spec):
                raise ValueError(f"{path}: keys {sorted(x)} are not the "
                                 f"schema's {sorted(spec)}")
            return {k: cut(x[k], spec[k], f"{path}.{k}") for k in x}
        if is_quantized(x):
            raise ValueError(f"{path}: quantized weights do not shard; "
                             f"shard the float tree")
        axis = split_axis(spec)
        if axis is None:
            return x
        n = x.shape[axis]
        if n % tp.size:
            raise ValueError(f"{path}: dim {axis} of {tuple(x.shape)} does "
                             f"not split over tp={tp.size}")
        k = n // tp.size
        kind = ("vocab" if path.endswith("token_emb")
                else "row" if axis == x.ndim - 2 else "col")
        return TPShard(x.narrow(axis, tp.rank * k, k).contiguous(), kind,
                       tp, n)

    return cut(params, specs, "params")


def _dp_rows(n: int, mesh) -> Tuple[int, int]:
    """(start, count) of this rank's dp rows of a batch of ``n``."""
    dp = mesh_shape(mesh)["dp"]
    if n % dp:
        raise ValueError(f"batch of {n} does not split over dp={dp}")
    k = n // dp
    return coordinate(mesh)[0] * k, k


def shard_batch(x: torch.Tensor, mesh, axis: int = 0) -> torch.Tensor:
    """This rank's dp rows of a batch every rank holds whole (replicated
    over tp)."""
    start, k = _dp_rows(x.shape[axis], mesh)
    return x.narrow(axis, start, k)


def replicate(x: torch.Tensor, mesh) -> torch.Tensor:
    """The replicated form of ``x``: every rank holds all of it (the mesh
    is taken for the JAX signature)."""
    del mesh
    return x


def gather_dp(local: torch.Tensor, mesh, axis: int = 0) -> torch.Tensor:
    """Every dp shard's rows on every rank: each rank writes its rows
    into a zero buffer of the whole batch and the dp group sums it (one
    rank per dp index in each dp group, so each row comes from one rank:
    exact). Floats travel in f32, booleans as int32."""
    import torch.distributed as dist
    dp = mesh_shape(mesh)["dp"]
    i = coordinate(mesh)[0]
    dt = local.dtype
    wire = (torch.float32 if dt.is_floating_point and dt != torch.float64
            else torch.int32 if dt == torch.bool else dt)
    k = local.shape[axis]
    shape = list(local.shape)
    shape[axis] = k * dp
    buf = torch.zeros(shape, dtype=wire, device=local.device)
    buf.narrow(axis, i * k, k).copy_(local)
    if dp > 1:
        dist.all_reduce(buf, group=mesh.get_group("dp"))
    return buf.to(dt)
