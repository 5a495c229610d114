"""Parameter checkpoints: a prepared param tree (transposed, stacked,
possibly quantized) as one ``.npz`` (port of the JAX package's
``utils/checkpoint.py``, the same format and ``FORMAT_VERSION``).

The tree's structure is a declarative JSON spec stored beside the arrays
and rebuilt at load time; nothing is pickled. A checkpoint saved by
either package loads in the other: the port's loader rebuilds the JAX
layout from the spec and turns it into tensors with ``from_jax_params``.
Leaves must have a numpy dtype (bf16 and fp8 tensors are refused: save
them as f32).
"""

from __future__ import annotations

import json
from typing import Any, List, Optional

import numpy as np
import torch

from ..model.params import from_jax_params, to_device
from ..ops.quant import QTensor

FORMAT_VERSION = 2


def _leaf(t: Any) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        if t.dtype in (torch.bfloat16, torch.float8_e4m3fn):
            raise TypeError(f"checkpoint leaves need a numpy dtype, got "
                            f"{t.dtype}: save the tree in float32")
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _to_spec(tree: Any, leaves: List[np.ndarray]) -> Any:
    """``tree`` as a JSON-able spec; array leaves appended to ``leaves``
    in traversal order."""
    if tree is None:
        return {"t": "none"}
    if isinstance(tree, QTensor):
        return {
            "t": "qtensor",
            "aux": [tree.int4, tree.orig_last, tree.group, tree.kpack],
            "q": _to_spec(tree.q, leaves),
            "scale": _to_spec(tree.scale, leaves),
            "zero": _to_spec(tree.zero, leaves),
        }
    if isinstance(tree, dict):
        for k in tree:
            if not isinstance(k, str):
                raise TypeError(f"checkpoint dict keys must be str, got {k!r}")
        return {"t": "dict",
                "items": [[k, _to_spec(v, leaves)] for k, v in tree.items()]}
    if isinstance(tree, (list, tuple)):
        return {"t": "list" if isinstance(tree, list) else "tuple",
                "items": [_to_spec(v, leaves) for v in tree]}
    leaves.append(_leaf(tree))
    return {"t": "leaf", "i": len(leaves) - 1}


def _from_spec(spec: Any, leaves: List[np.ndarray]) -> Any:
    """The tree in the JAX layout, numpy leaves (QTensor fields too)."""
    if spec["t"] == "none":
        return None
    if spec["t"] == "leaf":
        return leaves[spec["i"]]
    if spec["t"] == "qtensor":
        int4, orig_last, group, kpack = spec["aux"]
        return QTensor(_from_spec(spec["q"], leaves),
                       _from_spec(spec["scale"], leaves),
                       zero=_from_spec(spec["zero"], leaves), int4=int4,
                       orig_last=orig_last, group=group, kpack=kpack)
    if spec["t"] == "dict":
        return {k: _from_spec(v, leaves) for k, v in spec["items"]}
    if spec["t"] in ("list", "tuple"):
        seq = [_from_spec(v, leaves) for v in spec["items"]]
        return seq if spec["t"] == "list" else tuple(seq)
    raise ValueError(f"unknown checkpoint node type {spec['t']!r}")


def save_params(path: str, params: Any) -> None:
    """Write a param tree (QTensors included) to ``path``."""
    leaves: List[np.ndarray] = []
    spec = _to_spec(params, leaves)
    arrays = {f"leaf_{i}": leaf for i, leaf in enumerate(leaves)}
    meta = {"version": FORMAT_VERSION, "n_leaves": len(leaves), "spec": spec}
    with open(path, "wb") as f:
        np.savez(f, __meta__=np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8), **arrays)


def load_params(path: str,
                device: "torch.device | str | None" = None) -> Any:
    """A tree saved by :func:`save_params` (of either package), as host
    tensors, or moved to ``device``. Refuses other versions (v1 carried
    a pickled treedef)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta["version"] != FORMAT_VERSION:
            raise ValueError(
                f"unsupported checkpoint version {meta['version']} "
                f"(v1 used a pickled treedef and is refused; re-save)")
        leaves = [z[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    tree = from_jax_params(_from_spec(meta["spec"], leaves))
    return tree if device is None else to_device(tree, device)
