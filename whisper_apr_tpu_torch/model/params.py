"""Parameter trees: schema, seeded random init, .apr loading, weight
quantization, and the bridge from the JAX package's params.

Port of ``whisper_apr_tpu/model/params.py``. Parameters are nested dicts
of tensors with the JAX package's layout: per-layer tensors STACKED on a
leading layer axis, linear weights input-major ``[d_in, d_out]``, int8
weights as :class:`~..ops.quant.QTensor` (int8, int4, group int4 and the
planar k-quants). Tensor names in .apr files are
the HF-derived names (``decoder.layers.N.self_attn.q_proj.weight``, ...).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..errors import ModelError
from ..format import AprReader
from ..format.container import (QUANT_F16, QUANT_F32, QUANT_INT8,
                                QUANT_Q4K, QUANT_Q5K, QUANT_Q6K)
from ..ops.quant import (QTensor, is_quantized, quantize_int4, quantize_int8,
                         quantize_q4_block)
from ..ops.tp import is_shard

Params = Dict[str, Any]


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every tensor leaf (QTensors map q, scale and
    zero; a tp shard its local slice)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if is_quantized(tree) or is_shard(tree):
        return tree.map(fn)
    return fn(tree)


def to_device(params: Params, device) -> Params:
    return tree_map(lambda t: t.to(device), params)


def layer_slice(tree, layer: int):
    """One layer of a stacked tree (QTensor q, scale and zero alike; a tp
    shard keeps its split)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, layer) for k, v in tree.items()}
    if is_quantized(tree) or is_shard(tree):
        return tree.map(lambda t: t[layer])
    return tree[layer]


# ---------------------------------------------------------------------------
# Random initialization (same numpy draws, in the same order, as the JAX
# package's init_params, so a seed gives both packages the same weights)
# ---------------------------------------------------------------------------

def init_params(config: ModelConfig, seed: int = 0,
                dtype: torch.dtype = torch.float32) -> Params:
    """Random small-scale parameters with the full schema."""
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.02):
        return torch.from_numpy(
            rng.normal(0.0, scale, size=shape).astype(np.float32)).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype)

    d_a, d_t = config.n_audio_state, config.n_text_state
    La, Lt = config.n_audio_layer, config.n_text_layer

    def attn_block(L, d):
        return {
            "q_w": w(L, d, d), "q_b": zeros(L, d),
            "k_w": w(L, d, d), "k_b": zeros(L, d),
            "v_w": w(L, d, d), "v_b": zeros(L, d),
            "o_w": w(L, d, d), "o_b": zeros(L, d),
        }

    encoder = {
        "conv1": {"w": w(d_a, config.n_mels, 3), "b": zeros(d_a)},
        "conv2": {"w": w(d_a, d_a, 3), "b": zeros(d_a)},
        "pos_emb": torch.from_numpy(
            sinusoidal_embedding(config.n_audio_ctx, d_a)).to(dtype),
        "blocks": {
            "ln1": {"w": ones(La, d_a), "b": zeros(La, d_a)},
            "attn": attn_block(La, d_a),
            "ln2": {"w": ones(La, d_a), "b": zeros(La, d_a)},
            "fc1": {"w": w(La, d_a, 4 * d_a), "b": zeros(La, 4 * d_a)},
            "fc2": {"w": w(La, 4 * d_a, d_a), "b": zeros(La, d_a)},
        },
        "ln_post": {"w": ones(d_a), "b": zeros(d_a)},
    }
    decoder = {
        "token_emb": w(config.n_vocab, d_t),
        "pos_emb": w(config.n_text_ctx, d_t),
        "blocks": {
            "ln1": {"w": ones(Lt, d_t), "b": zeros(Lt, d_t)},
            "self_attn": attn_block(Lt, d_t),
            "ln2": {"w": ones(Lt, d_t), "b": zeros(Lt, d_t)},
            "cross_attn": attn_block(Lt, d_t),
            "ln3": {"w": ones(Lt, d_t), "b": zeros(Lt, d_t)},
            "fc1": {"w": w(Lt, d_t, 4 * d_t), "b": zeros(Lt, 4 * d_t)},
            "fc2": {"w": w(Lt, 4 * d_t, d_t), "b": zeros(Lt, d_t)},
        },
        "ln_post": {"w": ones(d_t), "b": zeros(d_t)},
    }
    return {"encoder": encoder, "decoder": decoder}


def sinusoidal_embedding(length: int, channels: int) -> np.ndarray:
    """Whisper's sinusoidal positional embedding (numpy, f32)."""
    log_timescale = np.log(10_000.0) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)],
                          axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# The JAX package's params -> the port's
# ---------------------------------------------------------------------------

def _leaf_tensor(a) -> torch.Tensor:
    """An array as a tensor with the same bits (bf16 and fp8 too)."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    if arr.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(arr.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(np.array(arr))


def from_jax_params(tree):
    """Turn the JAX package's param tree (numpy or JAX arrays;
    ``QTensor``s as objects with ``q``, ``scale``, ``zero`` and the
    packing metadata) into the port's, bit for bit: int8, int4, group
    int4 and the planar k-quants (a q4k plane stays int8, its raw bytes
    viewed as signed). The kernel operands and decode state cross
    the same way: a ``prepare_qdecode`` dict, and a ``KVCache`` or
    ``QKVCache`` (any batch) becomes the port's class of that name; a
    ``PagedKVCache`` becomes the port's with its pools as tensors and its
    free list, page tables and lengths copied (on the CPU)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: from_jax_params(v) for k, v in tree.items()}
    if type(tree).__name__ == "PagedKVCache":
        from ..config import ModelConfig
        from .kv_variants import PagedKVCache
        out = PagedKVCache.__new__(PagedKVCache)
        out.config = ModelConfig(**dataclasses.asdict(tree.config))
        out.n_pages = int(tree.n_pages)
        out.k_pool = _leaf_tensor(tree.k_pool)
        out.v_pool = _leaf_tensor(tree.v_pool)
        out._free = [int(i) for i in tree._free]
        out._tables = {int(k): [int(i) for i in v]
                       for k, v in tree._tables.items()}
        out._lengths = {int(k): int(v) for k, v in tree._lengths.items()}
        return out
    if type(tree).__name__ in ("KVCache", "QKVCache"):
        from .decoder import KVCache
        from .qdecode import QKVCache
        cls = KVCache if type(tree).__name__ == "KVCache" else QKVCache
        return cls(*(from_jax_params(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(from_jax_params(v) for v in tree)
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        zero = getattr(tree, "zero", None)
        group = getattr(tree, "group", None)
        orig_last = getattr(tree, "orig_last", None)
        return QTensor(_leaf_tensor(tree.q), _leaf_tensor(tree.scale),
                       zero=None if zero is None else _leaf_tensor(zero),
                       int4=bool(getattr(tree, "int4", False)),
                       orig_last=None if orig_last is None
                       else int(orig_last),
                       group=None if group is None else int(group),
                       kpack=bool(getattr(tree, "kpack", False)))
    return _leaf_tensor(tree)


# ---------------------------------------------------------------------------
# Loading from .apr
# ---------------------------------------------------------------------------

def load_params_from_apr(reader: AprReader,
                         dtype: torch.dtype = torch.float32,
                         keep_quantized: bool = False,
                         on_tensor: Optional[Callable[[str, int], None]] = None
                         ) -> Params:
    """Build the stacked parameter tree from an .apr file (host tensors).

    ``keep_quantized=True`` on an int8 file keeps the matmul weights and
    the token embedding as int8 QTensors with the FILE's per-tensor scales
    (no dequantize/requantize round trip); on a q4k, q5k or q6k file the
    block linears whose d_in is a multiple of 256 load bit-exact from the
    super-blocks as planar QTensors (``ops/q4k.planar_from_raw``,
    ``ops/kquants.planar_from_raw_q5k``/``_q6k``), the others dequantized,
    and the token embedding is requantized to per-channel int8 (params.py
    :142-148, :200-217, :292-297). LN/bias/conv/pos tensors load as float.
    f32, f16, int8 and the k-quant files are supported (int4 files have
    no reader in either package). ``reader`` is a v1 ``AprReader`` or an
    ``AprReaderV2``.

    ``on_tensor(name, i)`` fires after each tensor read, ``i`` counting
    from 1, in the JAX loader's order and for the same names (an absent
    optional bias is not read) — the hook of the engine's load progress.
    """
    n_read = [0]

    def count(name: str) -> None:
        n_read[0] += 1
        if on_tensor is not None:
            on_tensor(name, n_read[0])

    cfg = reader.header.to_model_config()
    file_quant = reader.header.quantization
    if file_quant not in (QUANT_F32, QUANT_F16, QUANT_INT8, QUANT_Q4K,
                          QUANT_Q5K, QUANT_Q6K):
        raise NotImplementedError(
            f"{reader.header.quantization_name} .apr files have no loader")
    native_int8 = bool(keep_quantized) and file_quant == QUANT_INT8
    native_kq = file_quant if keep_quantized and file_quant in (
        QUANT_Q4K, QUANT_Q5K, QUANT_Q6K) else None

    def t(arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(arr, dtype=np.float32)).to(dtype)

    def get(name: str, *shape, transpose=False) -> np.ndarray:
        arr = reader.load_tensor(name)
        arr = arr.reshape(shape) if shape else arr
        if transpose:
            arr = np.ascontiguousarray(arr.T)
        count(name)
        return arr

    def raw(name: str) -> np.ndarray:
        arr = np.asarray(reader.load_raw(name))
        count(name)
        return arr

    def get_or(name: str, fallback: str) -> np.ndarray:
        if reader.find_tensor(name) is not None:
            return get(name)
        return get(fallback)

    d_a, d_t = cfg.n_audio_state, cfg.n_text_state
    La, Lt = cfg.n_audio_layer, cfg.n_text_layer

    def q_linear(name: str, d_in: int, d_out: int):
        """int8 weight straight from the file: transpose + file scale."""
        q = np.ascontiguousarray(raw(name).reshape(d_out, d_in).T)
        return q, np.float32(reader.scale_for(name))

    def stack_w(prefix_fn: Callable[[int], str], L: int, d_in: int,
                d_out: int):
        if native_int8:
            pairs = [q_linear(prefix_fn(i), d_in, d_out) for i in range(L)]
            q = torch.from_numpy(np.stack([p[0] for p in pairs]))
            scale = torch.from_numpy(
                np.array([p[1] for p in pairs], np.float32).reshape(L, 1, 1))
            return QTensor(q, scale)
        if native_kq is not None and d_in % 256 == 0:
            from ..ops import kquants, q4k
            planar = {QUANT_Q4K: q4k.planar_from_raw,
                      QUANT_Q5K: kquants.planar_from_raw_q5k,
                      QUANT_Q6K: kquants.planar_from_raw_q6k}[native_kq]
            qts = [planar(raw(prefix_fn(i)), d_out, d_in) for i in range(L)]
            return dataclasses.replace(
                qts[0], q=torch.stack([t.q for t in qts]),
                scale=torch.stack([t.scale for t in qts]),
                zero=None if qts[0].zero is None
                else torch.stack([t.zero for t in qts]))
        return t(np.stack([get(prefix_fn(i), d_out, d_in, transpose=True)
                           for i in range(L)]))

    def linear_b(prefix: str, d_out: int, required=True) -> np.ndarray:
        name = f"{prefix}.bias"
        if reader.find_tensor(name) is None:
            if required:
                raise ModelError(f"tensor not found: {name}")
            return np.zeros(d_out, np.float32)
        return get(name).reshape(d_out)

    def attn(prefix_fn: Callable[[int], str], L: int, d: int):
        def bias(what, required=True):
            return t(np.stack([linear_b(f"{prefix_fn(i)}.{what}", d, required)
                               for i in range(L)]))
        return {
            "q_w": stack_w(lambda i: f"{prefix_fn(i)}.q_proj.weight", L, d, d),
            "q_b": bias("q_proj"),
            # whisper's k_proj has no bias; absent in HF checkpoints
            "k_w": stack_w(lambda i: f"{prefix_fn(i)}.k_proj.weight", L, d, d),
            "k_b": bias("k_proj", required=False),
            "v_w": stack_w(lambda i: f"{prefix_fn(i)}.v_proj.weight", L, d, d),
            "v_b": bias("v_proj"),
            "o_w": stack_w(lambda i: f"{prefix_fn(i)}.out_proj.weight", L, d, d),
            "o_b": bias("out_proj"),
        }

    def ln(prefix_fn: Callable[[int], str], L: int, d: int):
        return {
            "w": t(np.stack([get(f"{prefix_fn(i)}.weight", d) for i in range(L)])),
            "b": t(np.stack([get(f"{prefix_fn(i)}.bias", d) for i in range(L)])),
        }

    def fc(prefix_fn: Callable[[int], str], L: int, d_in: int, d_out: int):
        return {
            "w": stack_w(lambda i: f"{prefix_fn(i)}.weight", L, d_in, d_out),
            "b": t(np.stack([linear_b(prefix_fn(i), d_out) for i in range(L)])),
        }

    try:
        encoder = {
            "conv1": {"w": t(get("encoder.conv1.weight", d_a, cfg.n_mels, 3)),
                      "b": t(get("encoder.conv1.bias", d_a))},
            "conv2": {"w": t(get("encoder.conv2.weight", d_a, d_a, 3)),
                      "b": t(get("encoder.conv2.bias", d_a))},
            "pos_emb": t(get_or("encoder.embed_positions.weight",
                                "encoder.positional_embedding")
                         .reshape(cfg.n_audio_ctx, d_a)),
            "blocks": {
                "ln1": ln(lambda i: f"encoder.layers.{i}.self_attn_layer_norm", La, d_a),
                "attn": attn(lambda i: f"encoder.layers.{i}.self_attn", La, d_a),
                "ln2": ln(lambda i: f"encoder.layers.{i}.final_layer_norm", La, d_a),
                "fc1": fc(lambda i: f"encoder.layers.{i}.fc1", La, d_a, 4 * d_a),
                "fc2": fc(lambda i: f"encoder.layers.{i}.fc2", La, 4 * d_a, d_a),
            },
            "ln_post": {"w": t(get("encoder.layer_norm.weight", d_a)),
                        "b": t(get("encoder.layer_norm.bias", d_a))},
        }
        te_name = ("decoder.embed_tokens.weight"
                   if reader.find_tensor("decoder.embed_tokens.weight")
                   else "decoder.token_embedding")
        if native_int8:
            token_emb = QTensor(
                torch.from_numpy(np.array(raw(te_name))
                                 .reshape(cfg.n_vocab, d_t)),
                torch.tensor(np.float32(reader.scale_for(te_name))))
        elif native_kq is not None:
            # gathered, not multiplied: per-channel int8 from the file's
            # dequantized values
            token_emb = quantize_int8(get(te_name).reshape(cfg.n_vocab, d_t),
                                      per_channel=True)
        else:
            token_emb = t(get(te_name).reshape(cfg.n_vocab, d_t))
        decoder = {
            "token_emb": token_emb,
            "pos_emb": t(get_or("decoder.embed_positions.weight",
                                "decoder.positional_embedding")
                         .reshape(cfg.n_text_ctx, d_t)),
            "blocks": {
                "ln1": ln(lambda i: f"decoder.layers.{i}.self_attn_layer_norm", Lt, d_t),
                "self_attn": attn(lambda i: f"decoder.layers.{i}.self_attn", Lt, d_t),
                "ln2": ln(lambda i: f"decoder.layers.{i}.encoder_attn_layer_norm", Lt, d_t),
                "cross_attn": attn(lambda i: f"decoder.layers.{i}.encoder_attn", Lt, d_t),
                "ln3": ln(lambda i: f"decoder.layers.{i}.final_layer_norm", Lt, d_t),
                "fc1": fc(lambda i: f"decoder.layers.{i}.fc1", Lt, d_t, 4 * d_t),
                "fc2": fc(lambda i: f"decoder.layers.{i}.fc2", Lt, 4 * d_t, d_t),
            },
            "ln_post": {"w": t(get("decoder.layer_norm.weight", d_t)),
                        "b": t(get("decoder.layer_norm.bias", d_t))},
        }
    except Exception as e:  # noqa: BLE001 - surface as ModelError with tensor context
        raise ModelError(f"failed to load model weights: {e}") from e
    return {"encoder": encoder, "decoder": decoder}


# ---------------------------------------------------------------------------
# Loading from a transformers state dict (offline test oracle)
# ---------------------------------------------------------------------------

def hf_state_dict_to_apr_tensors(state_dict: Dict[str, Any]
                                 ) -> Dict[str, np.ndarray]:
    """HF ``WhisperForConditionalGeneration`` tensor names -> .apr names
    (the JAX ``hf_state_dict_to_apr_tensors``): the ``model.`` prefix is
    stripped and ``proj_out.weight`` (tied to the token embedding)
    dropped; values as f32 numpy."""
    out: Dict[str, np.ndarray] = {}
    for name, tensor in state_dict.items():
        if isinstance(tensor, torch.Tensor):
            tensor = tensor.detach().float().cpu().numpy()
        arr = np.asarray(tensor, dtype=np.float32)
        if name.startswith("model."):
            name = name[len("model."):]
        if name == "proj_out.weight":
            continue
        out[name] = arr
    return out


class _DictHeader:
    quantization = QUANT_F32

    def __init__(self, cfg: ModelConfig):
        self._cfg = cfg

    def to_model_config(self) -> ModelConfig:
        return self._cfg


class _DictReader:
    """The reader surface ``load_params_from_apr`` takes, over a dict of
    f32 arrays named as in an .apr file."""

    def __init__(self, tensors: Dict[str, np.ndarray], cfg: ModelConfig):
        self._t = tensors
        self.header = _DictHeader(cfg)

    def find_tensor(self, name: str):
        return name if name in self._t else None

    def load_tensor(self, name: str) -> np.ndarray:
        if name not in self._t:
            raise ModelError(f"tensor not found: {name}")
        return self._t[name]


def params_from_hf_model(hf_model, config: ModelConfig,
                         dtype: torch.dtype = torch.float32) -> Params:
    """Params from a transformers ``WhisperModel`` /
    ``WhisperForConditionalGeneration`` (the JAX ``params_from_hf_model``:
    the offline numerics oracle). Reads only ``state_dict()``, so
    transformers is never imported here."""
    tensors = hf_state_dict_to_apr_tensors(hf_model.state_dict())
    return load_params_from_apr(_DictReader(tensors, config), dtype=dtype)


def tree_leaves(tree) -> List[torch.Tensor]:
    """Every tensor of a param tree in order; a QTensor gives q, scale and
    its zero when it has one (the JAX pytree's leaves)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if is_quantized(tree):
        return [t for t in (tree.q, tree.scale, tree.zero) if t is not None]
    return [tree]


def count_params(params: Params) -> int:
    """Elements of every leaf, scales included (the JAX ``count_params``)."""
    return sum(t.numel() for t in tree_leaves(params))


# ---------------------------------------------------------------------------
# Runtime weight quantization
# ---------------------------------------------------------------------------

QUANT_MODES = ("int8", "int4", "mixed", "q4", "q4k", "q5k", "q6k")


def quantize_params(params: Params, mode: str = "int8",
                    per_channel: bool = True) -> Params:
    """Quantize the matmul weights of a float tree (params.py:379-440):
    "int8" every block linear int8 (per output channel, stacked);
    "int4"/"mixed" per-channel packed int4; "q4" group-scale int4 (32-wide
    K groups); "q4k"/"q5k"/"q6k" the exact k-quants for block linears
    whose K axis is a multiple of 256, group int4 ("q4") for the others;
    "none" passes through. The token embedding is int8 per channel in
    every mode; conv stem, LayerNorms, biases and positional embeddings
    stay float."""
    if mode == "none":
        return params
    if mode not in QUANT_MODES:
        raise ValueError(f"unknown quantization mode: {mode}")
    if mode in ("q4k", "q5k", "q6k"):
        from ..ops import kquants, q4k
        kq = {"q4k": q4k.quantize_q4k, "q5k": kquants.quantize_q5k,
              "q6k": kquants.quantize_q6k}[mode]

        def block_q(w, per_channel=True, stacked=False):
            if w.shape[-2] % q4k.QK_K == 0:
                return kq(w, stacked=stacked)
            return quantize_q4_block(w)
    elif mode == "q4":
        def block_q(w, per_channel=True, stacked=False):
            return quantize_q4_block(w)
    elif mode in ("int4", "mixed"):
        block_q = quantize_int4
    else:
        block_q = quantize_int8

    def q(w):
        return block_q(w.detach().float().cpu().numpy(), per_channel,
                       stacked=True)

    def q_blocks(blocks: dict) -> dict:
        out = {}
        for name, sub in blocks.items():
            if name.startswith("ln"):
                out[name] = sub
            elif name in ("fc1", "fc2"):
                out[name] = {"w": q(sub["w"]), "b": sub["b"]}
            else:
                out[name] = {k: (q(v) if k.endswith("_w") else v)
                             for k, v in sub.items()}
        return out

    enc, dec = params["encoder"], params["decoder"]
    return {
        "encoder": {
            "conv1": enc["conv1"], "conv2": enc["conv2"],
            "pos_emb": enc["pos_emb"],
            "blocks": q_blocks(enc["blocks"]),
            "ln_post": enc["ln_post"],
        },
        "decoder": {
            "token_emb": quantize_int8(
                dec["token_emb"].detach().float().cpu().numpy(), True),
            "pos_emb": dec["pos_emb"],
            "blocks": q_blocks(dec["blocks"]),
            "ln_post": dec["ln_post"],
        },
    }


# ---------------------------------------------------------------------------
# Params -> .apr tensors (the inverse of load_params_from_apr's naming)
# ---------------------------------------------------------------------------

def params_to_apr_tensors(params: Params) -> Dict[str, np.ndarray]:
    """HF-named f32 arrays (linear weights back to ``[out, in]``) for
    ``AprWriter.add_tensor``; quantized weights are dequantized first."""
    from ..ops.quant import dequant

    def a(x) -> np.ndarray:
        return dequant(x, torch.float32).detach().cpu().numpy()

    out: Dict[str, np.ndarray] = {}

    def ln(name: str, p: dict, i=None):
        out[f"{name}.weight"] = a(p["w"])[i] if i is not None else a(p["w"])
        out[f"{name}.bias"] = a(p["b"])[i] if i is not None else a(p["b"])

    def attn(prefix: str, p: dict, i: int):
        for short, hf in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                          ("o", "out_proj")):
            out[f"{prefix}.{hf}.weight"] = np.ascontiguousarray(
                a(p[f"{short}_w"])[i].T)
            out[f"{prefix}.{hf}.bias"] = a(p[f"{short}_b"])[i]

    def fc(prefix: str, p: dict, i: int):
        out[f"{prefix}.weight"] = np.ascontiguousarray(a(p["w"])[i].T)
        out[f"{prefix}.bias"] = a(p["b"])[i]

    enc, dec = params["encoder"], params["decoder"]
    for c in ("conv1", "conv2"):
        out[f"encoder.{c}.weight"] = a(enc[c]["w"])
        out[f"encoder.{c}.bias"] = a(enc[c]["b"])
    out["encoder.embed_positions.weight"] = a(enc["pos_emb"])
    eb = enc["blocks"]
    for i in range(eb["ln1"]["w"].shape[0]):
        p = f"encoder.layers.{i}"
        ln(f"{p}.self_attn_layer_norm", eb["ln1"], i)
        attn(f"{p}.self_attn", eb["attn"], i)
        ln(f"{p}.final_layer_norm", eb["ln2"], i)
        fc(f"{p}.fc1", eb["fc1"], i)
        fc(f"{p}.fc2", eb["fc2"], i)
    ln("encoder.layer_norm", enc["ln_post"])
    out["decoder.embed_tokens.weight"] = a(dec["token_emb"])
    out["decoder.embed_positions.weight"] = a(dec["pos_emb"])
    db = dec["blocks"]
    for i in range(db["ln1"]["w"].shape[0]):
        p = f"decoder.layers.{i}"
        ln(f"{p}.self_attn_layer_norm", db["ln1"], i)
        attn(f"{p}.self_attn", db["self_attn"], i)
        ln(f"{p}.encoder_attn_layer_norm", db["ln2"], i)
        attn(f"{p}.encoder_attn", db["cross_attn"], i)
        ln(f"{p}.final_layer_norm", db["ln3"], i)
        fc(f"{p}.fc1", db["fc1"], i)
        fc(f"{p}.fc2", db["fc2"], i)
    ln("decoder.layer_norm", dec["ln_post"])
    return out


def quantized_size_bytes(params: Params) -> int:
    """Device-resident weight bytes, int8 and packed int4 leaves at their
    stored width (the JAX ``quantized_size_bytes``)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(params))
