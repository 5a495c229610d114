"""Quantized decode steps: port of ``whisper_apr_tpu/model/qdecode.py``
for int8 and k-quant (Q4_K, Q5_K, Q6_K) weights.

``decode_step_q`` (kv_mode "scan") runs every decoder linear through the
stacked matvec K8 and the FFN through K9 (``ops/qmatvec.py``), or, over a
k-quant qd, every linear through K10 (``ops/q4k.py``) or K11
(``ops/kquants.py``) with the GELU between fc1 and fc2 in torch; the
attention over the dense ``KVCache`` is plain torch (the JAX step runs it
in XLA, outside Pallas) and the vocab logits go through K8.

``decode_step_qf`` runs three per-block kernels per layer
(``ops/decode_blocks.py``: K1-K3 at B=1, the batched K5-K7 at B>1; over a
k-quant qd K12-K14 of ``ops/decode_blocks_kq.py``, B=1 only) and then
either the fused greedy head K4 or the logits tail K8
(``ops/qmatvec.py``); around them it does the embed, the deferred
cache-row writes after the layer loop, and the final LayerNorm. Rows are
written in place into the ``QKVCache`` tensors (the JAX step returns new
arrays; the port updates the cache it was given and returns it). The
kernels only read rows < pos, so deferring the writes past the layer loop
is exact.

The cache pad granularity (self 256, cross 512 rows) is the JAX
package's; the port has not measured its own yet.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from ..config import ModelConfig
from ..ops import decode_blocks, decode_blocks_kq, kquants, q4k, qmatvec
from ..ops.basic import gelu, layer_norm, mha
from ..ops.decode_attention import quantize_rows
from ..ops.quant import QTensor, dequant, is_quantized
from ..ops.tp import require_unsharded
from .decoder import KVCache, embed

_LANE = 128
SELF_BLOCK_T = 256       # self-cache pad granularity
CROSS_BLOCK_T = 512      # cross-cache pad granularity
KQ_MODES = ("q4k", "q5k", "q6k")   # k-quant qd modes


def qf_supported(qd: Optional[dict], batch: int) -> bool:
    """Can ``decode_step_qf`` serve this decode? An int8 qd serves any
    batch; a k-quant qd B == 1 only (K12-K14 have no batched form)."""
    if qd is None:
        return False
    return str(qd.get("mode", "int8")) not in KQ_MODES or batch == 1


def _block_leaves(params: dict) -> list:
    """The eight stacked decoder linears of the kernels."""
    blocks = params["decoder"]["blocks"]
    return [blocks["self_attn"]["q_w"], blocks["self_attn"]["k_w"],
            blocks["self_attn"]["v_w"], blocks["self_attn"]["o_w"],
            blocks["cross_attn"]["q_w"], blocks["cross_attn"]["o_w"],
            blocks["fc1"]["w"], blocks["fc2"]["w"]]


def _int8(w) -> bool:
    """An int8 QTensor with a per-tensor or per-channel scale."""
    return is_quantized(w) and not w.int4 and not w.group \
        and w.zero is None


def supports_qdecode(params: dict, config: ModelConfig) -> bool:
    """The fused step needs int8 decoder linears and token embedding (not
    int4, group-scaled or k-quant planes) and a lane-aligned model width
    (every Whisper size qualifies)."""
    leaves = _block_leaves(params) + [params["decoder"]["token_emb"]]
    if not all(_int8(w) for w in leaves):
        return False
    d = config.n_text_state
    return d % _LANE == 0


def _f32(a: torch.Tensor) -> torch.Tensor:
    return a.float().contiguous()


def prepare_qdecode(params: dict, config: ModelConfig) -> Optional[dict]:
    """One-time preparation of the kernel operands (the ``blk``, vocab and
    vocab-scale parts of the JAX ``prepare_qdecode``).

    ``blk`` holds [L, ...] stacks: LayerNorm weights [L, 1, D]; the self
    q/k/v weights concatenated to ``wqkv`` [L, D, 3D] int8 with scales and
    biases [L, 1, 3D]; the other int8 linears with per-output-channel
    scales [L, 1, N] (a per-tensor scale is broadcast) and biases. The
    vocab projection is the token embedding transposed to [1, D, V_pad]
    (V padded to a multiple of 128) with its K-side scale [1, D] kept
    apart: it folds into the activation, not the output; ``vocab_ones``
    [1, 1, V_pad] is the logits tail's (identity) output scale. ``blk``'s
    layout is checked here, once, for the kernels.
    """
    require_unsharded(params, "the fused decode kernels (K1-K9)")
    if not supports_qdecode(params, config):
        return None
    dec = params["decoder"]
    blocks = dec["blocks"]
    sa, ca = blocks["self_attn"], blocks["cross_attn"]
    L = config.n_text_layer

    def s(qt):
        return _f32(torch.broadcast_to(qt.scale, (L, 1, qt.q.shape[2])))

    def col(a):
        return _f32(a[:, None, :] if a.ndim == 2 else a)

    blk = {
        "ln1_w": col(blocks["ln1"]["w"]), "ln1_b": col(blocks["ln1"]["b"]),
        "ln2_w": col(blocks["ln2"]["w"]), "ln2_b": col(blocks["ln2"]["b"]),
        "ln3_w": col(blocks["ln3"]["w"]), "ln3_b": col(blocks["ln3"]["b"]),
        "wqkv": torch.cat([sa["q_w"].q, sa["k_w"].q, sa["v_w"].q],
                          dim=2).contiguous(),
        "sqkv": torch.cat([s(sa["q_w"]), s(sa["k_w"]), s(sa["v_w"])], dim=2),
        "bqkv": col(torch.cat([sa["q_b"], sa["k_b"], sa["v_b"]], dim=1)),
        "self_wo": sa["o_w"].q.contiguous(), "self_wos": s(sa["o_w"]),
        "self_wob": col(sa["o_b"]),
        "wcq": ca["q_w"].q.contiguous(), "scq": s(ca["q_w"]),
        "bcq": col(ca["q_b"]),
        "cross_wo": ca["o_w"].q.contiguous(), "cross_wos": s(ca["o_w"]),
        "cross_wob": col(ca["o_b"]),
        "w1": blocks["fc1"]["w"].q.contiguous(), "s1": s(blocks["fc1"]["w"]),
        "b1": col(blocks["fc1"]["b"]),
        "w2": blocks["fc2"]["w"].q.contiguous(),
        "fc2_s": s(blocks["fc2"]["w"]), "fc2_b": col(blocks["fc2"]["b"]),
    }

    decode_blocks.check_blk(blk)
    return {"blk": blk, **_vocab(dec["token_emb"])}


def _vocab(emb: QTensor) -> dict:
    """The vocab projection of an int8 token embedding [V, D]: the
    transposed weight [1, D, V_pad] (V padded to a multiple of 128), its
    K-side scale [1, D] (a per-tensor scale broadcast over D) and the
    logits tail's identity output scale [1, 1, V_pad]."""
    V, D = emb.q.shape
    v_pad = (-V) % _LANE
    qT = torch.nn.functional.pad(emb.q.T, (0, v_pad)).contiguous()
    k_scale = _f32(torch.broadcast_to(emb.scale.float().reshape(1, -1),
                                      (1, D)))
    return {"vocab_qT": qT[None],
            "vocab_ones": torch.ones((1, 1, qT.shape[1]),
                                     dtype=torch.float32, device=qT.device),
            "vocab_k_scale": k_scale}


def supports_q4k_decode(params: dict, config: ModelConfig) -> bool:
    """Planar Q4_K block linears (``kpack`` QTensors) and an int8 token
    embedding."""
    emb = params["decoder"]["token_emb"]
    return all(is_quantized(w) and w.kpack for w in _block_leaves(params)) \
        and is_quantized(emb) and not emb.int4


def _supports_plane(params: dict, config: ModelConfig, group: int,
                    zero: bool) -> bool:
    emb = params["decoder"]["token_emb"]
    return all(is_quantized(w) and not w.int4 and not w.kpack
               and w.group == group and (w.zero is not None) == zero
               for w in _block_leaves(params)) \
        and is_quantized(emb) and not emb.int4 \
        and config.n_text_state % _LANE == 0


def supports_q5k_decode(params: dict, config: ModelConfig) -> bool:
    """Planar Q5_K block linears (group 32, asymmetric int8 planes) and
    an int8 token embedding."""
    return _supports_plane(params, config, 32, True)


def supports_q6k_decode(params: dict, config: ModelConfig) -> bool:
    """Planar Q6_K block linears (group 16, symmetric int8 planes) and an
    int8 token embedding."""
    return _supports_plane(params, config, 16, False)


def kq_block_operands(params: dict) -> dict:
    """The stacked operands of K12-K14 (and of the scan step's K10/K11)
    for k-quant params, as the JAX ``kq_block_operands`` builds them from
    its qd: LayerNorms [L, 1, D]; per linear a triple (values, scale f32,
    zero f32 or None), the self q/k/v concatenated on the output axis to
    ``qkv``; biases [L, 1, N] f32. Checked here, once, for the kernels."""
    blocks = params["decoder"]["blocks"]
    sa, ca = blocks["self_attn"], blocks["cross_attn"]

    def tri(*qts):
        z = None if qts[0].zero is None else torch.cat(
            [_f32(t.zero) for t in qts], dim=2).contiguous()
        return (torch.cat([t.q for t in qts], dim=2).contiguous(),
                torch.cat([_f32(t.scale) for t in qts], dim=2).contiguous(),
                z)

    def col(a):
        return _f32(a[:, None, :])

    blk = {
        "ln1_w": col(blocks["ln1"]["w"]), "ln1_b": col(blocks["ln1"]["b"]),
        "ln2_w": col(blocks["ln2"]["w"]), "ln2_b": col(blocks["ln2"]["b"]),
        "ln3_w": col(blocks["ln3"]["w"]), "ln3_b": col(blocks["ln3"]["b"]),
        "qkv": tri(sa["q_w"], sa["k_w"], sa["v_w"]),
        "bqkv": col(torch.cat([sa["q_b"], sa["k_b"], sa["v_b"]], dim=1)),
        "self_o": tri(sa["o_w"]), "b_self_o": col(sa["o_b"]),
        "cross_q": tri(ca["q_w"]), "b_cross_q": col(ca["q_b"]),
        "cross_o": tri(ca["o_w"]), "b_cross_o": col(ca["o_b"]),
        "fc1": tri(blocks["fc1"]["w"]), "b_fc1": col(blocks["fc1"]["b"]),
        "fc2": tri(blocks["fc2"]["w"]), "b_fc2": col(blocks["fc2"]["b"]),
    }
    decode_blocks_kq.check_blk_kq(blk)
    return blk


def prepare_q4k_decode(params: dict, config: ModelConfig) -> Optional[dict]:
    """The qd of planar Q4_K params (the JAX ``prepare_q4k_decode``):
    ``mode`` "q4k", the kernel operands ``blk`` (:func:`kq_block_operands`)
    and the int8 vocab projection; None for other params."""
    require_unsharded(params, "the k-quant decode kernels (K10-K14)")
    if not supports_q4k_decode(params, config):
        return None
    return {"mode": "q4k", "blk": kq_block_operands(params),
            **_vocab(params["decoder"]["token_emb"])}


def prepare_kq_decode(params: dict, config: ModelConfig) -> Optional[dict]:
    """The qd of planar Q5_K or Q6_K params (the JAX
    ``prepare_kq_decode``), as :func:`prepare_q4k_decode`'s with ``mode``
    "q5k" or "q6k"; None for other params."""
    require_unsharded(params, "the k-quant decode kernels (K10-K14)")
    if supports_q5k_decode(params, config):
        mode = "q5k"
    elif supports_q6k_decode(params, config):
        mode = "q6k"
    else:
        return None
    return {"mode": mode, "blk": kq_block_operands(params),
            **_vocab(params["decoder"]["token_emb"])}


def transcode_kq_to_int8(params: dict, config: ModelConfig
                         ) -> Optional[dict]:
    """k-quant decoder linears -> a per-output-channel int8 qd for B > 1
    (the JAX ``transcode_kq_to_int8``, qdecode.py:383): each stacked
    weight is dequantized in f32 on its device and requantized, scale =
    absmax over K / 127, so batched decoding runs the int8 kernels K5-K8.
    The k-quant params and the B = 1 path are untouched; the int8 copy
    adds one byte a weight. Returns a ``prepare_qdecode`` qd, or None if
    the block linears are not k-quant or group-scaled."""
    require_unsharded(params, "the int8 transcode (K5-K8)")
    blocks = params["decoder"]["blocks"]
    if not all(is_quantized(w) and (w.kpack or w.group)
               for w in _block_leaves(params)):
        return None

    def tr(qt: QTensor) -> QTensor:
        w = dequant(qt, torch.float32)                       # [L, K, N]
        absmax = w.abs().amax(dim=1, keepdim=True)
        scale = torch.where(absmax > 0, absmax / 127.0,
                            torch.ones_like(absmax))
        q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
        return QTensor(q, scale)

    new_blocks = dict(blocks)
    new_blocks["self_attn"] = {k: (tr(v) if k.endswith("_w") else v)
                               for k, v in blocks["self_attn"].items()}
    new_blocks["cross_attn"] = dict(blocks["cross_attn"])
    for k in ("q_w", "o_w"):
        new_blocks["cross_attn"][k] = tr(blocks["cross_attn"][k])
    for k in ("fc1", "fc2"):
        new_blocks[k] = {"w": tr(blocks[k]["w"]), "b": blocks[k]["b"]}
    new_params = {**params, "decoder": {**params["decoder"],
                                        "blocks": new_blocks}}
    return prepare_qdecode(new_params, config)


def _positions(pos, B: int, T: int, device):
    """(host int, None) for one position shared by every row, or (None,
    device int64 [B]) for per-row positions. Host positions are checked
    against ``T`` rows (the cache and the position table); a tensor
    already on the device is taken unchecked (no sync)."""
    pos_t = pos if isinstance(pos, torch.Tensor) else torch.as_tensor(pos)
    if pos_t.dim() == 0:
        p = int(pos_t)
        if not 0 <= p < T:
            raise ValueError(f"pos {p} outside the self cache and position "
                             f"table ({T} rows)")
        return p, None
    return None, _slot_pos(pos_t, B, T, device).long()


def _qmv(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor, l: int,
         b: torch.Tensor) -> torch.Tensor:
    """One int8 linear through K8, bias added in x's dtype (the JAX
    ``_qmv``: ``y + b.astype(y.dtype)``)."""
    y = qmatvec.qmatvec_stacked(x.contiguous(), w, s, l)
    return y + b[l].to(y.dtype)


def _kqmv(x: torch.Tensor, tri, l: int, b: torch.Tensor) -> torch.Tensor:
    """One k-quant linear through K10 (Q4_K) or K11 (Q5_K, Q6_K), bias
    added in x's dtype (the JAX ``_qmv``'s k-quant branches)."""
    if decode_blocks_kq.weight_fmt(tri) == "q4k":
        y = q4k.q4k_matvec_stacked(x.contiguous(), *tri, l)
    else:
        y = kquants.kq_matvec_stacked(x.contiguous(), *tri, l)
    return y + b[l].to(y.dtype)


def decode_step_q(params: dict, qd: dict, token: torch.Tensor, pos,
                  cache: KVCache, config: ModelConfig,
                  compute_dtype: torch.dtype = torch.bfloat16):
    """One decode token of B sequences, kernel edition of the scan step
    (the JAX ``decode_step_q``): token [B] int32 at ``pos`` (a host int
    for every row, or per-row positions [B], a host tensor checked here
    or a device tensor taken as is) -> (logits [B, n_vocab] f32, cache).

    Per layer: LN1 -> QKV through K8 (+ bias) -> the new k/v rows written
    into the dense cache at each row's position -> attention over rows
    <= pos (plain torch) -> o-proj through K8; the same for the cross
    attention over every encoder row; LN3 -> K9 -> fc2 scale and bias in
    f32. Over a k-quant qd every linear runs K10 or K11 instead, and the
    FFN is fc1 (+ bias) -> GELU in x's dtype -> fc2 (+ bias), as the JAX
    step. Then the final LayerNorm, the vocab K-side scale folded into
    the activation in f32, and the logits through K8. The cache rows are
    written in place (the JAX step returns a new cache).
    """
    kq_mode = str(qd.get("mode", "int8")) in KQ_MODES
    B = token.shape[0]
    dec = params["decoder"]
    T = min(cache.self_k.shape[2], dec["pos_emb"].shape[0])
    device = token.device
    p, pos_d = _positions(pos, B, T, device)
    x = embed(params, token[:, None], p if pos_d is None else pos_d,
              compute_dtype)[:, 0]                               # [B, D]
    rows = torch.arange(cache.self_k.shape[2], device=device)
    if pos_d is None:
        valid = (rows <= p)[None, None, None, :]
        at = (slice(None), p)
    else:
        valid = (rows[None, :] <= pos_d[:, None])[:, None, None, :]
        at = (torch.arange(B, device=device), pos_d)
    blk = qd["blk"]
    n_heads = config.n_text_head
    D = config.n_text_state
    if kq_mode:
        lins = {k: functools.partial(_kqmv, tri=blk[k], b=blk[b])
                for k, b in (("qkv", "bqkv"), ("self_o", "b_self_o"),
                             ("cross_q", "b_cross_q"),
                             ("cross_o", "b_cross_o"), ("fc1", "b_fc1"),
                             ("fc2", "b_fc2"))}
    else:
        lins = {k: functools.partial(_qmv, w=blk[w], s=blk[s], b=blk[b])
                for k, w, s, b in (
                    ("qkv", "wqkv", "sqkv", "bqkv"),
                    ("self_o", "self_wo", "self_wos", "self_wob"),
                    ("cross_q", "wcq", "scq", "bcq"),
                    ("cross_o", "cross_wo", "cross_wos", "cross_wob"))}
    for l in range(config.n_text_layer):
        h = layer_norm(x, blk["ln1_w"][l], blk["ln1_b"][l])
        qkv = lins["qkv"](h, l=l)
        k_c, v_c = cache.self_k[l], cache.self_v[l]
        k_c[at] = qkv[:, D:2 * D].to(k_c.dtype)
        v_c[at] = qkv[:, 2 * D:].to(v_c.dtype)
        attn = mha(qkv[:, None, :D], k_c, v_c, n_heads, mask=valid)
        x = x + lins["self_o"](attn[:, 0], l=l)

        h = layer_norm(x, blk["ln2_w"][l], blk["ln2_b"][l])
        q = lins["cross_q"](h, l=l)
        attn = mha(q[:, None], cache.cross_k[l], cache.cross_v[l], n_heads)
        x = x + lins["cross_o"](attn[:, 0], l=l)

        h = layer_norm(x, blk["ln3_w"][l], blk["ln3_b"][l])
        if kq_mode:
            x = x + lins["fc2"](gelu(lins["fc1"](h, l=l)), l=l)
            continue
        y = qmatvec.ffn_fused(h, blk["w1"], blk["s1"], blk["b1"], blk["w2"],
                              l)
        x = x + (y.float() * blk["fc2_s"][l] + blk["fc2_b"][l]).to(x.dtype)
    x = layer_norm(x, dec["ln_post"]["w"], dec["ln_post"]["b"])
    xs = (x.float() * qd["vocab_k_scale"]).to(x.dtype).contiguous()
    logits = qmatvec.qmatvec_stacked(xs, qd["vocab_qT"], qd["vocab_ones"],
                                     0, out_dtype=torch.float32)
    return logits[:, : config.n_vocab], cache


class QKVCache(NamedTuple):
    """Decode caches for the fused step: ``*_q`` [L, B, T, D] (int8 with
    f32 row scales ``*_s`` [L, B, T, 1], or compute dtype / float8_e4m3fn
    with ``*_s`` None). T is padded to the block granularity."""

    self_kq: torch.Tensor
    self_ks: Optional[torch.Tensor]
    self_vq: torch.Tensor
    self_vs: Optional[torch.Tensor]
    cross_kq: torch.Tensor
    cross_ks: Optional[torch.Tensor]
    cross_vq: torch.Tensor
    cross_vs: Optional[torch.Tensor]


def _pad_t(a: torch.Tensor, block: int) -> torch.Tensor:
    """Pad [L, B, T, D] with zero rows up to a multiple of ``block``."""
    pad = (-a.shape[2]) % block
    if pad:
        a = torch.nn.functional.pad(a, (0, 0, 0, pad))
    return a.contiguous()


QF_MODES = ("bf16", "int8", "cross8", "fp8", "crossf8")


def quantize_cache(cache: KVCache, mode: str) -> QKVCache:
    """KVCache -> QKVCache: pad T to the block granularity and store rows
    per ``mode``: "bf16" keeps compute-dtype rows; "int8" quantizes every
    row with an f32 scale (``ops/decode_attention.quantize_rows``);
    "cross8" quantizes the cross cache only; "fp8" casts all rows to
    float8_e4m3fn (no scales); "crossf8" casts the cross cache only.
    The result's layout is checked here, once, for the kernels."""
    if mode not in QF_MODES:
        raise ValueError(f"cache mode must be one of {QF_MODES}, got {mode!r}")
    sk = _pad_t(cache.self_k, SELF_BLOCK_T)
    sv = _pad_t(cache.self_v, SELF_BLOCK_T)
    ck = _pad_t(cache.cross_k, CROSS_BLOCK_T)
    cv = _pad_t(cache.cross_v, CROSS_BLOCK_T)
    f8 = torch.float8_e4m3fn
    if mode == "fp8":
        out = QKVCache(sk.to(f8), None, sv.to(f8), None,
                       ck.to(f8), None, cv.to(f8), None)
    elif mode == "cross8":
        ckq, cks = quantize_rows(ck)
        cvq, cvs = quantize_rows(cv)
        out = QKVCache(sk, None, sv, None, ckq, cks, cvq, cvs)
    elif mode == "crossf8":
        out = QKVCache(sk, None, sv, None, ck.to(f8), None, cv.to(f8), None)
    elif mode == "bf16":
        out = QKVCache(sk, None, sv, None, ck, None, cv, None)
    else:
        skq, sks = quantize_rows(sk)
        svq, svs = quantize_rows(sv)
        ckq, cks = quantize_rows(ck)
        cvq, cvs = quantize_rows(cv)
        out = QKVCache(skq, sks, svq, svs, ckq, cks, cvq, cvs)
    decode_blocks.check_cache(*out[:4])
    decode_blocks.check_cache(*out[4:])
    return out


def _slot_pos(pos: torch.Tensor, B: int, T: int, device) -> torch.Tensor:
    """Per-slot positions [B] as a device int32 tensor. Host positions are
    checked against the cache and the position table (``T`` rows: the
    fewer of the two); a tensor already on the device is taken as is,
    unchecked (no sync)."""
    if tuple(pos.shape) != (B,):
        raise ValueError(f"pos has shape {tuple(pos.shape)}, want ({B},)")
    if pos.device.type == "cpu" and (bool((pos < 0).any())
                                     or bool((pos >= T).any())):
        raise ValueError(f"positions {pos.tolist()} outside the self cache "
                         f"and position table ({T} rows)")
    return pos.to(device=device, dtype=torch.int32).contiguous()


def decode_step_qf(params: dict, qd: dict, token: torch.Tensor, pos,
                   cache: QKVCache, config: ModelConfig,
                   compute_dtype: torch.dtype = torch.bfloat16,
                   enc_len: Optional[int] = None,
                   greedy_bias: Optional[torch.Tensor] = None):
    """One decode token for B sequences through the per-block kernels.

    token [B] int32 (the caller validates the ids). ``pos`` is a host int
    (an aligned batch) or per-slot positions [B] (continuous batching: a
    host tensor / array, checked here, or a device int32 tensor, taken as
    is). B = 1 runs K1-K3 (a [1] pos is read on the host), B > 1 the
    batched K5-K7 with the positions on the device; a k-quant qd runs
    K12-K14 and takes B = 1 only (``qf_supported``). ``enc_len`` is the
    number of valid rows of the padded cross cache (default
    ``config.n_audio_ctx``).

    ``greedy_bias`` [1, V_pad] f32 (the suppressions) selects the fused
    greedy head K4: returns ``((token [B] i32, max_logit [B] f32,
    logsumexp [B] f32), cache)``. Without it the logits tail runs K8 and
    returns ``(logits [B, n_vocab] f32, cache)``. Either way the cache
    rows at each slot's position are written in place.
    """
    B = token.shape[0]
    kq_mode = str(qd.get("mode", "int8")) in KQ_MODES
    if kq_mode and B != 1:
        raise NotImplementedError(
            "k-quant fused blocks are B=1 only; guard callers with "
            "qf_supported() (B>1 k-quants decode over "
            "transcode_kq_to_int8)")
    if enc_len is None:
        enc_len = config.n_audio_ctx
    dec = params["decoder"]
    T = min(cache.self_kq.shape[2], dec["pos_emb"].shape[0])
    blk = qd["blk"]
    n_heads = config.n_text_head
    L = config.n_text_layer
    device = token.device
    pos_t = pos if isinstance(pos, torch.Tensor) else torch.as_tensor(pos)
    multi_pos = pos_t.dim() == 1 and B > 1
    if multi_pos:
        pos_d = _slot_pos(pos_t, B, T, device)
        x = embed(params, token[:, None], pos_d, compute_dtype)[:, 0]
        rows_at = (torch.arange(B, device=device), pos_d.long())
    else:                             # one position for every row
        pos = int(pos_t.reshape(-1)[0])
        if not 0 <= pos < T:
            raise ValueError(f"pos {pos} outside the self cache and position "
                             f"table ({T} rows)")
        x = embed(params, token[:, None], pos, compute_dtype)[:, 0]  # [B, D]
        rows_at = (slice(None), pos)
        pos_d = pos if B == 1 else torch.full((B,), pos, dtype=torch.int32,
                                              device=device)
    if kq_mode:
        sb, cb, fb = (decode_blocks_kq.self_block_kq,
                      decode_blocks_kq.cross_block_kq,
                      decode_blocks_kq.ffn_block_kq)
    elif B == 1:
        sb, cb, fb = (decode_blocks.self_block, decode_blocks.cross_block,
                      decode_blocks.ffn_block)
    else:
        sb, cb, fb = (decode_blocks.self_block_batched,
                      decode_blocks.cross_block_batched,
                      decode_blocks.ffn_block_batched)
    krows, vrows, kscs, vscs = [], [], [], []
    for l in range(L):
        x, k_row, k_sc, v_row, v_sc = sb(
            x, blk, cache.self_kq, cache.self_ks, cache.self_vq,
            cache.self_vs, pos_d, l, n_heads)
        krows.append(k_row)
        vrows.append(v_row)
        kscs.append(k_sc)
        vscs.append(v_sc)
        x = cb(x, blk, cache.cross_kq, cache.cross_ks, cache.cross_vq,
               cache.cross_vs, enc_len, l, n_heads)
        x = fb(x, blk, l)
    # deferred row writes: one scatter per cache after the layer loop
    cache.self_kq[(slice(None), *rows_at)] = torch.stack(krows)
    cache.self_vq[(slice(None), *rows_at)] = torch.stack(vrows)
    if cache.self_ks is not None:
        cache.self_ks[(slice(None), *rows_at, 0)] = torch.stack(kscs)
        cache.self_vs[(slice(None), *rows_at, 0)] = torch.stack(vscs)

    x = layer_norm(x, dec["ln_post"]["w"], dec["ln_post"]["b"])
    xs = (x.float() * qd["vocab_k_scale"]).to(x.dtype).contiguous()
    if greedy_bias is not None:
        return qmatvec.qmatvec_greedy_head(xs, qd["vocab_qT"], greedy_bias,
                                           config.n_vocab), cache
    logits = qmatvec.qmatvec_stacked(xs, qd["vocab_qT"], qd["vocab_ones"],
                                     0, out_dtype=torch.float32)
    return logits[:, : config.n_vocab], cache
