"""Multi-slot decode ticks: port of ``decode_step_multi`` and
``decode_steps_multi`` in ``whisper_apr_tpu/model/kv_variants.py``.

``decode_step_multi`` is the plain-torch step with a PER-SLOT position
vector (each serving slot at its own depth) over a dense ``KVCache``: the
step of engines without int8 weights. ``decode_steps_multi`` advances
every slot of a serving batch by ``n_steps`` greedy tokens; the cache
type and ``qd`` pick its step, as in the JAX tick: a ``QKVCache`` runs
``qdecode.decode_step_qf`` with per-slot positions and the logits tail
(K5-K7 per layer, then K8); a dense cache with ``qd`` runs the scan step
``qdecode.decode_step_q`` (K8 and K9); a dense cache without ``qd``
``decode_step_multi``. The sliding-window and paged caches come with the
port's slice 5.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..ops.basic import layer_norm
from .decoder import KVCache, block_step, embed, project_to_vocab
from .params import layer_slice
from .qdecode import QKVCache, decode_step_q, decode_step_qf


def decode_step_multi(params: dict, token: torch.Tensor, pos: torch.Tensor,
                      cache: KVCache, config: ModelConfig,
                      compute_dtype: torch.dtype = torch.float32
                      ) -> Tuple[torch.Tensor, KVCache]:
    """One plain-torch decode step with PER-SLOT positions: token [B]
    int32, pos [B] (each slot's current row) -> (logits [B, V] f32,
    cache), slot b's self rows at pos[b] written in place."""
    B = token.shape[0]
    T = cache.self_k.shape[2]
    pos_d = pos.to(device=token.device, dtype=torch.long).reshape(B)
    if pos.device.type == "cpu" and (bool((pos < 0).any())
                                     or bool((pos >= T).any())):
        raise ValueError(f"positions {pos.tolist()} outside the self cache "
                         f"({T} rows)")
    x = embed(params, token[:, None], pos_d, compute_dtype)     # [B, 1, D]
    valid = (torch.arange(T, device=token.device)[None, :]
             <= pos_d[:, None])[:, None, None, :]
    at = (torch.arange(B, device=token.device), pos_d)
    blocks = params["decoder"]["blocks"]
    for l in range(config.n_text_layer):
        x = block_step(x, layer_slice(blocks, l), cache.self_k[l],
                       cache.self_v[l], cache.cross_k[l], cache.cross_v[l],
                       at, valid, config.n_text_head)
    dec = params["decoder"]
    x = layer_norm(x, dec["ln_post"]["w"], dec["ln_post"]["b"])
    return project_to_vocab(params, x[:, 0, :]), cache


def decode_steps_multi(params: dict, token: torch.Tensor, pos,
                       suppress_bias: torch.Tensor, cache, config: ModelConfig,
                       n_steps: int,
                       compute_dtype: torch.dtype = torch.float32,
                       qd: Optional[dict] = None):
    """Advance every slot by ``n_steps`` greedy tokens.

    token [B] int32 on the device; pos [B] the slots' current positions
    (host ints); suppress_bias [V] f32. Positions are clamped to the last
    cache row, as the JAX tick does. Returns (tokens [B, n_steps] int32,
    cache) with the cache rows written in place. Slots that hit EOT keep
    stepping; the caller cuts each slot's stream at its own EOT.
    """
    if isinstance(cache, QKVCache):
        if qd is None:
            raise ValueError("a QKVCache tick needs the qd it was built for")
        T_max = cache.self_kq.shape[2]

        def step(tok, p):
            return decode_step_qf(params, qd, tok, p, cache, config,
                                  compute_dtype=compute_dtype)
    else:
        T_max = cache.self_k.shape[2]

        def step(tok, p):
            if qd is None:
                return decode_step_multi(params, tok, p, cache, config,
                                         compute_dtype=compute_dtype)
            return decode_step_q(params, qd, tok, p, cache, config,
                                 compute_dtype=compute_dtype)
    p = np.asarray(pos, dtype=np.int64).reshape(-1)
    tok, toks = token, []
    for _ in range(n_steps):
        logits, _ = step(tok, torch.from_numpy(np.minimum(p, T_max - 1)))
        tok = torch.argmax(logits + suppress_bias[None, :], dim=-1).to(
            torch.int32)
        toks.append(tok)
        p = p + 1
    return torch.stack(toks, dim=1), cache
