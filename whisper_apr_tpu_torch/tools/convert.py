"""HF Whisper checkpoint -> .apr converter: port of
``whisper_apr_tpu/tools/convert.py``, byte-for-byte the same files.

(reference: tools/convert.rs — safetensors + vocab.json + merges.txt +
added_tokens.json + mel_filters download/parse at :160-310, GPT-2 byte
decode :481, tensor-name mapping via src/cli/model_loader.rs:237.)

Offline converter: takes a LOCAL HF model directory (no downloads — the
reference auto-downloads via hf-hub, which needs network; this framework's
loader accepts any directory produced by ``transformers`` save_pretrained or
``huggingface-cli download``). ``model.safetensors`` is read here, without
the ``safetensors`` package: an 8-byte little-endian header length, a JSON
header (dtype, shape, data offsets per tensor), then the raw buffers.
"""

from __future__ import annotations

import json
import math
import os
import struct
from typing import Dict

import numpy as np
import torch

from ..audio.mel import mel_filterbank
from ..config import ModelConfig
from ..errors import FormatError
from ..format import QUANT_F32, AprWriter, MelFilterbankData
from ..model.params import hf_state_dict_to_apr_tensors
from ..tokenizer import Vocabulary

# safetensors dtype names (little-endian buffers)
_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def _load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of a .safetensors file as f32 numpy (f16 / bf16 widen
    exactly, mirroring model_loader.rs:172-192)."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    if len(data) < 8:
        raise FormatError(f"{path}: truncated safetensors header")
    (n,) = struct.unpack_from("<Q", data, 0)
    if 8 + n > len(data):
        raise FormatError(f"{path}: header of {n} bytes past the end")
    try:
        header = json.loads(bytes(data[8: 8 + n]))
    except ValueError as e:
        raise FormatError(f"{path}: bad safetensors header: {e}") from None
    base = 8 + n
    out: Dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(info.get("dtype"))
        if dtype is None:
            raise FormatError(f"{path}: {name}: unsupported dtype "
                              f"{info.get('dtype')!r}")
        shape = [int(d) for d in info["shape"]]
        start, end = (int(o) for o in info["data_offsets"])
        count = math.prod(shape)
        itemsize = torch.empty((), dtype=dtype).element_size()
        if not 0 <= start <= end <= len(data) - base \
                or end - start != count * itemsize:
            raise FormatError(f"{path}: {name}: data offsets {start}..{end} "
                              f"do not hold {shape} {info['dtype']}")
        t = (torch.frombuffer(data, dtype=dtype, count=count,
                              offset=base + start) if count
             else torch.empty(0, dtype=dtype))
        out[name] = t.reshape(shape).to(torch.float32).numpy()
    return out


def _config_from_hf_json(cfg_json: dict) -> ModelConfig:
    """Map HF config.json fields onto ModelConfig."""
    d_model = cfg_json["d_model"]
    name_by_dims = {
        (384, 4): "tiny", (512, 6): "base", (768, 12): "small",
        (1024, 24): "medium", (1280, 32): "large",
    }
    model_type = name_by_dims.get(
        (d_model, cfg_json["encoder_layers"]), "tiny")
    if model_type == "large" and cfg_json.get("num_mel_bins", 80) == 128:
        model_type = ("large-v3-turbo"
                      if cfg_json.get("decoder_layers", 32) == 4
                      else "large-v3")
    return ModelConfig(
        model_type=model_type,
        n_vocab=cfg_json["vocab_size"],
        n_audio_ctx=cfg_json["max_source_positions"],
        n_audio_state=d_model,
        n_audio_head=cfg_json["encoder_attention_heads"],
        n_audio_layer=cfg_json["encoder_layers"],
        n_text_ctx=cfg_json["max_target_positions"],
        n_text_state=d_model,
        n_text_head=cfg_json["decoder_attention_heads"],
        n_text_layer=cfg_json["decoder_layers"],
        n_mels=cfg_json.get("num_mel_bins", 80),
    )


def convert_hf_to_apr(input_dir: str, output_path: str,
                      quantization: int = QUANT_F32,
                      container_version: int = 1) -> str:
    """Convert a local HF Whisper checkpoint directory to .apr.

    Expects: config.json, model.safetensors (or pytorch_model.bin),
    vocab.json + merges.txt (+ added_tokens.json). Embeds the exact slaney
    filterbank (computed; bit-matches OpenAI's mel_filters.npz).
    ``container_version=2`` writes the JSON-metadata APR v2 container
    (reference: src/format/mod.rs:46-50 aprender canonical format).
    """
    cfg_path = os.path.join(input_dir, "config.json")
    if not os.path.exists(cfg_path):
        raise FormatError(f"missing config.json in {input_dir}")
    with open(cfg_path) as f:
        config = _config_from_hf_json(json.load(f))

    # tensors
    st_path = os.path.join(input_dir, "model.safetensors")
    if os.path.exists(st_path):
        sd = _load_safetensors(st_path)
    else:
        pt_path = os.path.join(input_dir, "pytorch_model.bin")
        if not os.path.exists(pt_path):
            raise FormatError("no model.safetensors or pytorch_model.bin found")
        sd = {k: v.to(torch.float32).numpy()
              for k, v in torch.load(pt_path, map_location="cpu",
                                     weights_only=True).items()}
    tensors = hf_state_dict_to_apr_tensors(sd)

    if container_version == 2:
        from ..format.v2 import AprWriterV2
        writer = AprWriterV2.from_config(config, quantization=quantization)
    else:
        writer = AprWriter.from_config(config, quantization=quantization)
    for name, arr in sorted(tensors.items()):
        writer.add_tensor(name, arr)

    # vocabulary (reference: tools/convert.rs:375 parse_vocabulary)
    vocab_path = os.path.join(input_dir, "vocab.json")
    merges_path = os.path.join(input_dir, "merges.txt")
    if os.path.exists(vocab_path) and os.path.exists(merges_path):
        with open(vocab_path) as f:
            vocab_json = json.load(f)
        added = None
        added_path = os.path.join(input_dir, "added_tokens.json")
        if os.path.exists(added_path):
            with open(added_path) as f:
                added = json.load(f)
        with open(merges_path) as f:
            merges = f.read().splitlines()
        if merges and merges[0].startswith("#"):
            merges = merges[1:]
        vocab = Vocabulary.from_hf_files(vocab_json, merges, added)
        writer.set_vocabulary(vocab.to_bytes())

    # filterbank: exact slaney (bit-matches OpenAI's shipped npz)
    writer.set_mel_filterbank(MelFilterbankData(
        config.n_mels, 201, mel_filterbank(config.n_mels)))

    writer.write_file(output_path)
    return output_path
