# Copied from whisper_apr_tpu/format/v2.py (host-side numpy, no JAX), plus the v1 reader surface the port's loader and validator read (find_tensor; a descriptor's dims, n_dims, n_elements); keep the two in step.
"""APR v2 container: JSON metadata + tensor index + CRC32.

The reference re-exports aprender's canonical APR v2
(src/format/mod.rs:46-50: ``AprMetadata``, ``AprReaderV2``, ``AprWriterV2``,
``AprTensorDescriptor`` — "JSON metadata + tensor index + CRC", SURVEY §2.5).
The aprender crate itself is an external dependency whose byte layout is not
vendored in the reference repo, so this implements the same architecture:

    "APR2" magic (4B) | u32 metadata_len | UTF-8 JSON metadata
    | padding to 64B alignment | tensor data blob | CRC32 (4B, trailing)

The JSON metadata carries the model hyperparameters, arbitrary user entries
(e.g. the mel filterbank, per the reference's WAPR-MEL-001 spec which reads
``metadata.get("mel_filterbank")``), and the tensor index: name, dtype,
shape, and offset/size into the data blob. Quantized tensors store their
scales as sibling ``<name>.scale`` tensors instead of v1's positional scale
table — self-describing, order-independent.

``AprReaderV2`` exposes the same surface as the v1 ``AprReader`` (header /
tensors / load_tensor / read_vocabulary_bytes / read_mel_filterbank /
verify_crc), so the engine loads either version through one code path.
"""

from __future__ import annotations

import dataclasses
import json
import struct
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from ..config import ModelConfig
from ..errors import FormatError
from .checksum import crc32
from .container import (QUANT_F32, QUANT_INT8, AprHeader, MelFilterbankData,
                        _QUANT_NAMES)

MAGIC_V2 = b"APR2"
_ALIGN = 64

_DTYPES = {"f32": np.float32, "f16": np.float16, "i8": np.int8,
           "i32": np.int32, "u8": np.uint8}
_DTYPE_NAMES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclasses.dataclass
class AprTensorDescriptor:
    """(reference re-export analog: aprender AprTensorDescriptor)"""

    name: str
    dtype: str
    shape: Tuple[int, ...]
    offset: int
    size: int

    # the v1 TensorDescriptor's view of the shape, which the validator
    # reads (``validation.py`` checks 4 and 13)
    @property
    def dims(self) -> Tuple[int, ...]:
        return self.shape

    @property
    def n_dims(self) -> int:
        return len(self.shape)

    @property
    def n_elements(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    def to_json(self) -> dict:
        return {"name": self.name, "dtype": self.dtype,
                "shape": list(self.shape), "offset": self.offset,
                "size": self.size}

    @staticmethod
    def from_json(d: dict) -> "AprTensorDescriptor":
        return AprTensorDescriptor(
            name=str(d["name"]), dtype=str(d["dtype"]),
            shape=tuple(int(x) for x in d["shape"]),
            offset=int(d["offset"]), size=int(d["size"]))


class AprMetadata(dict):
    """JSON metadata map (reference re-export analog: aprender AprMetadata).

    A plain dict with typed hyperparameter helpers.
    """

    @staticmethod
    def from_config(config: ModelConfig, quantization: int = QUANT_F32
                    ) -> "AprMetadata":
        return AprMetadata({
            "format": "apr", "format_version": 2,
            "model_type": config.model_type,
            "quantization": _QUANT_NAMES[quantization],
            "hyperparameters": {
                "n_vocab": config.n_vocab,
                "n_audio_ctx": config.n_audio_ctx,
                "n_audio_state": config.n_audio_state,
                "n_audio_head": config.n_audio_head,
                "n_audio_layer": config.n_audio_layer,
                "n_text_ctx": config.n_text_ctx,
                "n_text_state": config.n_text_state,
                "n_text_head": config.n_text_head,
                "n_text_layer": config.n_text_layer,
                "n_mels": config.n_mels,
            },
        })

    def to_model_config(self) -> ModelConfig:
        h = self["hyperparameters"]
        return ModelConfig(model_type=self.get("model_type", "tiny"),
                           **{k: int(v) for k, v in h.items()})

    @property
    def quantization_code(self) -> int:
        name = self.get("quantization", "f32")
        for code, n in _QUANT_NAMES.items():
            if n == name:
                return code
        return QUANT_F32


class AprWriterV2:
    """(reference re-export analog: aprender AprWriterV2)"""

    def __init__(self, metadata: AprMetadata) -> None:
        self.metadata = metadata
        self._tensors: List[Tuple[str, np.ndarray]] = []

    @staticmethod
    def from_config(config: ModelConfig,
                    quantization: int = QUANT_F32) -> "AprWriterV2":
        return AprWriterV2(AprMetadata.from_config(config, quantization))

    def add_tensor(self, name: str, values: np.ndarray) -> None:
        arr = np.asarray(values)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        if np.dtype(arr.dtype) not in _DTYPE_NAMES:
            raise FormatError(f"unsupported v2 tensor dtype {arr.dtype}")
        if self.metadata.quantization_code == QUANT_INT8 \
                and arr.dtype == np.float32 and not name.endswith(".scale"):
            # v1-compatible per-tensor absmax int8 (mod.rs:849 semantics)
            absmax = float(np.max(np.abs(arr))) if arr.size else 0.0
            scale = absmax / 127.0 if absmax > 0 else 1.0
            q = np.clip(np.round(arr / scale), -127, 127).astype(np.int8)
            self._tensors.append((name, q))
            self._tensors.append((f"{name}.scale",
                                  np.asarray([scale], np.float32)))
            return
        self._tensors.append((name, arr))

    def set_vocabulary(self, vocab_bytes: bytes) -> None:
        self._tensors.append(
            ("__vocabulary__", np.frombuffer(vocab_bytes, dtype=np.uint8)))
        self.metadata["has_vocabulary"] = True

    def set_mel_filterbank(self, fb: MelFilterbankData) -> None:
        # metadata-embedded, matching the reference's WAPR-MEL-001 access
        # pattern (metadata.get("mel_filterbank")) — the filterbank is small
        self.metadata["mel_filterbank_shape"] = [fb.n_mels, fb.n_freqs]
        self._tensors.append(
            ("__mel_filterbank__", np.asarray(fb.data, np.float32)))

    def to_bytes(self) -> bytes:
        index: List[dict] = []
        blob = bytearray()
        for name, arr in self._tensors:
            pad = (-len(blob)) % _ALIGN
            blob += b"\x00" * pad
            data = np.ascontiguousarray(arr).tobytes()
            index.append(AprTensorDescriptor(
                name=name, dtype=_DTYPE_NAMES[np.dtype(arr.dtype)],
                shape=tuple(arr.shape), offset=len(blob),
                size=len(data)).to_json())
            blob += data
        meta = dict(self.metadata)
        meta["tensors"] = index
        meta_bytes = json.dumps(meta, separators=(",", ":"),
                                sort_keys=True).encode("utf-8")
        out = bytearray()
        out += MAGIC_V2
        out += struct.pack("<I", len(meta_bytes))
        out += meta_bytes
        out += b"\x00" * ((-len(out)) % _ALIGN)
        out += blob
        out += struct.pack("<I", crc32(bytes(out)))
        return bytes(out)

    def write_file(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.to_bytes())


class AprReaderV2:
    """(reference re-export analog: aprender AprReaderV2) — v1-compatible
    reading surface so the engine loads either container version."""

    def __init__(self, data: Union[bytes, memoryview]) -> None:
        self.data = bytes(data) if not isinstance(data, bytes) else data
        if len(self.data) < 12 or self.data[:4] != MAGIC_V2:
            raise FormatError("not an APR2 container")
        (meta_len,) = struct.unpack_from("<I", self.data, 4)
        meta_end = 8 + meta_len
        if meta_end + 4 > len(self.data):
            raise FormatError("truncated APR2 metadata")
        try:
            meta = json.loads(self.data[8:meta_end].decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise FormatError(f"bad APR2 metadata: {e}") from None
        self.metadata = AprMetadata(meta)
        self._index = [AprTensorDescriptor.from_json(d)
                       for d in meta.get("tensors", [])]
        self._by_name = {d.name: d for d in self._index}
        self._data_start = meta_end + ((-meta_end) % _ALIGN)
        self.header = AprHeader.from_config(
            self.metadata.to_model_config(),
            quantization=self.metadata.quantization_code)
        self.header.n_tensors = len(
            [d for d in self._index if not d.name.startswith("__")
             and not d.name.endswith(".scale")])
        self.header.has_vocab = "__vocabulary__" in self._by_name
        self.header.has_filterbank = "__mel_filterbank__" in self._by_name

    @staticmethod
    def from_file(path: str) -> "AprReaderV2":
        return AprReaderV2(open(path, "rb").read())

    @property
    def tensors(self) -> List[AprTensorDescriptor]:
        return [d for d in self._index if not d.name.startswith("__")
                and not d.name.endswith(".scale")]

    def find_tensor(self, name: str) -> Optional[AprTensorDescriptor]:
        """(v1 ``AprReader.find_tensor``, which the port's loader reads)"""
        return self._by_name.get(name)

    def _raw(self, desc: AprTensorDescriptor) -> np.ndarray:
        start = self._data_start + desc.offset
        end = start + desc.size
        if end > len(self.data) - 4:
            raise FormatError(f"tensor {desc.name} out of bounds")
        arr = np.frombuffer(self.data, dtype=_DTYPES[desc.dtype],
                            count=int(np.prod(desc.shape, dtype=np.int64))
                            if desc.shape else desc.size, offset=start)
        return arr.reshape(desc.shape)

    def load_tensor(self, name: str) -> np.ndarray:
        """Auto-dequantizes int8 tensors via their ``.scale`` sibling."""
        desc = self._by_name.get(name)
        if desc is None:
            raise FormatError(f"unknown tensor: {name}")
        arr = self._raw(desc)
        if desc.dtype == "i8":
            sdesc = self._by_name.get(f"{name}.scale")
            if sdesc is not None:
                scale = self._raw(sdesc)
                return arr.astype(np.float32) * scale.reshape(-1)[0]
        return arr

    def load_tensor_quantized(self, name: str
                              ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        desc = self._by_name.get(name)
        if desc is None:
            raise FormatError(f"unknown tensor: {name}")
        arr = self._raw(desc)
        sdesc = self._by_name.get(f"{name}.scale")
        return arr, (self._raw(sdesc) if sdesc is not None else None)

    # v1-reader compat for the native-int8 load path (model/params.py)
    def load_raw(self, name: str) -> np.ndarray:
        desc = self._by_name.get(name)
        if desc is None:
            raise FormatError(f"unknown tensor: {name}")
        return self._raw(desc)

    def scale_for(self, name: str) -> float:
        sdesc = self._by_name.get(f"{name}.scale")
        if sdesc is None:
            raise FormatError(f"tensor {name} has no scale")
        return float(self._raw(sdesc).reshape(-1)[0])

    def read_vocabulary_bytes(self) -> Optional[bytes]:
        desc = self._by_name.get("__vocabulary__")
        return None if desc is None else self._raw(desc).tobytes()

    def read_mel_filterbank(self) -> Optional[MelFilterbankData]:
        desc = self._by_name.get("__mel_filterbank__")
        if desc is None:
            return None
        data = self._raw(desc)
        return MelFilterbankData(data.shape[0], data.shape[1], data)

    def verify_crc(self) -> bool:
        (stored,) = struct.unpack_from("<I", self.data, len(self.data) - 4)
        return crc32(self.data[:-4]) == stored


def is_v2(data: bytes) -> bool:
    return len(data) >= 4 and data[:4] == MAGIC_V2
